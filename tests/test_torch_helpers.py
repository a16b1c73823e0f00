"""The port's public helpers against the JAX package's, on seeded numpy
inputs: the whole-record operations of core/struct.py (exactly equal, the
scatters leaving their buffer unchanged), the math helpers of core/math.py
(rtol 1e-6; transform_normal within 1e-5 of each normal's length, since a
component that cancels to near 0 is off in its own last bits in JAX's
result too), core/rng.py's seed_from_int (bit for bit) and
render/bsdf/dispatch.py's base_color (exactly equal)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core import math as jm
from mitsuba3_experiments_tpu.core import rng as jrng
from mitsuba3_experiments_tpu.core import struct as js
from mitsuba3_experiments_tpu.render.bsdf import dispatch as jdispatch
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core import math as tm
from mitsuba3_experiments_tpu_torch.core import rng as trng
from mitsuba3_experiments_tpu_torch.core import struct as ts
from mitsuba3_experiments_tpu_torch.render.bsdf import base_color
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict

N = 64


@js.jstruct
class JInner:
    w: jax.Array


@js.jstruct
class JRec:
    a: jax.Array
    b: jax.Array
    inner: JInner


@dataclasses.dataclass(frozen=True)
class Inner:
    w: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Rec:
    a: torch.Tensor
    b: torch.Tensor
    inner: Inner


def _records(seed, n=N):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.integers(-100, 100, n).astype(np.int32)
    w = rng.normal(size=(n, 2, 2)).astype(np.float32)
    return (JRec(jnp.asarray(a), jnp.asarray(b), JInner(jnp.asarray(w))),
            Rec(torch.as_tensor(a), torch.as_tensor(b), Inner(torch.as_tensor(w))))


def _leaves(rec):
    return [rec.a, rec.b, rec.inner.w]


def _equal(trec, jrec):
    for t, j in zip(_leaves(trec), _leaves(jrec)):
        j = np.asarray(j)
        assert str(t.dtype) == f"torch.{j.dtype}" and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), j)


def _copy(trec):
    return ts.tmap(torch.clone, trec)


@pytest.mark.parametrize("op", ["set", "add"])
def test_scatter_is_functional_and_equals_jax(op):
    jbuf, tbuf = _records(1)
    jval, tval = _records(2, n=24)
    rng = np.random.default_rng(3)
    # set: distinct rows (the order of a repeated write is unspecified);
    # add: repeated rows accumulate
    idx = (rng.permutation(N)[:24] if op == "set" else rng.integers(0, N, 24)).astype(np.int32)
    before = _copy(tbuf)
    jf, tf = (js.tscatter_set, ts.tscatter_set) if op == "set" else (js.tscatter_add,
                                                                      ts.tscatter_add)
    _equal(tf(tbuf, tval, torch.as_tensor(idx)), jf(jbuf, jval, jnp.asarray(idx)))
    _equal(tbuf, jbuf)
    for x, y in zip(_leaves(tbuf), _leaves(before)):
        assert torch.equal(x, y)


def test_tile_slice_concat_replace_equal_jax():
    jrec, trec = _records(4)
    jrec2, trec2 = _records(5, n=10)
    _equal(ts.ttile(trec, 3), js.ttile(jrec, 3))
    _equal(ts.tslice(trec, slice(5, 40, 3)), js.tslice(jrec, slice(5, 40, 3)))
    _equal(ts.tconcat([trec, trec2]), js.tconcat([jrec, jrec2]))
    _equal(ts.tconcat((trec2, trec, trec2)), js.tconcat((jrec2, jrec, jrec2)))
    j = js.replace(jrec, b=jrec.b + 1)
    t = ts.replace(trec, b=trec.b + 1)
    assert type(t) is Rec
    _equal(t, j)


def _both(rng, shape, lo=-1.0, hi=1.0):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(t, j, rtol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0.0)


def _close_rows(t, j, rtol=1e-5):
    j = np.asarray(j)
    err = np.abs(t.numpy() - j).max(-1)
    assert (err <= rtol * np.linalg.norm(j, axis=-1)).all(), err.max()


def test_math_helpers_equal_jax():
    rng = np.random.default_rng(6)
    aj, at = _both(rng, (4096, 3))
    bj, bt = _both(rng, (4096, 3))
    tj, tt = _both(rng, (4096, 1), 0.0, 1.0)
    assert tm.EPS == jm.EPS
    _close(tm.abs_dot(at, bt), jm.abs_dot(aj, bj))
    _close(tm.lerp(at, bt, tt), jm.lerp(aj, bj, tj))
    _close(tm.abs_cos_theta(at), jm.abs_cos_theta(aj))
    # a zero cosine gives inf in both
    at = at.clone()
    at[:8, 2] = 0.0
    aj = aj.at[:8, 2].set(0.0)
    got, ref = tm.tan_theta(at), np.asarray(jm.tan_theta(aj))
    assert np.isinf(ref[:8]).all()
    _close(got, ref)
    m4 = (jm.matmul4(jm.translate([0.1, -0.2, 0.3]), jm.rotate([1, 2, 3], 33.0),
                     jm.scale_mat([0.5, 2.0, 1.25])))
    nj, nt = _both(rng, (4096, 3))
    _close_rows(tm.transform_normal(torch.as_tensor(m4), nt),
                jm.transform_normal(jnp.asarray(m4), nj))
    # batched matrices, one per normal
    mb = np.stack([jm.rotate(rng.normal(size=3), float(a)) @ jm.scale_mat(list(s))
                   for a, s in zip(rng.uniform(0, 360, 16), rng.uniform(0.5, 2.0, (16, 3)))])
    mb = mb.astype(np.float32)
    _close_rows(tm.transform_normal(torch.as_tensor(mb), nt[:16]),
                jm.transform_normal(jnp.asarray(mb), nj[:16]))


def test_seed_from_int_equals_jax():
    values = [0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 123, 2**63 + 9,
              -1, -2, -2**31, -2**32 - 3, 12_345_678_901_234]
    for v in values:
        got = trng.seed_from_int(v)
        ref = jrng.seed_from_int(v)
        assert np.asarray(ref).dtype == np.uint32
        assert got == int(ref), v
        assert 0 <= got <= trng.MASK32


def test_base_color_equals_jax():
    d = cornell_box(res=8, spp=1)
    d["red"]["reflectance"] = {"type": "checkerboard", "color0": [0.9, 0.2, 0.1],
                               "color1": [0.3, 0.05, 0.02]}
    jscene = jax_load_dict(d)[0]
    scene = load_dict(d, device="cpu")[0]
    n_mat = scene.materials.kind.shape[0]
    textured = int(np.nonzero(scene.materials.tex_id.numpy() >= 0)[0][0])
    plain = int(np.nonzero(scene.materials.tex_id.numpy() < 0)[0][0])
    rng = np.random.default_rng(7)
    mat_id = rng.integers(-1, n_mat, 2048).astype(np.int32)
    mat_id[:8] = textured
    mat_id[8:16] = plain
    uv = rng.uniform(-0.5, 1.5, (2048, 2)).astype(np.float32)
    got = base_color(scene.materials, scene.textures,
                     types.SimpleNamespace(mat_id=torch.as_tensor(mat_id), uv=torch.as_tensor(uv)))
    ref = jdispatch.base_color(jscene.materials, jscene.textures,
                               types.SimpleNamespace(mat_id=jnp.asarray(mat_id),
                                                     uv=jnp.asarray(uv)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the checkerboard shows: the textured rows are not all one colour
    assert len(np.unique(got.numpy()[:8], axis=0)) > 1
