"""The port's truncated replay (`replay_grads(mode="trunc")`) against its full
replay and the JAX package's `replay_grads_trunc`, on the CPU.

At the settings of tests/test_replay.py's trunc test: the 32x24 sphere /
floor / light frame, spp 2, depth 12, rr_depth 3, chunks of 128 rows, the
record JAX's (carried across as numpy), with some chunk's longest path short
of the depth, so JAX's replay does truncate.  In the port 'trunc' is the
full replay (its depth loop already stops once a chunk has no live row), so
the two are equal; the port equals JAX's truncated replay within rtol 1e-3 /
atol 1e-4 max|g|, as test_torch_replay_grads.py holds the full replay.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.integrators import replay as jrep
from mitsuba3_experiments_tpu.scene import params as jparams
from mitsuba3_experiments_tpu_torch.integrators import (
    PathIntegrator,
    path_lengths,
    render,
    replay_grads,
    replay_grads_full,
)
from mitsuba3_experiments_tpu_torch.scene import params
from test_torch_replay import _jax_record, _port_record, bvh  # noqa: F401

torch.set_num_threads(2)

SPP, DEPTH, RR, SEED, CHUNK = 2, 12, 3, 3, 128
KEYS = ("materials.base_color", "emitters.radiance")


@pytest.fixture(scope="module")
def deep(bvh):
    js, ts = bvh
    w, h = ts.camera.resolution
    n = w * h * SPP
    pad = -(-n // CHUNK) * CHUNK
    jr = jrep.record_full(js, SEED, n, spp=SPP, max_depth=DEPTH, rr_depth=RR, steps=8,
                          rounds_per_launch=4, n_lanes=256, pad_to=pad)
    jrec = {f: np.asarray(getattr(jr, f)) for f in ("prim", "u", "v", "occl")}
    with torch.no_grad():
        target = render(ts, PathIntegrator(max_depth=DEPTH), seed=9, spp=SPP, rfilter="box")
    return n, jrec, target.numpy()


def test_replay_grads_trunc_equals_full_and_jax(bvh, deep):
    js, ts = bvh
    n, jrec, target = deep
    rec = _port_record(jrec)
    lens = path_lengths(rec).reshape(-1, CHUNK).amax(dim=1)
    assert int(lens.min()) < DEPTH   # JAX's replay cuts some chunk short
    tp = {k: params.traverse(ts)[k] for k in KEYS}
    kw = dict(chunk=CHUNK, spp=SPP, max_depth=DEPTH, rr_depth=RR, rfilter="box")
    tgt = torch.as_tensor(target)
    full = replay_grads_full(ts, tp, params.update, tgt, SEED, rec, n, **kw)
    trunc = replay_grads(ts, tp, params.update, tgt, SEED, rec, n, mode="trunc", **kw)
    jp = {k: jparams.traverse(js)[k] for k in KEYS}
    ref = jrep.replay_grads_trunc(js, jp, jparams.update, jnp.asarray(target), SEED,
                                  _jax_record(jrec), n, **kw)
    for k in KEYS:
        a, b = full[k].numpy(), trunc[k].numpy()
        assert np.abs(a).max() > 0, k
        assert torch.equal(trunc[k], full[k]), k
        j = np.asarray(ref[k])
        np.testing.assert_allclose(b, j, rtol=1e-3, atol=1e-4 * np.abs(j).max(), err_msg=k)
