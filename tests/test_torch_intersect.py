"""Port traversal (the module that holds the CUDA kernel) against the JAX
package: the plain torch lockstep version against bvh_jax._traverse and the
Pallas kernel in interpret mode, ray_intersect / _make_si fields, and the
CPU dispatch (plain version, no kernel launch).

Tolerances: closest-hit faces equal on >= 99.9% of rays, t/u/v on those
within rtol 1e-5, atol 1e-6; any-hit hit/miss equal on >= 99.9%."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core.records import Ray as JRay
from mitsuba3_experiments_tpu.intersect import bvh_jax
from mitsuba3_experiments_tpu.intersect.bvh_pallas import pack_tables, traverse_pallas
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core.records import Ray
from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
from mitsuba3_experiments_tpu_torch.scene import (
    load_dict,
    mesh as meshlib,
    scene_from_numpy,
    scene_to_numpy,
    standin_dict,
)
from mitsuba3_experiments_tpu_torch.scene.bvh8 import DEFAULT_LAYOUT
from mitsuba3_experiments_tpu_torch.scene.flagship import _BLOB_HI, _BLOB_LO

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
MIN_SHARE = 0.999


def _sphere_dict():
    sph = meshlib.sphere(radius=1.0, n_theta=32, n_phi=64)
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0},
        "s": {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
              "normals": sph.normals, "bsdf": {"type": "diffuse"}},
    }


_SCENES = {
    # rays from a box around the object towards its middle
    "sphere": (_sphere_dict, (-3.0, 3.0), (-0.8, 0.8)),
    "standin": (lambda: standin_dict(res=(64, 36), tri_budget=20_000),
                (-3.5, 4.5), (_BLOB_LO, _BLOB_HI)),
}


@pytest.fixture(scope="module", params=sorted(_SCENES))
def scenes(request):
    make, o_box, t_box = _SCENES[request.param]
    jax_scene = jax_load_dict(make())[0]
    return request.param, jax_scene, scene_from_numpy(scene_to_numpy(jax_scene), device="cpu"), o_box, t_box


def _rays(n, o_box, t_box, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(*o_box, size=(n, 3)).astype(np.float32)
    o[:, 1] = np.clip(o[:, 1], 0.05, 2.9) if np.ndim(t_box[0]) else o[:, 1]
    tgt = rng.uniform(*t_box, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.random(n) < 0.7, np.inf, rng.uniform(0.2, 4.0, n)).astype(np.float32)
    active = np.ones(n, bool)
    active[::17] = False
    return o, d.astype(np.float32), maxt, active


def _compare(got, ref, any_hit):
    tg, fg, ug, vg = (np.asarray(x) for x in got)
    tr, fr, ur, vr = (np.asarray(x) for x in ref)
    if any_hit:
        share = np.mean((fg >= 0) == (fr >= 0))
        assert share >= MIN_SHARE, share
        return
    same = fg == fr
    assert same.mean() >= MIN_SHARE, same.mean()
    for a, b in ((tg, tr), (ug, ur), (vg, vr)):
        np.testing.assert_allclose(a[same], b[same], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [300, 4096])
def test_plain_traverse_matches_jax_traverse(scenes, n, any_hit):
    _, js, ts, o_box, t_box = scenes
    o, d, maxt, active = _rays(n, o_box, t_box, seed=n)
    b = js.bvh
    ref = bvh_jax._traverse(
        b.unified, b.nodes.shape[0], jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt),
        jnp.asarray(active), any_hit, layout=b.layout,
    )
    tb = ts.bvh
    got = bvh_torch.traverse_plain(
        tb.unified, tb.nodes.shape[0], torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(maxt), torch.as_tensor(active), any_hit, layout=tb.layout,
    )
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    assert bool((got[1][torch.as_tensor(~active)] == -1).all())
    assert bool(torch.isinf(got[0][got[1] < 0]).all())
    _compare(got, ref, any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_traverse_matches_pallas_interpret(scenes, any_hit):
    _, js, ts, o_box, t_box = scenes
    o, d, maxt, active = _rays(300, o_box, t_box, seed=5)
    node_tab, leaf_tab = pack_tables(js.bvh)
    ref = traverse_pallas(
        node_tab, leaf_tab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt),
        jnp.asarray(active), tile=128, any_hit=any_hit, interpret=True,
    )
    tb = ts.bvh
    got = bvh_torch.traverse_plain(
        tb.unified, tb.nodes.shape[0], torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(maxt), torch.as_tensor(active), any_hit, layout=tb.layout,
    )
    _compare(got, ref, any_hit)


def test_ray_intersect_fields_match(scenes):
    _, js, ts, o_box, t_box = scenes
    o, d, maxt, active = _rays(2048, o_box, t_box, seed=9)
    jsi = bvh_jax.ray_intersect(
        js, JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt)), jnp.asarray(active)
    )
    tsi = bvh_torch.ray_intersect(
        ts, Ray(o=torch.as_tensor(o), d=torch.as_tensor(d), maxt=torch.as_tensor(maxt)),
        torch.as_tensor(active),
    )
    same = tsi.prim_idx.numpy() == np.asarray(jsi.prim_idx)
    assert same.mean() >= MIN_SHARE, same.mean()
    for f in ("t", "p", "n", "sh_n", "sh_s", "sh_t", "uv", "wi"):
        a, b = getattr(tsi, f).numpy()[same], np.asarray(getattr(jsi, f))[same]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f)
    for f in ("mat_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(tsi, f).numpy()[same], np.asarray(getattr(jsi, f))[same])
    occ_t = bvh_torch.ray_test(ts, Ray(o=torch.as_tensor(o), d=torch.as_tensor(d),
                                       maxt=torch.as_tensor(maxt)), torch.as_tensor(active))
    occ_j = bvh_jax.ray_test(js, JRay(o=jnp.asarray(o), d=jnp.asarray(d),
                                      maxt=jnp.asarray(maxt)), jnp.asarray(active))
    assert np.mean(occ_t.numpy() == np.asarray(occ_j)) >= MIN_SHARE


def test_cpu_dispatch_runs_plain_and_launches_nothing(scenes):
    _, _, ts, o_box, t_box = scenes
    o, d, maxt, active = _rays(64, o_box, t_box, seed=3)
    calls, launches = bvh_torch.calls, bvh_cuda.launches
    b = ts.bvh
    args = (b.unified, b.nodes.shape[0], torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(maxt), torch.as_tensor(active))
    bvh_torch.traverse(*args, layout=b.layout)
    bvh_torch.ray_test(ts, Ray(o=args[2], d=args[3], maxt=args[4]), args[5])
    assert bvh_torch.calls == calls + 2
    assert bvh_cuda.launches == launches
    # the kernel wrapper takes CUDA tensors only: no silent CPU path
    with pytest.raises(ValueError):
        bvh_cuda.traverse_cuda(*args, layout=b.layout)
    assert bvh_cuda.launches == launches


def test_plain_traverse_raises_on_stack_overflow():
    """A layout whose stack is shallower than the table needs: the plain
    version raises, as the kernel's wrapper does, and drops nothing."""
    _, o_box, t_box = _SCENES["standin"]
    ts = load_dict(standin_dict(res=(64, 36), tri_budget=20_000), device="cpu")[0]
    o, d, maxt, active = _rays(512, o_box, t_box, seed=6)
    b = ts.bvh
    shallow = dataclasses.replace(b.layout or DEFAULT_LAYOUT, stack_depth=8)
    with pytest.raises(RuntimeError, match="stack overflow"):
        bvh_torch.traverse_plain(
            b.unified, b.nodes.shape[0], torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(maxt), torch.as_tensor(active), False, layout=shallow,
        )


def test_brute_force_matches_bvh_on_sphere():
    ts = scene_from_numpy(scene_to_numpy(jax_load_dict(_sphere_dict())[0]), device="cpu")
    o, d, maxt, active = _rays(256, (-3.0, 3.0), (-0.8, 0.8), seed=4)
    ray = Ray(o=torch.as_tensor(o), d=torch.as_tensor(d), maxt=torch.as_tensor(maxt))
    a = bvh_torch.ray_intersect(ts, ray, torch.as_tensor(active))
    b = bvh_torch.ray_intersect_brute(ts, ray, torch.as_tensor(active))
    np.testing.assert_array_equal(a.prim_idx.numpy(), b.prim_idx.numpy())
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=1e-5, atol=1e-6)
