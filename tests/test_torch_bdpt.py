"""The port's bidirectional path tracer against the JAX package: images of
BDPTIntegrator with full MIS over every (s, t >= 2) strategy and with the
reference's unweighted (1, 1) connection, and record_path's (depth, lane)
vertex buffer vertex by vertex.

Scene: the Cornell box with a 2,304-triangle sphere at 24x16 (its ray
queries take the BVH), once with a glass sphere so that delta vertices
enter the MIS weights.  Images: at least 99.9% of the pixels within rtol
1e-4 / atol 1e-5 and means within a relative 1e-4, the pixels outside
printed (a Russian-roulette or lobe decision flipped at a float
boundary).  Vertices: allclose rtol 1e-4 / atol 1e-5 on at least 99.9% of
the lanes, ids and masks equal there."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core.rng import Sampler as JSampler
from mitsuba3_experiments_tpu.integrators import render as jax_render
from mitsuba3_experiments_tpu.integrators.bdpt import BDPTIntegrator as JBDPT
from mitsuba3_experiments_tpu.integrators.bdpt import record_path as jax_record_path
from mitsuba3_experiments_tpu.render import sensor as jsensor
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core.rng import Sampler
from mitsuba3_experiments_tpu_torch.core.struct import tgather
from mitsuba3_experiments_tpu_torch.integrators import BDPTIntegrator, render
from mitsuba3_experiments_tpu_torch.integrators.bdpt import record_path
from mitsuba3_experiments_tpu_torch.render import sensor
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    mesh as meshlib,
    scene_from_numpy,
    scene_to_numpy,
)

torch.set_num_threads(2)


def _scene(glass):
    d = cornell_box(res=24, spp=1)
    d["sensor"]["film"] = {"width": 24, "height": 16}
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=24, n_phi=48)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals,
                   "bsdf": {"type": "dielectric"} if glass else {"type": "ref", "id": "white"}}
    js = jax_load_dict(d)[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def box():
    return _scene(glass=False)


@pytest.fixture(scope="module")
def glass_box():
    return _scene(glass=True)


def _images_match(name, got, ref):
    a, b = got.numpy(), np.asarray(ref)
    close = (np.isclose(a, b, rtol=1e-4, atol=1e-5) | (a == b)).all(-1)
    rel = abs(a.mean() - b.mean()) / b.mean()
    print(f"[{name}] {int((~close).sum())} of {close.size} pixels outside rtol 1e-4 / atol 1e-5; "
          f"means {a.mean():.7f} / {b.mean():.7f} (rel {rel:.2e})")
    assert np.isfinite(a).all() and b.mean() > 0
    assert close.mean() >= 0.999 and rel <= 1e-4


@pytest.mark.parametrize("scene_name,depth", [("box", 4), ("glass_box", 3)])
def test_bdpt_full_mis_image_matches_jax(scene_name, depth, request):
    js, ts = request.getfixturevalue(scene_name)
    ref = jax_render(js, JBDPT(max_depth=depth), spp=1, seed=4)
    _images_match(f"bdpt mis {scene_name} depth {depth}",
                  render(ts, BDPTIntegrator(max_depth=depth), spp=1, seed=4), ref)


def test_bdpt_reference_connection_image_matches_jax(box):
    js, ts = box
    ref = jax_render(js, JBDPT(max_depth=4, mis=False), spp=2, seed=6)
    _images_match("bdpt (1,1)", render(ts, BDPTIntegrator(max_depth=4, mis=False), spp=2, seed=6),
                  ref)


def test_record_path_matches_jax_per_vertex(glass_box):
    """record_path's (max_depth+1, N) buffer equals JAX's vertex by vertex;
    vertex 0 is the camera origin, and tgather over depth drops the axis."""
    js, ts = glass_box
    n, depth = 384, 4
    rng = np.random.default_rng(8)
    pos = (rng.random((n, 2)) * [24, 16]).astype(np.float32)
    path, s = record_path(ts, Sampler.create(3, n, device="cpu"),
                          sensor.sample_ray(ts.camera, torch.as_tensor(pos)), max_depth=depth)
    jpath, js_ = jax_record_path(js, JSampler.create(3, n),
                                 jsensor.sample_ray(js.camera, jnp.asarray(pos)), max_depth=depth)
    assert s.dim == int(js_.dim) == 3 * depth
    assert path.p.shape == (depth + 1, n, 3)
    lanes_ok = np.ones(n, bool)
    for f in dataclasses.fields(path):
        a, b = getattr(path, f.name).numpy(), np.asarray(getattr(jpath, f.name))
        assert a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            ok = np.isclose(a, b, rtol=1e-4, atol=1e-5) | (a == b)
        else:
            ok = a == b
        lanes_ok &= ok.reshape(depth + 1, n, -1).all(axis=(0, 2))
    print(f"[record_path] {int((~lanes_ok).sum())} of {n} lanes differ in some vertex")
    assert lanes_ok.mean() >= 0.999
    v0 = tgather(path, 0, axis=0)
    assert torch.equal(v0.p, sensor.sample_ray(ts.camera, torch.as_tensor(pos)).o)
    assert bool(path.valid[1].any()) and not bool(path.valid[1:].all())
