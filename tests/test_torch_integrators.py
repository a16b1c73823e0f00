"""The port's integrator zoo, first part, against the JAX package: the
record helpers of core/struct.py, the sensor's projection, emitter rays,
SimpleIntegrator, render_wavefront and the particle tracer, and the
integrator registry.

Every integrator draws from the counter-based sampler keyed by (seed, lane,
dimension), whose bits the port reproduces, so images are compared pixel by
pixel: at least 99.9% of the pixels within rtol 1e-4 / atol 1e-5, image
means within a relative 1e-4.  A pixel outside that tolerance can only be
a Russian-roulette or branch decision that flipped at a float boundary;
each test prints how many there are.  Helpers are compared allclose (rtol
1e-5, atol 1e-6), or exactly where they only move data."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core import struct as jstruct
from mitsuba3_experiments_tpu.core.records import SurfaceInteraction as JSI
from mitsuba3_experiments_tpu.integrators import PathIntegrator as JPath
from mitsuba3_experiments_tpu.integrators import render as jax_render
from mitsuba3_experiments_tpu.integrators.ptracer import ParticleTracer as JParticleTracer
from mitsuba3_experiments_tpu.integrators.simple import SimpleIntegrator as JSimple
from mitsuba3_experiments_tpu.integrators.wavefront import render_wavefront as jax_wavefront
from mitsuba3_experiments_tpu.render import emitter as jemitter
from mitsuba3_experiments_tpu.render import sensor as jsensor
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core import struct
from mitsuba3_experiments_tpu_torch.core.records import SurfaceInteraction
from mitsuba3_experiments_tpu_torch.integrators import (
    BDPTIntegrator,
    ParticleTracer,
    RestirGI,
    SimpleIntegrator,
    SPPM,
    SpectralIntegrator,
    make_integrator,
    render,
    render_wavefront,
)
from mitsuba3_experiments_tpu_torch.render import emitter, sensor
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    mesh as meshlib,
    scene_from_numpy,
    scene_to_numpy,
    standin_dict,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def cornell_sphere(res=(24, 16), sphere_bsdf=None):
    """The Cornell box with a 2,304-triangle sphere: enough triangle slots
    that ray queries take the BVH (K1 on the card), not the brute force."""
    d = cornell_box(res=res[0], spp=1)
    d["sensor"]["film"] = {"width": res[0], "height": res[1]}
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=24, n_phi=48)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals,
                   "bsdf": sphere_bsdf or {"type": "ref", "id": "white"}}
    return d


def pair(d):
    js = jax_load_dict(d)[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


def assert_images_match(name, got, ref):
    """>= 99.9% of the pixels within rtol 1e-4 / atol 1e-5, means within a
    relative 1e-4; prints the pixels outside."""
    a = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = np.asarray(ref)
    assert a.shape == b.shape and np.isfinite(a).all()
    close = (np.isclose(a, b, rtol=RTOL, atol=ATOL) | (a == b)).reshape(-1, a.shape[-1]).all(-1)
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    print(f"[{name}] {int((~close).sum())} of {close.size} pixels outside rtol {RTOL} / atol "
          f"{ATOL}; means {a.mean():.7f} / {b.mean():.7f} (rel {rel:.2e})")
    assert b.mean() > 0.0
    assert close.mean() >= 0.999, close.mean()
    assert rel <= 1e-4, rel


@pytest.fixture(scope="module")
def standin():
    return pair(standin_dict(res=(24, 16), spp=1, tri_budget=20_000))


@pytest.fixture(scope="module")
def box():
    return pair(cornell_sphere())


# ------------------------------ core/struct ------------------------------

def _si_arrays(rng, n):
    v3 = lambda: rng.normal(size=(n, 3)).astype(np.float32)  # noqa: E731
    return dict(t=rng.random(n, dtype=np.float32), p=v3(), n=v3(), sh_n=v3(), sh_s=v3(),
                sh_t=v3(), uv=rng.random((n, 2), dtype=np.float32), wi=v3(),
                prim_idx=rng.integers(-1, 50, n).astype(np.int32),
                mat_id=rng.integers(-1, 5, n).astype(np.int32),
                emitter_id=rng.integers(-1, 2, n).astype(np.int32))


def _same(t_rec, j_rec):
    for f in dataclasses.fields(t_rec):
        np.testing.assert_array_equal(getattr(t_rec, f.name).numpy(),
                                      np.asarray(getattr(j_rec, f.name)))


def test_struct_helpers_match_jax():
    """tgather (index array and int), twhere, tzeros_like, trepeat and
    tmap over nested records equal JAX's tree operations."""
    rng = np.random.default_rng(3)
    a, b = _si_arrays(rng, 257), _si_arrays(rng, 257)
    ja, jb = (JSI(**{k: jnp.asarray(v) for k, v in x.items()}) for x in (a, b))
    ta, tb = (SurfaceInteraction(**{k: torch.as_tensor(v) for k, v in x.items()}) for x in (a, b))
    mask = rng.random(257) < 0.4
    idx = rng.integers(0, 257, 300)
    _same(struct.twhere(torch.as_tensor(mask), ta, tb), jstruct.twhere(jnp.asarray(mask), ja, jb))
    _same(struct.tgather(ta, torch.as_tensor(idx)), jstruct.tgather(ja, jnp.asarray(idx)))
    _same(struct.tzeros_like(ta), jstruct.tzeros_like(ja))
    _same(struct.trepeat(ta, 3), jstruct.trepeat(ja, 3))
    # depth-major buffers: an int index drops the leading axis
    stacked = struct.tmap(lambda x, y: torch.stack([x, y]), ta, tb)
    _same(struct.tgather(stacked, 1, axis=0), jb)
    # nested records and tuples map leaf by leaf
    from mitsuba3_experiments_tpu_torch.integrators.restir import RestirReservoir
    res = RestirReservoir.zeros(4)
    out = struct.tmap(lambda x: x + 1, (res, res.w))
    assert torch.equal(out[0].z.x_v, torch.ones(4, 3)) and torch.equal(out[1], torch.ones(4))
    assert out[0].M.dtype == torch.int32
    # records.py keeps one copy of the helpers, imported from struct.py
    from mitsuba3_experiments_tpu_torch.core import records
    assert records.twhere is struct.twhere and records.trepeat is struct.trepeat


# --------------------------------- sensor ---------------------------------

def test_sensor_projection_matches_jax_and_round_trips(standin):
    """perspective_projection and sample_direction equal JAX's; a world
    point on a camera ray projects back onto the film position it came
    from, through both."""
    js, ts = standin
    np.testing.assert_allclose(sensor.perspective_projection(ts.camera).numpy(),
                               np.asarray(jsensor.perspective_projection(js.camera)),
                               rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(5)
    w, h = ts.camera.resolution
    pos = (rng.random((4096, 2)) * [w, h]).astype(np.float32)
    ray = sensor.sample_ray(ts.camera, torch.as_tensor(pos))
    dist = torch.as_tensor(rng.uniform(0.5, 6.0, 4096).astype(np.float32))
    pts = ray.o + ray.d * dist[:, None]
    # points behind the camera and outside the view are invalid
    pts_all = torch.cat([pts, ray.o - ray.d, torch.as_tensor(
        rng.uniform(-20, 20, (512, 3)).astype(np.float32))])
    got = sensor.sample_direction(ts.camera, pts_all)
    ref = jsensor.sample_direction(js.camera, jnp.asarray(pts_all.numpy()))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    pos_back, d_back, valid = got
    assert bool(valid[:4096].all()) and not bool(valid[4096:8192].any())
    np.testing.assert_allclose(pos_back[:4096].numpy(), pos, atol=2e-3)
    np.testing.assert_allclose(d_back[:4096].numpy(), dist.numpy(), rtol=1e-5)
    # the projection matrix maps the same points to the same film position
    proj = sensor.perspective_projection(ts.camera)
    hp = torch.cat([pts, torch.ones(4096, 1)], dim=1) @ proj.T
    ndc = hp[:, :2] / hp[:, 3:4]
    np.testing.assert_allclose((ndc * torch.tensor([w, h])).numpy(), pos, atol=2e-3)


# --------------------------------- emitter --------------------------------

def test_sample_emitter_ray_matches_jax(standin):
    """Rays, power and emitter ids of sample_emitter_ray equal JAX's on the
    stand-in's two area lights (the pdf enters through the power, Le * pi /
    p_area)."""
    js, ts = standin
    rng = np.random.default_rng(9)
    up, ud = (rng.random((8192, 2), dtype=np.float32) for _ in range(2))
    jray, jw, jid = jemitter.sample_emitter_ray(js, jnp.asarray(up), jnp.asarray(ud))
    tray, tw, tid = emitter.sample_emitter_ray(ts, torch.as_tensor(up), torch.as_tensor(ud))
    for t, j in ((tray.o, jray.o), (tray.d, jray.d), (tray.maxt, jray.maxt), (tw, jw)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert len(set(tid.tolist())) == 2 and float(tw.min()) > 0.0


# ------------------------------- integrators ------------------------------

def test_simple_integrator_image_matches_jax(standin):
    js, ts = standin
    ref = jax_render(js, JSimple(max_depth=4), spp=2, seed=3)
    assert_images_match("simple", render(ts, SimpleIntegrator(max_depth=4), spp=2, seed=3), ref)


def test_render_wavefront_matches_jax(box):
    """The port's render_wavefront equals JAX's render_wavefront and JAX's
    one-pass render() with PathIntegrator, as tests/test_wavefront.py
    requires of the JAX package."""
    js, ts = box
    got = render_wavefront(ts, seed=1, spp=2, max_depth=4, rfilter="tent")
    assert_images_match("wavefront vs JAX wavefront", got,
                        jax_wavefront(js, seed=1, spp=2, max_depth=4, rfilter="tent",
                                      n_lanes=512))
    assert_images_match("wavefront vs JAX render", got,
                        jax_render(js, JPath(max_depth=4), seed=1, spp=2, spp_per_pass=2,
                                   rfilter="tent"))


def test_particle_tracer_image_matches_jax(box):
    js, ts = box
    ref = JParticleTracer(max_depth=3).render(js, seed=2, spp=2)
    got = ParticleTracer(max_depth=3).render(ts, seed=2, spp=2)
    assert_images_match("ptracer", got, ref)


@pytest.mark.parametrize("name,cls", [
    ("simple", SimpleIntegrator), ("ptracer", ParticleTracer),
    ("spectral", SpectralIntegrator), ("bdpt", BDPTIntegrator), ("sppm", SPPM),
    ("restirgi", RestirGI),
])
def test_make_integrator_knows_the_zoo(name, cls):
    """make_integrator builds each new integrator from its name; its fields
    come from the dict, other keys are ignored."""
    field = dataclasses.fields(cls)[0]
    value = field.default + 1 if isinstance(field.default, int) else field.default
    integ = make_integrator({"type": name, field.name: value, "not_a_field": 1})
    assert type(integ) is cls and getattr(integ, field.name) == value
