"""The port's production forward and record+replay gradients against the JAX
package, on the CPU.

Inputs come from numpy seeds or from scenes both packages compile (the JAX
scene's tables carried across as numpy).  Tolerances:

  * `_rand`, `ray_pixel`, `ray_positions`, `_make_si`'s face rows,
    `path_lengths`: equal;
  * `pdf_emitter_direction_packed`: rtol 1e-5;
  * `render_persistent` / `render_pipelined` against JAX's
    `render_persistent`: rtol 2e-4 / atol 2e-5, the JAX package's own
    tolerance for persistent against render (tests/test_replay.py:90);
  * `record_full` against JAX's: prim and occl equal on at least 99.5% of
    the (row, depth) entries, u and v within atol 1e-4 where prim agrees —
    XLA's CPU backend fuses multiply-adds that the port's torch code does
    not, so a bounce direction may move by an ulp and, rarely, hit another
    face (the count is printed);
  * on JAX's record, carried across: `replay_radiance` per ray within rtol
    1e-4 / atol 1e-5.

The gradients are held against JAX's in test_torch_replay_grads.py.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.integrators import persistent as jpp
from mitsuba3_experiments_tpu.integrators import replay as jrep
from mitsuba3_experiments_tpu.integrators.wavefront import _rand as jax_rand
from mitsuba3_experiments_tpu.intersect.bvh_jax import _make_si as jax_make_si
from mitsuba3_experiments_tpu.core.records import Ray as JRay
from mitsuba3_experiments_tpu.render import emitter as jemitter
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import params as jparams
from mitsuba3_experiments_tpu_torch.core import math as tm
from mitsuba3_experiments_tpu_torch.core.records import Ray
from mitsuba3_experiments_tpu_torch.integrators import (
    PathIntegrator,
    PathRecord,
    path_lengths,
    ray_pixel,
    ray_positions,
    record_chunk,
    record_full,
    record_full_pipelined,
    render,
    render_persistent,
    render_pipelined,
    replay_radiance,
)
from mitsuba3_experiments_tpu_torch.integrators.wavefront import _rand
from mitsuba3_experiments_tpu_torch.intersect.bvh_torch import _make_si
from mitsuba3_experiments_tpu_torch.render import emitter
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    load_dict,
    mesh as meshlib,
    params,
    scene_from_numpy,
    scene_to_numpy,
)

torch.set_num_threads(2)

SPP, DEPTH, SEED = 2, 4, 3


def _sphere_floor_light():
    """The 32x24 sphere / floor / area-light scene of tests/test_replay.py."""
    sph = meshlib.sphere(radius=1.0, n_theta=20, n_phi=40)
    quad = meshlib.rectangle(subdiv=4)
    light = meshlib.rectangle(subdiv=1)
    fv = (quad.vertices * 4.0) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    lv = light.vertices @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32) + np.array(
        [0, 4, 0], np.float32)
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": tm.look_at([0, 2, 6], [0, 0.5, 0], [0, 1, 0]),
                   "film": {"width": 32, "height": 24}},
        "sphere": {"type": "mesh", "vertices": sph.vertices + np.array([0, 1, 0], np.float32),
                   "faces": sph.faces, "bsdf": {"type": "roughconductor", "alpha": 0.2}},
        "floor": {"type": "mesh", "vertices": fv, "faces": quad.faces,
                  "bsdf": {"type": "diffuse", "reflectance": [0.5, 0.4, 0.3]}},
        "light": {"type": "mesh", "vertices": lv, "faces": light.faces,
                  "bsdf": {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
                  "emitter": {"type": "area", "radiance": [8.0, 8.0, 8.0]}},
    }


def _pair(d):
    js = jax_load_dict(d)[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def bvh():
    return _pair(_sphere_floor_light())


@pytest.fixture(scope="module")
def frame(bvh):
    """JAX's record of the whole 32x24 spp 2 depth 4 frame (padded by 128
    rows) as numpy, the port's own record of it, and a box-filtered target
    image from the port's render at another seed."""
    js, ts = bvh
    w, h = ts.camera.resolution
    n = w * h * SPP
    pad = n + 128
    jr = jrep.record_full(js, SEED, n, spp=SPP, max_depth=DEPTH, rr_depth=4, steps=8,
                          rounds_per_launch=4, n_lanes=256, pad_to=pad)
    jrec = {f: np.asarray(getattr(jr, f)) for f in ("prim", "u", "v", "occl")}
    trec = record_full(ts, SEED, n, spp=SPP, max_depth=DEPTH, rr_depth=4, n_lanes=500, pad_to=pad)
    target = render(ts, PathIntegrator(max_depth=DEPTH), seed=9, spp=SPP, rfilter="box").numpy()
    return SimpleNamespace(n=n, pad=pad, jrec=jrec, trec=trec, target=target)


def _port_record(jrec):
    return PathRecord(**{k: torch.as_tensor(np.array(v)) for k, v in jrec.items()})


def _jax_record(jrec):
    return jrep.PathRecord(**{k: jnp.asarray(v) for k, v in jrec.items()})


def test_rand_bits_equal_jax():
    rng = np.random.default_rng(0)
    seed = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    dim = rng.integers(0, 2**32 - 2, 100_000, dtype=np.uint64).astype(np.uint32)
    fn = jax.jit(lambda s, i, d: (jax_rand(s, i, d, 1), jax_rand(s, i, d, 2)))
    ref1, ref2 = fn(jnp.asarray(seed), jnp.asarray(idx), jnp.asarray(dim))
    t = [torch.as_tensor(x.astype(np.int64)) for x in (seed, idx, dim)]
    got1, got2 = _rand(*t, 1), _rand(*t, 2)
    np.testing.assert_array_equal(got1.numpy().view(np.uint32), np.asarray(ref1).view(np.uint32))
    np.testing.assert_array_equal(got2.numpy().view(np.uint32), np.asarray(ref2).view(np.uint32))
    # a Python-int seed, as the renderers pass it
    np.testing.assert_array_equal(_rand(int(seed[0]), t[1][:10], t[2][:10], 1).numpy(),
                                  np.asarray(jax_rand(jnp.uint32(seed[0]), idx[:10], dim[:10], 1)))


@pytest.mark.parametrize("order", ["row", "tile"])
def test_ray_pixel_and_positions_equal_jax(order):
    cam = SimpleNamespace(resolution=(320, 200))
    pix = np.arange(0, 320 * 200, 7, dtype=np.uint32)
    jx, jy = jpp.ray_pixel(cam, jnp.asarray(pix), order)
    tx, ty = ray_pixel(cam, torch.as_tensor(pix.astype(np.int64)), order)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    if order == "tile":
        assert not np.array_equal(tx.numpy(), (pix % 320).astype(np.float32))
        return
    idx = np.arange(0, 320 * 200 * 4, 5, dtype=np.uint32)
    ref = jpp.ray_positions(cam, jnp.uint32(11), jnp.asarray(idx), 4)
    got = ray_positions(cam, 11, torch.as_tensor(idx.astype(np.int64)), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_make_si_rows_and_packed_pdf_equal_jax(bvh):
    js, ts = bvh
    rng = np.random.default_rng(4)
    n = 4096
    F = ts.n_faces
    em_faces = np.nonzero(scene_to_numpy(ts)["geometry.face_emitter"] >= 0)[0]
    face = rng.integers(0, F, n).astype(np.int32)
    face[::2] = rng.choice(em_faces, n // 2)
    face[::7] = -1
    u = rng.random(n, dtype=np.float32) * 0.5
    v = rng.random(n, dtype=np.float32) * 0.5
    o = rng.uniform([-3, 0.2, -3], [3, 3.5, 3], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.where(face >= 0, 1.0, np.inf).astype(np.float32)
    jsi, jrow = jax_make_si(js, JRay.make(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(t),
                            jnp.asarray(face), jnp.asarray(u), jnp.asarray(v), return_row=True)
    tsi, trow = _make_si(ts, Ray.make(torch.as_tensor(o), torch.as_tensor(d)), torch.as_tensor(t),
                         torch.as_tensor(face), torch.as_tensor(u), torch.as_tensor(v),
                         return_row=True)
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    ref_p = rng.uniform([-3, 0.2, -3], [3, 3.5, 3], (n, 3)).astype(np.float32)
    active = rng.random(n) < 0.9
    jpdf = jemitter.pdf_emitter_direction_packed(js, SimpleNamespace(p=jnp.asarray(ref_p)), jsi,
                                                 jrow[:, 27], jrow[:, 28], jnp.asarray(active))
    tpdf = emitter.pdf_emitter_direction_packed(ts, SimpleNamespace(p=torch.as_tensor(ref_p)), tsi,
                                                trow[:, 27], trow[:, 28], torch.as_tensor(active))
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5, atol=0.0)
    assert (tpdf.numpy() > 0).mean() > 0.05
    # the packed columns give the emitter table's pdf
    tab = emitter.pdf_emitter_direction(ts, SimpleNamespace(p=torch.as_tensor(ref_p)), tsi,
                                        torch.as_tensor(active))
    np.testing.assert_allclose(tpdf.numpy(), tab.numpy(), rtol=1e-6, atol=0.0)


def test_params_traverse_and_update_round_trip(bvh):
    js, ts = bvh
    assert set(params.PARAM_KEYS) == set(jparams.PARAM_KEYS)
    p = params.traverse(ts)
    for k, v in jparams.traverse(js).items():
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(v), err_msg=k)
    new = {k: v + 0.25 for k, v in p.items()}
    s2 = params.update(ts, new)
    for k, v in params.traverse(s2).items():
        assert v is new[k], k
    for k, v in params.traverse(ts).items():     # the scene passed in is unchanged
        assert v is p[k], k
    assert s2.geometry is ts.geometry and s2.bvh is ts.bvh
    part = params.update(ts, {"emitters.radiance": new["emitters.radiance"]})
    assert part.emitters.radiance is new["emitters.radiance"]
    assert part.materials is ts.materials and part.camera is ts.camera


@pytest.mark.parametrize("name", ["cornell", "sphere_floor_light"])
def test_persistent_and_pipelined_render_match_jax(name, bvh):
    if name == "cornell":
        js, ts = _pair(cornell_box(res=16))
        spp, depth = SPP, 5
    else:
        (js, ts), spp, depth = bvh, SPP, 5
    ref = np.asarray(jpp.render_persistent(js, seed=SEED, spp=spp, max_depth=depth,
                                           rfilter="box", n_lanes=256, steps=8,
                                           rounds_per_launch=4))
    w, h = ts.camera.resolution
    for fn in (render_persistent, render_pipelined):
        got = fn(ts, seed=SEED, spp=spp, max_depth=depth, rfilter="box", n_lanes=300).numpy()
        assert got.shape == (h, w, 3) and np.isfinite(got).all() and got.mean() > 0
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=fn.__name__)
    # one batch or many, the same rays: radiance does not depend on the batch
    one = render_persistent(ts, seed=SEED, spp=spp, max_depth=depth, rfilter="tent").numpy()
    many = render_persistent(ts, seed=SEED, spp=spp, max_depth=depth, rfilter="tent",
                             n_lanes=97).numpy()
    np.testing.assert_array_equal(one, many)
    # and equals render()'s lockstep image, keyed alike (one pass)
    lock = render(ts, PathIntegrator(max_depth=depth), seed=SEED, spp=spp, spp_per_pass=spp,
                  rfilter="tent").numpy()
    np.testing.assert_allclose(one, lock, rtol=1e-5, atol=1e-6)


def test_record_full_against_jax(frame, capsys):
    n, pad = frame.n, frame.pad
    rec = frame.trec
    assert rec.prim.shape == (pad, DEPTH) and rec.prim.dtype == torch.int32
    assert rec.occl.dtype == torch.bool
    j = frame.jrec
    prim, occl = rec.prim.numpy(), rec.occl.numpy()
    same_prim = prim == j["prim"]
    same = same_prim & (occl == j["occl"])
    with capsys.disabled():
        print(f"\n[record_full] (row, depth) entries differing from JAX: {int((~same).sum())} "
              f"of {same.size}")
    assert same.mean() >= 0.995
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(rec, k).numpy()[same_prim], j[k][same_prim], atol=1e-4)
    assert (prim[n:] == -1).all() and not occl[n:].any()
    assert (rec.u.numpy()[n:] == 0).all() and (rec.v.numpy()[n:] == 0).all()
    assert (prim[:n, 0] >= 0).mean() > 0.5 and occl.any()


def test_record_variants_equal_record_full(bvh, frame):
    _, ts = bvh
    n, pad = frame.n, frame.pad
    kw = dict(spp=SPP, max_depth=DEPTH, rr_depth=4)
    chunk = record_chunk(ts, SEED, 100, 700, ray_end=n, n_lanes=128, **kw)
    tail = record_chunk(ts, SEED, n - 50, 200, ray_end=n, **kw)
    rec_p, film = record_full_pipelined(ts, SEED, n, pad_to=pad, return_film=True, **kw)
    for f in ("prim", "u", "v", "occl"):
        full = getattr(frame.trec, f)
        assert torch.equal(getattr(chunk, f), full[100:800]), f
        assert torch.equal(getattr(tail, f)[:50], full[n - 50:n]), f
        assert torch.equal(getattr(rec_p, f), full), f
    assert (tail.prim[50:] == -1).all()
    # the recorder's film is the forward film of the same rays
    w, h = ts.camera.resolution
    img = film[..., :3] / film[..., 3:4]
    ref = render_persistent(ts, seed=SEED, spp=SPP, max_depth=DEPTH, rfilter="box").numpy()
    assert film.shape == (h, w, 4)
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_replay_radiance_on_jax_record(bvh, frame):
    js, ts = bvh
    kw = dict(spp=SPP, max_depth=DEPTH, rr_depth=4)
    jL, jpos, jact = jax.jit(lambda r: jrep.replay_radiance(js, r, jnp.uint32(SEED), jnp.uint32(0),
                                                            ray_end=jnp.uint32(frame.n), **kw))(
        _jax_record(frame.jrec))
    L, pos, act = replay_radiance(ts, _port_record(frame.jrec), SEED, 0, ray_end=frame.n, **kw)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-4, atol=1e-5)
    assert float(L.sum()) > 0
    # replaying the port's own record gives the radiance the recorder made
    own, _, _ = replay_radiance(ts, frame.trec, SEED, 0, ray_end=frame.n, **kw)
    fwd = render_persistent(ts, seed=SEED, spp=SPP, max_depth=DEPTH, rfilter="box").numpy()
    from mitsuba3_experiments_tpu_torch.render import film as filmlib
    img = filmlib.develop(filmlib.put(filmlib.new_film(32, 24, device="cpu"), pos,
                                      torch.where(torch.isfinite(own), own, 0.0), act)).numpy()
    np.testing.assert_allclose(img, fwd, rtol=1e-5, atol=1e-6)


def test_path_lengths_equal_jax(frame):
    got = path_lengths(_port_record(frame.jrec)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrep.path_lengths(_jax_record(frame.jrec))))
    assert got.dtype == np.int32 and got.min() >= 1 and got.max() <= DEPTH
    assert (got[frame.n:] == 1).all()


def test_entry_points_default_to_the_card():
    """No device means the card: without one the call raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises((RuntimeError, AssertionError)):
        load_dict(cornell_box(res=4))
    from mitsuba3_experiments_tpu_torch import default_device, resolve_device

    assert default_device() == torch.device("cuda")
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
