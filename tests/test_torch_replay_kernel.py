"""K5, the replay kernels, on the CPU: its Function against the JAX
package, its arithmetic (the kernel header built with g++) against the plain
replay, and the keys it differentiates.

  * `replay_grads` full and sorted (on CPU tensors the replay is the plain
    version) gives JAX's `replay_grads` on the 32x32 Cornell box + a
    4k-triangle sphere, on one record carried across as numpy, within rtol
    1e-3 / atol 1e-4 max|g| (tests/test_torch_replay_grads.py's tolerance:
    the two packages sum the same terms in another order).  The scene that
    holds every BSDF kind is held against JAX in
    test_torch_replay_kernel_kinds.py (its JAX compiles take a file's time).
  * csrc/replay_path.h, built with g++ (tests/torch_replay_host.py), on the
    Cornell box and on the every-kind scene with each environment: per-row
    L equal to `replay_radiance_plain` on at least 0.9999 of the rows
    within rtol 1e-4 / atol 1e-5 (a roulette decision may flip on a last
    bit), and the gradients of sum(L dL), every row summed in float64,
    within rtol 1e-3 / atol 1e-4 max|g| of autograd's through the plain
    replay.  The port's CPU path does not use that build.
  * On the CPU `replay_radiance` is the plain version, and every key of
    scene/params.py still differentiates through it; the card's path
    raises for the three keys K5 does not differentiate, naming the key,
    and takes the two it does to K5's launch; the wrapper refuses a scene
    it does not read.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_replay_host as host
from mitsuba3_experiments_tpu.integrators import replay as jrep
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import params as jparams
from mitsuba3_experiments_tpu_torch.core import math as tm
from mitsuba3_experiments_tpu_torch.integrators import (
    PathRecord,
    record_full,
    replay,
    replay_cuda,
    replay_grads,
)
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    load_dict,
    mesh as meshlib,
    params,
    scene_from_numpy,
    scene_to_numpy,
)

torch.set_num_threads(2)

K5_KEYS = ("materials.base_color", "emitters.radiance")
SPP, DEPTH, RR, SEED = 2, 4, 2, 3


def cornell_sphere():
    """The 32x32 Cornell box with a 4k-triangle sphere."""
    d = cornell_box(res=32, spp=2)
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=32, n_phi=64)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    return d


def every_kind(env):
    """A 24x16 scene with a sphere of each of the ten BSDF kinds (and a
    twosided adapter), textured albedos, a mask over a nested rough plastic
    and a mask whose opacity is a texture, diffuse and plastic rows with a
    zero albedo channel, two area lights and `env`: None, a constant
    environment or a textured envmap."""
    sph = meshlib.sphere(radius=0.45, n_theta=10, n_phi=20)
    quad = meshlib.rectangle(subdiv=2)
    light = meshlib.rectangle(subdiv=1)
    checker = {"type": "checkerboard", "color0": [0.8, 0.2, 0.1], "color1": [0.1, 0.6, 0.3]}
    bsdfs = [
        {"type": "diffuse", "reflectance": [0.7, 0.0, 0.4]},
        {"type": "conductor", "material": "Au"},
        {"type": "roughconductor", "material": "Cu", "alpha": 0.25},
        {"type": "dielectric", "int_ior": 1.5},
        {"type": "roughdielectric", "int_ior": 1.4, "alpha": 0.2},
        {"type": "plastic", "diffuse_reflectance": [0.2, 0.5, 0.0]},
        {"type": "roughplastic", "alpha": 0.3, "diffuse_reflectance": checker},
        {"type": "mask", "opacity": [0.7, 0.4, 0.55],
         "bsdf": {"type": "roughplastic", "alpha": 0.2, "diffuse_reflectance": [0.6, 0.3, 0.2]}},
        {"type": "twosided", "bsdf": {"type": "diffuse", "reflectance": checker}},
        {"type": "null"},
        {"type": "principled", "metallic": 0.4, "roughness": 0.5, "base_color": [0.9, 0.5, 0.0]},
        {"type": "mask", "opacity": checker,
         "bsdf": {"type": "diffuse", "reflectance": [0.3, 0.8, 0.5]}},
    ]
    d = {"type": "scene",
         "sensor": {"type": "perspective", "fov": 50.0,
                    "to_world": tm.look_at([0, 2.2, 6.5], [0, 0.4, 0], [0, 1, 0]),
                    "film": {"width": 24, "height": 16}}}
    uvs = (sph.vertices[:, :2] * 2.0).astype(np.float32)
    for i, b in enumerate(bsdfs):
        at = np.array([(i % 4) * 1.1 - 1.65, 0.45, (i // 4) * 1.1 - 1.1], np.float32)
        d[f"s{i}"] = {"type": "mesh", "vertices": sph.vertices + at, "faces": sph.faces,
                      "uvs": uvs, "bsdf": b}
    floor = (quad.vertices * 3.0) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    d["floor"] = {"type": "mesh", "vertices": floor, "faces": quad.faces,
                  "bsdf": {"type": "diffuse", "reflectance": checker}}
    down = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    side = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    black = {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]}
    d["light"] = {"type": "mesh", "faces": light.faces, "bsdf": black,
                  "vertices": (light.vertices * 0.8) @ down + np.array([0.5, 3.0, 0.5], np.float32),
                  "emitter": {"type": "area", "radiance": [9.0, 8.0, 6.0]}}
    d["light2"] = {"type": "mesh", "faces": light.faces, "bsdf": black,
                   "vertices": (light.vertices * 0.5) @ side + np.array([-2.5, 1.5, 0.0],
                                                                        np.float32),
                   "emitter": {"type": "area", "radiance": [2.0, 4.0, 6.0]}}
    if env == "envmap":
        img = (0.3 + np.random.default_rng(5).random((8, 16, 3))).astype(np.float32)
        d["env"] = {"type": "envmap", "data": img, "scale": 0.8}
    elif env == "constant":
        d["env"] = {"type": "constant", "radiance": [0.3, 0.35, 0.4]}
    return d


def scene_pair(d):
    """The JAX scene and the port's scene of the same compiled tables."""
    js = jax_load_dict(d)[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


def record_of(scene, chunk=256):
    """The port's record of the whole frame (spp 2, depth 4), padded to a
    multiple of `chunk`, as numpy."""
    w, h = scene.camera.resolution
    n = w * h * SPP
    pad = -(-n // chunk) * chunk
    rec = record_full(scene, SEED, n, spp=SPP, max_depth=DEPTH, rr_depth=RR, pad_to=pad)
    return n, pad, {f: getattr(rec, f).numpy() for f in ("prim", "u", "v", "occl")}


def grads_match_jax(d, modes):
    """replay_grads (the port's plain replay on CPU tensors) against JAX's
    on one record of the scene `d`, for each mode."""
    js, ts = scene_pair(d)
    n, pad, rec = record_of(ts)
    w, h = ts.camera.resolution
    target = np.random.default_rng(0).uniform(0.0, 0.5, (h, w, 3)).astype(np.float32)
    kw = dict(spp=SPP, max_depth=DEPTH, rr_depth=RR, rfilter="box")
    for mode in modes:
        jfn = {"full": jrep.replay_grads_full, "sorted": jrep.replay_grads_sorted}[mode]
        ref = jfn(js, {k: jparams.traverse(js)[k] for k in K5_KEYS}, jparams.update,
                  jnp.asarray(target), SEED, jrep.PathRecord(**{k: jnp.asarray(v)
                                                                for k, v in rec.items()}),
                  n, chunk=pad // 2, **kw)
        got = replay_grads(ts, {k: params.traverse(ts)[k] for k in K5_KEYS}, params.update,
                           torch.as_tensor(target), SEED,
                           PathRecord(**{k: torch.as_tensor(v) for k, v in rec.items()}), n,
                           chunk=pad // 2, mode=mode, **kw)
        for k in K5_KEYS:
            a, b = np.asarray(ref[k]), got[k].numpy()
            assert np.abs(a).max() > 0 and np.isfinite(b).all(), (mode, k)
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4 * np.abs(a).max(),
                                       err_msg=f"{mode} {k}")


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_replay_function_matches_jax_on_cornell(mode):
    grads_match_jax(cornell_sphere(), [mode])


SCENES = {"cornell": cornell_sphere, "kinds": lambda: every_kind(None),
          "kinds_constant": lambda: every_kind("constant"),
          "kinds_envmap": lambda: every_kind("envmap")}
_built: dict = {}


def _chunk_case(name, case):
    """(scene, record chunk, replay arguments) of SCENES[name], each scene
    built and recorded once: the whole frame in camera order, or its rows
    sorted by path length (idx given) and cut to a depth class, as
    replay_grads_sorted hands them over."""
    if name not in _built:
        scene = load_dict(SCENES[name](), device="cpu")[0]
        _built[name] = (scene, *record_of(scene))
    scene, n, pad, rec = _built[name]
    rec = PathRecord(**{k: torch.as_tensor(v) for k, v in rec.items()})
    kw = dict(spp=SPP, max_depth=DEPTH, rr_depth=RR, ray_end=n)
    if case == "sorted":
        order = torch.argsort(-replay.path_lengths(rec), stable=True)[: pad // 2]
        return scene, rec.rows(order), dict(kw, idx=order, n_steps=2)
    return scene, rec, kw


@pytest.fixture(scope="module", params=list(SCENES))
def port_scene(request):
    return request.param


@pytest.mark.parametrize("case", ["frame", "sorted"])
def test_kernel_arithmetic_forward_matches_plain(port_scene, case):
    scene, rec, kw = _chunk_case(port_scene, case)
    ref = replay.replay_radiance_plain(scene, rec, SEED, 0, **kw)[0]
    got = host.forward(scene, rec, SEED, 0, **kw)
    close = torch.isclose(got, ref, rtol=1e-4, atol=1e-5).all(dim=1).float().mean()
    assert float(close) >= 0.9999, float(close)
    assert float(ref.abs().max()) > 0


@pytest.mark.parametrize("case", ["frame", "sorted"])
def test_kernel_arithmetic_adjoint_matches_autograd(port_scene, case):
    scene, rec, kw = _chunk_case(port_scene, case)
    dL = torch.as_tensor(np.random.default_rng(7).normal(size=(rec.prim.shape[0], 3)),
                         dtype=torch.float32)
    p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True) for k in K5_KEYS}
    L = replay.replay_radiance_plain(params.update(scene, p), rec, SEED, 0, **kw)[0]
    ref = torch.autograd.grad((L * dL).sum(), list(p.values()))
    got = host.adjoint(scene, rec, SEED, 0, dL, **kw)
    for k, g, r in zip(K5_KEYS, got, ref):
        r = r.double()
        assert float(r.abs().max()) > 0, k
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4 * float(r.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")


def test_kernel_arithmetic_gives_zero_albedo_channels_their_derivative():
    """A diffuse row with albedo (0.7, 0, 0.4) and a plastic row with
    (0.2, 0.5, 0): the zero channels' derivatives come from the BSDF value
    and weight at 0, with no division by the weight."""
    scene, rec, kw = _chunk_case("kinds_envmap", "frame")
    dL = torch.ones((rec.prim.shape[0], 3))
    d_bc, _ = host.adjoint(scene, rec, SEED, 0, dL, **kw)
    assert float(d_bc[0, 1].abs()) > 0 and float(d_bc[5, 2].abs()) > 0
    assert bool(torch.isfinite(d_bc).all())


def test_function_on_cpu_equals_plain_autograd():
    """On CPU tensors replay_radiance is the plain version: one plain call,
    no K5 launch, and the plain version's L and gradients."""
    scene, rec, kw = _chunk_case("kinds_envmap", "frame")
    dL = torch.as_tensor(np.random.default_rng(3).normal(size=(rec.prim.shape[0], 3)),
                         dtype=torch.float32)
    out = []
    for fn in (replay.replay_radiance, replay.replay_radiance_plain):
        p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True)
             for k in K5_KEYS}
        calls, launches = replay.plain_calls, replay_cuda.forward_launches
        L = fn(params.update(scene, p), rec, SEED, 0, **kw)[0]
        assert replay.plain_calls == calls + 1 and replay_cuda.forward_launches == launches
        out.append((L.detach(), torch.autograd.grad((L * dL).sum(), list(p.values()))))
    (L1, g1), (L2, g2) = out
    assert torch.equal(L1, L2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("key", list(params.PARAM_KEYS))
def test_every_key_differentiates_through_the_cpu_replay(key):
    scene, rec, kw = _chunk_case("kinds", "frame")
    x = params.traverse(scene)[key].detach().clone().requires_grad_(True)
    L = replay.replay_radiance(params.update(scene, {key: x}), rec, SEED, 0, **kw)[0]
    # autograd.grad raises if L does not depend on x; the gradient is not
    # identically 0 (materials.params and camera.to_world get NaN entries
    # where a branch's derivative is 0 * inf, in the plain replay as before)
    (g,) = torch.autograd.grad(L.sum(), [x])
    assert g.shape == x.shape and bool((torch.isnan(g) | (g != 0)).any()), key


@pytest.mark.parametrize("key", ["materials.params", "textures.data", "camera.to_world"])
def test_card_path_raises_for_keys_k5_does_not_differentiate(key, monkeypatch):
    scene, rec, kw = _chunk_case("kinds", "frame")
    monkeypatch.setattr(replay, "_on_card", lambda device: True)
    x = params.traverse(scene)[key].detach().clone().requires_grad_(True)
    with pytest.raises(ValueError, match=key):
        replay.replay_radiance(params.update(scene, {key: x}), rec, SEED, 0, **kw)
    # the two keys K5 differentiates pass the check and go to K5's launch,
    # which refuses these CPU tensors: the card path has no plain fallback
    p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True) for k in K5_KEYS}
    calls = replay.plain_calls
    with pytest.raises(ValueError, match="K5 needs CUDA tensors"):
        replay.replay_radiance(params.update(scene, p), rec, SEED, 0, **kw)
    assert replay.plain_calls == calls


def test_wrapper_refuses_what_k5_does_not_read():
    import dataclasses

    scene, rec, kw = _chunk_case("kinds", "frame")
    bad_kind = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, kinds_present=(0, 11)))
    with pytest.raises(ValueError, match="BSDF kind"):
        replay_cuda.pack_args(bad_kind, rec, SEED, 0, **kw)
    g = scene.geometry
    narrow = dataclasses.replace(scene, geometry=dataclasses.replace(
        g, face_packed=g.face_packed[:, :31].contiguous()))
    with pytest.raises(ValueError, match="face_packed"):
        replay_cuda.pack_args(narrow, rec, SEED, 0, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        replay_cuda.replay_forward(replay_cuda.pack_args(scene, rec, SEED, 0, **kw))
