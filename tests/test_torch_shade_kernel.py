"""K6, the wavefront's shading kernel, on the CPU: its arithmetic
(csrc/shade_lane.h built with g++, tests/torch_replay_host.py) against the
plain `persistent._shade`, the CPU's dispatch, and the wrapper's checks.

  * Bounce by bounce along the wavefront of trace_rays (the plain traversal,
    `_shade`, the shadow rays, the compaction), the header's fields equal
    `_shade`'s bit for bit on every lane where trace_rays reads them: L on
    every lane, `cont` and `active_em` on every lane, the next state (f,
    eta, p, pdf, delta, next_o, next_d) on the `cont` lanes, the NEE term
    and the shadow ray (nee_L, shadow_o, shadow_d, shadow_maxt) on the
    `active_em` lanes.  The scenes: every BSDF kind (masks among them,
    textures, two area lights) with no environment, a constant one and a
    textured envmap, and the bedroom-class stand-in's materials; the walks
    meet escapes, the max_depth cut and lanes at and past rr_depth.
  * The elementary functions are the one place the two may round apart, so
    in that comparison the plain version calls the C library's sinf, cosf,
    acosf, atan2f and powf, and an IEEE square root, as the host build does:
    torch's CPU sqrt is not correctly rounded (on an AVX-512 host it is off
    by one unit in the last place on ~0.6% of inputs), and its sin, cos,
    acos, atan2 and pow round otherwise than glibc's.  With torch's own
    functions the fields are compared as well: the discrete fields (cont,
    active_em, delta) must still agree on every lane, the floats on at
    least 0.9 of the lanes bit for bit and on all within rtol 1e-4 / atol
    1e-6: a last-place difference of sin, cos or sqrt in a sampled
    direction, carried through the GGX density (the 1 / t^2 of its D) into
    pdf and the next direction, reaches 6e-5 relative.
  * On CPU tensors trace_rays keeps the plain `_shade` (no K6 launch, and
    `m3t.shade.kernel_lanes` stays 0 of `m3t.shade.lanes`), and its radiance
    and record equal, bit for bit, those of the benchmark reference's
    frozen copy of the parent's wavefront (benchmark/reference/trace.py,
    copied at aa7dcd9) fed the port's own ray queries.
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_replay_host as host
from benchmark.reference import trace as frozen_trace
from mitsuba3_experiments_tpu_torch.core.records import Ray
from mitsuba3_experiments_tpu_torch.integrators import PathRecord, persistent, shade_cuda
from mitsuba3_experiments_tpu_torch.intersect.bvh_torch import _query
from mitsuba3_experiments_tpu_torch.render import sensor as sensorlib
from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict
from mitsuba3_experiments_tpu_torch.scene.types import BSDFKind
from mitsuba3_experiments_tpu_torch.utils import profile as prof_mod
from test_torch_replay_kernel import every_kind

torch.set_num_threads(2)

SEED, SPP, DEPTH, RR = 3, 4, 6, 2
SCENES = {"kinds": lambda: every_kind(None), "kinds_constant": lambda: every_kind("constant"),
          "kinds_envmap": lambda: every_kind("envmap"),
          "standin": lambda: standin_dict(res=(24, 16), spp=SPP, tri_budget=2_000)}
# where trace_rays reads each field of _shade: every lane, or the lanes that go on
# (`cont`) or shoot a shadow ray (`active_em`)
READ_ON = {"L": None, "cont": None, "active_em": None,
           "f": "cont", "eta": "cont", "p": "cont", "pdf": "cont", "delta": "cont",
           "next_o": "cont", "next_d": "cont",
           "nee_L": "active_em", "shadow_o": "active_em", "shadow_d": "active_em",
           "shadow_maxt": "active_em"}
_scenes: dict = {}


def _scene(name):
    if name not in _scenes:
        _scenes[name] = load_dict(SCENES[name](), device="cpu")[0]
    return _scenes[name]


@pytest.fixture
def c_library_functions(monkeypatch):
    """The plain version's sqrt, sin, cos, arccos, atan2 and float `**` on
    float32 tensors computed by the C library's functions (sqrt: numpy's,
    IEEE), element by element, as the host build computes them."""
    libm = ctypes.CDLL("libm.so.6")

    def c_fn(name, arity):
        fn = getattr(libm, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * arity
        return np.frompyfunc(lambda *xs: fn(*map(float, xs)), arity, 1)

    def elementwise(orig, fn):
        def call(*args, **kwargs):
            if kwargs or not all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
                                 for x in args):
                return orig(*args, **kwargs)
            arrs = np.broadcast_arrays(*(x.numpy() for x in args))
            return torch.from_numpy(np.asarray(fn(*arrs), dtype=np.float32).reshape(arrs[0].shape))
        return call

    for name, c_name, arity in (("sin", "sinf", 1), ("cos", "cosf", 1),
                                ("arccos", "acosf", 1), ("atan2", "atan2f", 2)):
        monkeypatch.setattr(torch, name, elementwise(getattr(torch, name), c_fn(c_name, arity)))
    monkeypatch.setattr(torch, "sqrt", elementwise(torch.sqrt, np.sqrt))
    powf, pow_ = c_fn("powf", 2), torch.Tensor.__pow__

    def power(x, e):
        if x.dtype != torch.float32 or not isinstance(e, (int, float)):
            return pow_(x, e)
        return torch.from_numpy(np.asarray(powf(x.numpy(), np.float32(e)),
                                           dtype=np.float32).reshape(x.shape))

    monkeypatch.setattr(torch.Tensor, "__pow__", power)


def _walk(scene, check):
    """trace_rays' wavefront over every camera ray of the frame in one
    batch, with `_shade`; `check(bounce, lanes, sh)` at each bounce.
    Returns what the walk met: the shaded kinds and the lane classes."""
    w, h = scene.camera.resolution
    n = w * h * SPP
    idx = torch.arange(n, dtype=torch.int64)
    ray = sensorlib.sample_ray(scene.camera, persistent.ray_positions(scene.camera, SEED, idx,
                                                                      SPP))
    o, d = ray.o.contiguous(), ray.d.contiguous()
    L, f = torch.zeros((n, 3)), torch.ones((n, 3))
    eta, prev_pdf = torch.ones(n), torch.ones(n)
    depth = torch.ones(n, dtype=torch.int32)
    prev_p, prev_delta = o, torch.ones(n, dtype=torch.bool)
    met = {"kinds": set(), "escapes": 0, "cut": 0, "roulette": 0, "bounces": 0}
    mats = scene.materials
    while n:
        every = torch.ones(n, dtype=torch.bool)
        t, face, u, v = _query(scene, Ray.make(o, d), every, False)
        lanes = (d, t, face, u, v, L, f, eta, depth, prev_p, prev_pdf, prev_delta, idx)
        sh = persistent._shade(scene, SEED, every, o, *lanes[:9], prev_p, prev_pdf, prev_delta,
                               idx, max_depth=DEPTH, rr_depth=RR)
        check(met["bounces"], lanes, sh)
        hit = face >= 0
        mid = scene.geometry.face_packed[face[hit].long(), 25].contiguous().view(torch.int32)
        shaded = mid[depth[hit] < DEPTH].long()
        met["kinds"] |= set(mats.kind[shaded].tolist()) | set(
            mats.kind[mats.nested_id[shaded].long().clamp(min=0)].tolist())
        met["escapes"] += int((~hit).sum())
        met["cut"] += int((hit & (depth == DEPTH)).sum())
        met["roulette"] += int((hit & (depth >= RR) & (depth < DEPTH) & ~sh.cont).sum())
        met["bounces"] += 1
        em = torch.nonzero(sh.active_em).squeeze(1)
        unoccluded = sh.active_em.clone()
        if em.numel():
            shadow = Ray(o=sh.shadow_o[em], d=sh.shadow_d[em], maxt=sh.shadow_maxt[em])
            unoccluded[em] = _query(scene, shadow, every[:em.numel()], True)[1] < 0
        L = sh.L + torch.where(unoccluded[:, None], sh.nee_L, 0.0)
        keep = torch.nonzero(sh.cont).squeeze(1)
        n = keep.numel()
        idx, L = idx[keep], L[keep]
        o, d = sh.next_o[keep], sh.next_d[keep]
        f, eta, depth = sh.f[keep], sh.eta[keep], depth[keep] + 1
        prev_p, prev_pdf, prev_delta = sh.p[keep], sh.pdf[keep], sh.delta[keep]
    return met


def _read(field, x, sh):
    """The lanes of `field` that trace_rays reads, as raw bits."""
    if READ_ON[field] is not None:
        x = x[getattr(sh, READ_ON[field])]
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_arithmetic_equals_plain_shade_bit_for_bit(name, c_library_functions):
    scene = _scene(name)
    fields = {}

    def check(bounce, lanes, sh):
        got = host.shade(scene, SEED, lanes, max_depth=DEPTH, rr_depth=RR)
        for field in READ_ON:
            a, b = _read(field, got[field], sh), _read(field, getattr(sh, field), sh)
            fields[field] = fields.get(field, 0) + b.shape[0]
            assert torch.equal(a, b), (name, bounce, field, int((a != b).sum()))

    met = _walk(scene, check)
    kinds = set(range(BSDFKind.COUNT)) if name.startswith("kinds") else \
        set(scene.materials.kinds_present)
    assert met["kinds"] >= kinds, (name, sorted(kinds - met["kinds"]))
    # the stand-in's room closes around the camera: no path escapes there
    assert met["cut"] and met["roulette"] and (met["escapes"] or name == "standin"), (name, met)
    assert min(fields.values()) > 0, (name, fields)


@pytest.mark.parametrize("name", ["kinds_envmap", "standin"])
def test_kernel_arithmetic_with_torch_functions(name):
    scene = _scene(name)
    exact, lanes_read = {}, {}

    def check(bounce, lanes, sh):
        got = host.shade(scene, SEED, lanes, max_depth=DEPTH, rr_depth=RR)
        for field in READ_ON:
            a, b = got[field], getattr(sh, field)
            if READ_ON[field] is not None:
                a, b = a[getattr(sh, READ_ON[field])], b[getattr(sh, READ_ON[field])]
            if b.dtype == torch.bool:
                assert torch.equal(a, b), (name, bounce, field)
                continue
            same = a.view(torch.int32) == b.view(torch.int32)
            same = same.all(1) if same.dim() > 1 else same
            exact[field] = exact.get(field, 0) + int(same.sum())
            lanes_read[field] = lanes_read.get(field, 0) + b.shape[0]
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=f"{name} {field}")

    _walk(scene, check)
    for field, n in lanes_read.items():
        assert exact[field] >= 0.9 * n, (name, field, exact[field], n)


def _frozen_query(scene):
    def query(o, d, maxt, any_hit):
        return _query(scene, Ray(o=o, d=d, maxt=maxt),
                      torch.ones(o.shape[0], dtype=torch.bool), any_hit)
    return SimpleNamespace(scene=scene, rounded=False, query=query)


@pytest.mark.parametrize("name", ["kinds_envmap", "standin"])
def test_trace_rays_on_cpu_keeps_plain_shade_and_the_parents_results(name, monkeypatch):
    scene = _scene(name)
    w, h = scene.camera.resolution
    n = w * h * SPP
    calls = []
    shade = persistent._shade

    def counted(scene, seed, doneA, *a, **k):
        calls.append(doneA.shape[0])
        return shade(scene, seed, doneA, *a, **k)

    monkeypatch.setattr(persistent, "_shade", counted)
    launches = shade_cuda.launches
    rec = PathRecord.empty(n, DEPTH, "cpu")
    prof_mod.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        rayL = persistent.trace_rays(scene, SEED, 0, n, n, spp=SPP, max_depth=DEPTH,
                                     rr_depth=RR, rec=rec, n_lanes=n // 2)
    counts = prof_mod.drain()
    assert shade_cuda.launches == launches and len(calls) > 2
    assert counts["m3t.shade.lanes"] == sum(calls) and "m3t.shade.kernel_lanes" not in counts
    ref_rec = PathRecord.empty(n, DEPTH, "cpu")
    ref_L = frozen_trace(_frozen_query(scene), SEED, torch.arange(n), spp=SPP, max_depth=DEPTH,
                         rr_depth=RR, rec=ref_rec)
    assert torch.equal(rayL, ref_L) and float(rayL.abs().max()) > 0
    for f in ("prim", "u", "v", "occl"):
        assert torch.equal(getattr(rec, f), getattr(ref_rec, f)), f


def test_wrapper_refuses_what_k6_does_not_take():
    import dataclasses

    scene = _scene("kinds")
    n = 4
    lanes = [torch.zeros((n, c) if c == 3 else (n,), dtype=dt)
             for _, dt, c in shade_cuda.LANE_IN]
    packed = shade_cuda.pack_scene(scene, SEED, max_depth=DEPTH, rr_depth=RR)
    with pytest.raises(ValueError, match="K6 needs CUDA tensors"):
        shade_cuda.shade(packed, *lanes)
    bad = list(lanes)
    bad[2] = bad[2].to(torch.int64)                     # face
    with pytest.raises(TypeError, match="face"):
        shade_cuda.bind_lanes(packed, bad)
    bad = list(lanes)
    bad[0] = torch.zeros((3, n)).t()                    # d, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        shade_cuda.bind_lanes(packed, bad)
    with pytest.raises(ValueError, match="BSDF kind"):
        shade_cuda.pack_scene(dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, kinds_present=(0, 11))), SEED, max_depth=DEPTH, rr_depth=RR)
    assert shade_cuda.pack_scene(scene, SEED, max_depth=DEPTH, rr_depth=RR).args.scene.prim \
        is None
