#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (mitsuba3_experiments_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

 1. needs a CUDA card; prints `nvidia-smi`'s name and power limit;
 2. builds the BVH8 traversal kernel from csrc/bvh_traverse.cu (nvcc);
 3. holds the kernel against its plain torch version on the same 65,536
    seeded rays, closest hit and any hit, into a 100k-triangle blob and the
    ~2M-triangle bedroom-class stand-in: closest-hit faces must be equal and
    t/u/v allclose (rtol 1e-6, atol 1e-7); any-hit hit/miss equal;
 4. the main path: load_dict(standin_dict()) at 1280x720, spp 4, then
    render(scene, PathIntegrator(max_depth=8, rr_depth=4), spp=4,
    rfilter="tent") — the image must be finite with a mean above 0, the
    kernel must have launched, the plain traversal must not have run;
 5. the render's own queries at full size: the first pass of that render
    (1280x720x2 = 1,843,200 lanes) is run again through `render`, and every
    traversal it launches (camera rays, bounce rays, NEE shadow rays) is
    held against the plain version on the same tensors, as in phase 3;
 6. a small reference render (Cornell box + a 4k-triangle sphere, 32x32,
    spp 2, depth 4) on the card must agree with the same render on the CPU,
    whose plain path the CPU tests hold against the JAX package.

The kernels' JSON line gives the kernel's and the plain version's times on
the render's camera batch (phase 5); phase 3 prints them at 65,536 rays.

The last two lines of standard output are the kernels' JSON line and the
result line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_RAYS = 65_536
RES = (1280, 720)
SPP = 4
MAX_DEPTH = 8
REPLACES = "mitsuba3_experiments_tpu/intersect/bvh_pallas.py:259"
SOURCE = "mitsuba3_experiments_tpu_torch/csrc/bvh_traverse.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_rays(seed, lo, hi, tgt_lo, tgt_hi, device):
    """Rays from uniform points in [lo, hi] towards uniform points in
    [tgt_lo, tgt_hi]; half with a finite maxt; every 17th lane inactive."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    tgt = rng.uniform(tgt_lo, tgt_hi, (N_RAYS, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.random(N_RAYS) < 0.5, np.inf, rng.uniform(0.1, 3.0, N_RAYS))
    active = np.ones(N_RAYS, bool)
    active[::17] = False

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return (t(o, torch.float32), t(d.astype(np.float32), torch.float32),
            t(maxt.astype(np.float32), torch.float32), t(active, torch.bool))


def cuda_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold(name, kernel_out, plain_out, any_hit, n_active):
    """Checks the kernel's (t, face, u, v) against the plain version's on
    the same rays; returns the max abs error of t/u/v (closest hit)."""
    import torch

    tk, fk, uk, vk = kernel_out
    tp, fp, up, vp = plain_out
    n = fp.shape[0]
    hits = int((fp >= 0).sum())
    if any_hit:
        diff = int(((fk >= 0) != (fp >= 0)).sum())
        print(f"[{name}] any hit: {hits} occluded of {n} ({n_active} active), "
              f"hit/miss mismatches {diff}")
        check(diff == 0, f"{name}: any-hit hit/miss differs on {diff} rays")
        return 0.0
    diff = int((fk != fp).sum())
    print(f"[{name}] closest hit: {hits} hits of {n} ({n_active} active), "
          f"face mismatches {diff}")
    check(diff == 0, f"{name}: closest-hit faces differ on {diff} rays")
    h = fp >= 0
    check(bool(torch.equal(torch.isinf(tk), torch.isinf(tp))), f"{name}: t inf pattern differs")
    err = 0.0
    for label, a, c in (("t", tk[h], tp[h]), ("u", uk, up), ("v", vk, vp)):
        check(torch.allclose(a, c, rtol=1e-6, atol=1e-7), f"{name}: {label} not allclose")
        err = max(err, float((a - c).abs().max()) if a.numel() else 0.0)
    return err


def compare_kernel(name, scene, rays, timing):
    """Kernel vs plain on one scene, closest and any hit; returns
    (max_abs_err, kernel ms, plain ms), the times only when `timing`."""
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch

    b = scene.bvh
    args = (b.unified, b.nodes.shape[0], *rays)
    n_active = int(rays[3].sum())
    err = 0.0
    for any_hit in (False, True):
        out_k = bvh_cuda.traverse_cuda(*args, any_hit=any_hit, layout=b.layout)
        out_p = bvh_torch.traverse_plain(*args, any_hit=any_hit, layout=b.layout)
        err = max(err, hold(name, out_k, out_p, any_hit, n_active))
    if not timing:
        return err, None, None
    for _ in range(2):
        bvh_cuda.traverse_cuda(*args, layout=b.layout)
    k_ms = cuda_ms(lambda: bvh_cuda.traverse_cuda(*args, layout=b.layout), 10)
    p_ms = cuda_ms(lambda: bvh_torch.traverse_plain(*args, layout=b.layout), 1)
    print(f"[{name}] closest hit, {N_RAYS} rays: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms")
    return err, k_ms, p_ms


def render_queries(scene, integrator):
    """Runs the first pass of the smoke render (seed 0, pass 0, the same
    1280x720x2 wavefront) through `render` and returns every traversal it
    made: [(args, kwargs, kernel outputs)], in launch order."""
    from mitsuba3_experiments_tpu_torch.integrators import render
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda

    launch = bvh_cuda.traverse_cuda
    made = []

    def recording(*args, **kwargs):
        out = launch(*args, **kwargs)
        made.append((args, kwargs, out))
        return out

    bvh_cuda.traverse_cuda = recording
    try:
        render(scene, integrator, spp=SPP // 2, spp_per_pass=SPP // 2, rfilter="tent")
    finally:
        bvh_cuda.traverse_cuda = launch
    return made


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
    from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict, standin_dict
    from mitsuba3_experiments_tpu_torch.scene import flagship, mesh as meshlib

    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    so = bvh_cuda.build()
    print(f"[build] {so}: {time.perf_counter() - t0:.2f} s")
    with open(so + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # ---- phase 3: kernel against plain ------------------------------------
    blob = flagship.placeholder_mesh(7, 100_000)
    t0 = time.perf_counter()
    blob_scene, _ = load_dict({
        "type": "scene",
        "blob": {"type": "mesh", "vertices": blob.vertices, "faces": blob.faces,
                 "uvs": blob.uvs, "bsdf": {"type": "diffuse"}},
    }, device=dev)
    print(f"[blob] {blob_scene.n_faces} triangles, build {time.perf_counter() - t0:.2f} s")
    vlo, vhi = blob.vertices.min(0), blob.vertices.max(0)
    ctr, ext = (vlo + vhi) / 2, (vhi - vlo)
    err_a, _, _ = compare_kernel(
        "blob", blob_scene,
        seeded_rays(1, ctr - 2 * ext, ctr + 2 * ext, ctr - 0.3 * ext, ctr + 0.3 * ext, dev),
        timing=False,
    )

    t0 = time.perf_counter()
    scene, _ = load_dict(standin_dict(res=RES, spp=SPP), device=dev)
    build_s = time.perf_counter() - t0
    print(f"[standin] {scene.n_faces} triangles, {scene.bvh.unified.shape[0]} BVH rows "
          f"({scene.bvh.unified.numel() * 4 / 1e6:.1f} MB), build {build_s:.2f} s")
    err_b, _, _ = compare_kernel(
        "standin", scene,
        seeded_rays(2, flagship._ROOM_LO + 0.1, flagship._ROOM_HI - 0.1,
                    flagship._BLOB_LO, flagship._BLOB_HI, dev),
        timing=True,
    )

    # ---- phase 4: the main path -------------------------------------------
    integrator = PathIntegrator(max_depth=MAX_DEPTH, rr_depth=4)
    torch.cuda.synchronize()
    bvh_cuda.launches = 0
    bvh_torch.calls = 0
    t0 = time.perf_counter()
    img = render(scene, integrator, spp=SPP, rfilter="tent")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = bvh_cuda.launches
    plain_calls = bvh_torch.calls
    w, h = RES
    check(tuple(img.shape) == (h, w, 3), f"image shape {tuple(img.shape)}")
    img_np = img.cpu().numpy()
    check(bool(np.isfinite(img_np).all()), "image has non-finite values")
    check(float(img_np.mean()) > 0.0, "image mean is not above 0")
    check(launches > 0, "the render did not launch the traversal kernel")
    check(plain_calls == 0, f"the render ran the plain traversal {plain_calls} times")
    rays_s = w * h * SPP / render_s
    print(f"[render] {w}x{h} spp {SPP} depth {MAX_DEPTH} tent: {render_s:.3f} s, "
          f"{rays_s:.1f} camera rays/s, kernel launches {launches}, plain calls {plain_calls} "
          f"({card})")
    print(f"[render] image mean {img_np.mean():.6f} min {img_np.min():.6f} max {img_np.max():.6f}")
    os.makedirs("out", exist_ok=True)
    np.save(os.path.join("out", "chip_smoke_render.npy"), img_np)

    # ---- phase 5: the render's own queries against plain, at full size ----
    made = render_queries(scene, integrator)
    check(len(made) >= 3, f"the first pass made only {len(made)} traversals")
    err_c = 0.0
    plain_s = []
    for i, (args, kw, out_k) in enumerate(made):
        kind = "camera" if i == 0 else ("shadow" if kw["any_hit"] else "bounce")
        t0 = time.perf_counter()
        out_p = bvh_torch.traverse_plain(*args, any_hit=kw["any_hit"], layout=kw["layout"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        plain_s.append(dt)
        err_c = max(err_c, hold(f"pass0 #{i} {kind}", out_k, out_p, kw["any_hit"],
                                int(args[5].sum())))
        print(f"[pass0 #{i} {kind}] plain {dt:.2f} s")
    args, kw, _ = made[0]
    n_main = args[2].shape[0]
    for _ in range(2):
        bvh_cuda.traverse_cuda(*args, **kw)
    k_main_ms = cuda_ms(lambda: bvh_cuda.traverse_cuda(*args, **kw), 5)
    p_main_ms = plain_s[0] * 1e3   # the comparison's own plain call, synchronized
    print(f"[pass0] {len(made)} traversals of {n_main} rays held against plain "
          f"({sum(plain_s):.1f} s of plain); camera batch: kernel {k_main_ms:.4f} ms, "
          f"plain {p_main_ms:.3f} ms ({card})")
    del made

    # ---- phase 6: small reference render, card vs CPU ----------------------
    d = cornell_box(res=32, spp=2)
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=32, n_phi=64)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    small = PathIntegrator(max_depth=4)
    ref = render(load_dict(d)[0], small, spp=2).numpy()
    got = render(load_dict(d, device=dev)[0], small, spp=2).cpu().numpy()
    rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
    close = float(np.isclose(got, ref, rtol=1e-3, atol=1e-4).mean())
    print(f"[reference] 32x32 cornell+sphere: mean card {got.mean():.6f} cpu {ref.mean():.6f} "
          f"(rel {rel:.2e}), pixels within rtol 1e-3/atol 1e-4: {close:.4f}")
    check(rel < 1e-3, f"card and CPU image means differ by {rel:.2e}")
    check(close >= 0.99, f"only {close:.4f} of the pixels agree with the CPU render")

    print(json.dumps({"kernels": [{
        "name": "bvh8_traverse", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err_a, err_b, err_c), "ms": k_main_ms, "plain_ms": p_main_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
