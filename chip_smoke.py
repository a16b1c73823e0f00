#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (mitsuba3_experiments_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

 1. needs a CUDA card; prints `nvidia-smi`'s name and power limit;
 2. builds the three kernels, one nvcc each, all started together: K1 the
    BVH8 traversal (csrc/bvh_traverse.cu), K2 the fused MLP
    (csrc/fused_mlp.cu), K3 the blocked scan (csrc/prefix_sum.cu); prints
    their ptxas lines;
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
    whose plain path the CPU tests hold against the JAX package;
 7. K2 against its plain version (apply_mlp) on the field's real inputs at
    full width: FieldConfig() (sizes 32-64-64-64-3), init_field from a
    seeded torch.Generator, hashgrid_encode + sh_eval features of 524,288
    seeded points and directions (the RHS batch of a training step):
    allclose at rtol 2e-2 / atol 2e-2, and at least 99% of the rows equal
    to 1e-5; both timed with CUDA events;
 8. the neural-radiosity path on phase 3's stand-in: NeradTrainer() at its
    defaults (batch 16,384, m_rhs 32: 524,288 RHS lanes; lr 1e-3) with
    FieldConfig(fused=True), 50 steps — every loss finite, the mean of the
    last 10 below the mean of the first 10; K1 and K2 launched, the plain
    MLP forward (apart from the backward's recompute) and plain traversal
    run 0 times; then render(scene, NeradIntegrator(trainer, field), spp=1)
    at 1280x720 — the image finite with a mean above 0, K2 launched; then
    phase 7's check again on the trained field, whose biases and hash grid
    are no longer those of init_field (zero biases, grid features ~1e-4);
 9. K3's path, the ops entry point ops.prefix_sum_blocked, driven as a
    caller would on int32 at 1,843,200 (the render's wavefront) and 2^26
    elements, float32 uniform in [0, 1) at the same sizes, and the
    stand-in's 1,964,564 face areas (the nerad area distribution's
    weights): K3 launched once per call and the plain scan never; each
    result against its plain version (torch.cumsum) — int32 exactly equal,
    float32 within rtol 1e-4 of a float64 cumsum;
10. one nerad step on the card against the same step on the CPU (Cornell
    box + a 4k-triangle sphere, a small fused field, batch 1,024, m_rhs 8),
    from the same parameters: losses within rtol 1e-3, MLP gradients within
    rtol 2e-2 / atol 1e-5.

Each kernel's counts are set to 0 just before the path that runs it and
read just after: K1's from the render of phase 4, K2's from the training
of phase 8, K3's from the ops entry point of phase 9 (no path of the
renderer or trainer scans: the CDFs are built on the host, as in the JAX
package).  The kernels' JSON line gives each kernel's and its
plain version's times at the main path's shapes: K1 on the render's camera
batch (phase 5; phase 3 prints them at 65,536 rays), K2 on 524,288 field
rows (phase 7), K3 on the stand-in's 1,964,564 face areas (phase 9).

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
K2_REPLACES = "mitsuba3_experiments_tpu/models/pallas_mlp.py:28"
K2_SOURCE = "mitsuba3_experiments_tpu_torch/csrc/fused_mlp.cu"
K3_REPLACES = "mitsuba3_experiments_tpu/ops/prefix_sum.py:26"
K3_SOURCE = "mitsuba3_experiments_tpu_torch/csrc/prefix_sum.cu"
FIELD_ROWS = 524_288       # NeradTrainer() RHS lanes: 16,384 x 32
TRAIN_STEPS = 50
SCAN_SIZES = (1_843_200, 1 << 26)


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


def build_all():
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda
    from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    libs = [bvh_cuda.LIBRARY, fused_mlp_cuda.LIBRARY, prefix_sum_cuda.LIBRARY]
    t0 = time.perf_counter()

    def build(lib):
        start = time.perf_counter()
        return lib.build(), time.perf_counter() - start

    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(build, libs))
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for so, dt in built:
        print(f"[build] {so}: {dt:.2f} s")
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[build] {line.strip()}")
    for lib in libs:
        lib.load()


def field_inputs(field, cfg, n, device, seed=11):
    """hashgrid_encode + sh_eval features (n, 32) of n seeded points and
    unit directions: the MLP's input in field_eval."""
    import torch

    from mitsuba3_experiments_tpu_torch.core.sh import sh_eval
    from mitsuba3_experiments_tpu_torch.models import hashgrid_encode

    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.random((n, 3), dtype=np.float32), device=device)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with torch.no_grad():
        feat_p = hashgrid_encode(field.grid, p, cfg.grid)
        feat_d = sh_eval(torch.as_tensor(d, device=device), cfg.sh_order)
        return torch.cat([feat_p, feat_d], dim=-1).float().contiguous()


def phase_k2(device, card, field, cfg, label, timing, n=FIELD_ROWS):
    """Phase 7 (and its repeat after phase 8): K2 against apply_mlp on the
    inputs `field` gives its MLP; returns (max_abs_err, kernel ms, plain
    ms), the times only when `timing`."""
    import torch

    from mitsuba3_experiments_tpu_torch.models import apply_mlp, fused_mlp, fused_mlp_cuda

    with torch.no_grad():
        h = field_inputs(field, cfg, n, device)
        flat = tuple(t.detach() for t in fused_mlp.mlp_params_flat(field.mlp))
        sizes = (h.shape[1],) + tuple(w.shape[1] for w in flat[0::2])
        params = [{"w": w, "b": b} for w, b in zip(flat[0::2], flat[1::2])]

        def kernel():
            return fused_mlp_cuda.fused_mlp_cuda(flat, h, sizes, "leaky_relu", cfg.fused_tile)

        def plain():
            return apply_mlp(params, h)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        check(tuple(got.shape) == (n, 3), f"K2 output shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "K2 output is not finite")
        err = float((got - ref).abs().max())
        close = float(torch.isclose(got, ref, rtol=1e-5, atol=1e-5).all(dim=1).float().mean())
        biases = max(float(b.abs().max()) for b in flat[1::2])
        g = cfg.grid.out_dim
        print(f"[K2 {label}] {n} rows, sizes {sizes}, tile {cfg.fused_tile}: max abs err "
              f"{err:.3e}, rows equal to 1e-5: {close:.6f}; largest |grid feature| "
              f"{float(h[:, :g].abs().max()):.3e}, |SH feature| {float(h[:, g:].abs().max()):.3e}, "
              f"|bias| {biases:.3e}")
        check(bool(torch.allclose(got, ref, rtol=2e-2, atol=2e-2)),
              f"K2 ({label}) differs from apply_mlp (max abs err {err:.3e})")
        check(close >= 0.99, f"K2 ({label}): only {close:.6f} of the rows equal apply_mlp's")
        if not timing:
            return err, None, None
        for _ in range(3):
            kernel(), plain()
        k_ms = cuda_ms(kernel, 20)
        p_ms = cuda_ms(plain, 20)
    print(f"[K2 {label}] kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
    return err, k_ms, p_ms


def counters():
    """(name, module, attribute) of every launch and plain-call count."""
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
    from mitsuba3_experiments_tpu_torch.models import fused_mlp, fused_mlp_cuda, mlp
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    return (("k1", bvh_cuda, "launches"), ("plain_traverse", bvh_torch, "calls"),
            ("k2", fused_mlp_cuda, "launches"), ("plain_mlp", mlp, "calls"),
            ("recomputes", fused_mlp, "recomputes"), ("k3", prefix_sum_cuda, "launches"),
            ("plain_scan", prefix_sum_cuda, "plain_calls"))


def reset_counts():
    for _, mod, attr in counters():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for name, mod, attr in counters()}


def phase_nerad(scene, card, trainer, steps=TRAIN_STEPS):
    """Phase 8: nerad training then rendering on `scene` through the
    port's entry points; returns (training counts, render counts, the
    trained field)."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import render
    from mitsuba3_experiments_tpu_torch.models import NeradIntegrator

    sync = torch.cuda.synchronize if scene.device.type == "cuda" else (lambda: None)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    init, step = trainer.make_train_step(scene)
    params, opt = init(torch.Generator().manual_seed(0))
    sync()
    setup_s = time.perf_counter() - t0
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(params, opt, i))
        sync()
        step_s.append(time.perf_counter() - t0)
    train = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    n_rhs = trainer.batch_size * trainer.m_rhs
    med = float(np.median(step_s[10:])) if steps > 10 else float(np.median(step_s))
    print(f"[nerad] train setup {setup_s:.3f} s; {steps} steps of batch {trainer.batch_size} "
          f"({n_rhs} RHS lanes): median step (last {max(steps - 10, 1)}) {med:.4f} s, "
          f"first step {step_s[0]:.4f} s ({card})")
    print(f"[nerad] losses first {losses[:3].tolist()} last {losses[-3:].tolist()}")
    print(f"[nerad] training counts {train}")
    check(bool(np.isfinite(losses).all()), "a nerad loss is not finite")
    k = min(10, steps // 2)
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())
    print(f"[nerad] mean loss of the first {k} steps {first:.6f}, of the last {k} {last:.6f}")
    check(last < first, "nerad training did not lower the loss")
    check(train["k1"] > 0 and train["k2"] > 0, "nerad training did not launch K1 and K2")
    check(train["plain_traverse"] == 0, "nerad training ran the plain traversal")
    check(train["plain_mlp"] == train["recomputes"] == 2 * steps,
          "nerad training ran the plain MLP forward outside the backward's recompute")

    w, h = scene.camera.resolution
    sync()
    reset_counts()
    t0 = time.perf_counter()
    img = render(scene, NeradIntegrator(trainer, params), spp=1)
    sync()
    render_s = time.perf_counter() - t0
    rend = read_counts()
    img_np = img.cpu().numpy()
    print(f"[nerad] render {w}x{h} spp 1: {render_s:.3f} s, image mean {img_np.mean():.6f}, "
          f"counts {rend} ({card})")
    check(tuple(img_np.shape) == (h, w, 3), f"nerad image shape {img_np.shape}")
    check(bool(np.isfinite(img_np).all()), "the nerad image has non-finite values")
    check(float(img_np.mean()) > 0.0, "the nerad image mean is not above 0")
    check(rend["k2"] > 0, "the nerad render did not launch K2")
    check(rend["plain_mlp"] == 0 and rend["plain_traverse"] == 0,
          "the nerad render ran a plain MLP forward or traversal")
    return train, rend, params


def phase_k3(device, card, areas, sizes=SCAN_SIZES):
    """Phase 9: K3's path, the ops entry point, then each result against
    torch.cumsum; returns (launches, max abs err of the float32 cases
    against the plain scan, kernel ms, plain ms on the face areas)."""
    import torch

    from mitsuba3_experiments_tpu_torch import ops
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    g = torch.Generator(device=device).manual_seed(9)
    err = 0.0
    cases = [(f"int32 n={n}", torch.randint(-2**30, 2**30, (n,), generator=g, device=device,
                                            dtype=torch.int32)) for n in sizes]
    cases += [(f"float32 n={n}", torch.rand((n,), generator=g, device=device)) for n in sizes]
    cases += [(f"face areas n={areas.shape[0]}", areas)]
    torch.cuda.synchronize()
    reset_counts()
    outs = [ops.prefix_sum_blocked(x) for _, x in cases]
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[K3] ops.prefix_sum_blocked on {len(cases)} inputs: counts {counts}")
    check(counts["k3"] == len(cases) and counts["plain_scan"] == 0,
          "ops.prefix_sum_blocked did not launch K3 once per call")
    for (name, x), got in zip(cases, outs):
        ref = ops.prefix_sum(x)
        torch.cuda.synchronize()
        if x.dtype == torch.int32:
            diff = int((got != ref).sum())
            print(f"[K3] {name}: {diff} elements differ from torch.cumsum")
            check(diff == 0, f"K3 {name} differs from torch.cumsum on {diff} elements")
            continue
        ref64 = torch.cumsum(x.double(), 0)
        rel = float(((got.double() - ref64).abs() / ref64.abs().clamp(min=1e-30)).max())
        rel_p = float(((ref.double() - ref64).abs() / ref64.abs().clamp(min=1e-30)).max())
        e = float((got - ref).abs().max())
        err = max(err, e)
        print(f"[K3] {name}: max rel err vs float64 kernel {rel:.3e}, plain {rel_p:.3e}; "
              f"max abs err kernel vs plain {e:.3e}")
        check(bool(torch.allclose(got.double(), ref64, rtol=1e-4, atol=0.0)),
              f"K3 {name} is not within rtol 1e-4 of a float64 cumsum")
    for name, x in cases:
        k_ms = cuda_ms(lambda: prefix_sum_cuda.scan_cuda(x), 20)
        p_ms = cuda_ms(lambda: ops.prefix_sum(x), 20)
        print(f"[K3] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
    return counts["k3"], err, k_ms, p_ms


def small_nerad_scene(device):
    """Cornell box + a 4k-triangle sphere (above the brute-force threshold,
    so ray queries go through the BVH)."""
    from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict
    from mitsuba3_experiments_tpu_torch.scene import mesh as meshlib

    d = cornell_box(res=32, spp=2)
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=32, n_phi=64)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    return load_dict(d, device=device)[0]


def small_trainer():
    from mitsuba3_experiments_tpu_torch.models import FieldConfig, HashGridConfig, NeradTrainer

    cfg = FieldConfig(grid=HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                          finest_resolution=64),
                      width=32, depth=3, fused=True, fused_tile=128)
    return NeradTrainer(field_cfg=cfg, batch_size=1024, m_rhs=8)


def nerad_step_on(device, trainer, tree):
    """One training step on `device` from the parameters `tree`; returns
    (loss, MLP gradients as numpy arrays)."""
    import torch

    from mitsuba3_experiments_tpu_torch.models.convert import field_params_from_numpy

    scene = small_nerad_scene(device)
    _, step = trainer.make_train_step(scene)
    field = field_params_from_numpy(tree, device)
    opt = torch.optim.Adam(field.parameters(), lr=trainer.lr)
    loss = float(step(field, opt, 0))
    grads = [p.grad.cpu().numpy() for l in field.mlp for p in (l["w"], l["b"])]
    return loss, grads


def phase_card_vs_cpu(device):
    """Phase 10: one nerad step on the card and on the CPU, from the same
    parameters."""
    import torch

    from mitsuba3_experiments_tpu_torch.models import init_field
    from mitsuba3_experiments_tpu_torch.models.convert import field_params_to_numpy

    trainer = small_trainer()
    with torch.no_grad():
        tree = field_params_to_numpy(init_field(torch.Generator().manual_seed(3),
                                                trainer.field_cfg))
    loss_c, grads_c = nerad_step_on(device, trainer, tree)
    loss_h, grads_h = nerad_step_on(torch.device("cpu"), trainer, tree)
    rel = abs(loss_c - loss_h) / abs(loss_h)
    worst = max(float((np.abs(a - b) - 2e-2 * np.abs(b)).max()) for a, b in zip(grads_c, grads_h))
    print(f"[nerad card vs cpu] loss card {loss_c:.7f} cpu {loss_h:.7f} (rel {rel:.2e}); "
          f"MLP gradients: largest |diff| - 2e-2 |cpu| = {worst:.3e}")
    check(rel < 1e-3, f"nerad step loss differs between card and CPU by {rel:.2e}")
    for i, (a, b) in enumerate(zip(grads_c, grads_h)):
        check(bool(np.allclose(a, b, rtol=2e-2, atol=1e-5)),
              f"nerad MLP gradient {i} differs between card and CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
    from mitsuba3_experiments_tpu_torch.scene import flagship, load_dict, standin_dict

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build ----------------------------------------------------
    build_all()

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
    reset_counts()
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
    small = PathIntegrator(max_depth=4)
    ref = render(small_nerad_scene(torch.device("cpu")), small, spp=2).numpy()
    got = render(small_nerad_scene(dev), small, spp=2).cpu().numpy()
    rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
    close = float(np.isclose(got, ref, rtol=1e-3, atol=1e-4).mean())
    print(f"[reference] 32x32 cornell+sphere: mean card {got.mean():.6f} cpu {ref.mean():.6f} "
          f"(rel {rel:.2e}), pixels within rtol 1e-3/atol 1e-4: {close:.4f}")
    check(rel < 1e-3, f"card and CPU image means differ by {rel:.2e}")
    check(close >= 0.99, f"only {close:.4f} of the pixels agree with the CPU render")

    # ---- phase 7: K2 against plain on the field's real inputs -------------
    from mitsuba3_experiments_tpu_torch.models import FieldConfig, NeradTrainer, init_field

    cfg = FieldConfig(fused=True)
    with torch.no_grad():
        field = init_field(torch.Generator().manual_seed(7), cfg, device=dev)
    err_k2, k2_ms, k2_plain_ms = phase_k2(dev, card, field, cfg, "init field", timing=True)

    # ---- phase 8: the nerad path on the stand-in ---------------------------
    trainer = NeradTrainer(field_cfg=cfg)
    train, _, trained = phase_nerad(scene, card, trainer=trainer)
    err_trained, _, _ = phase_k2(dev, card, trained, cfg, "trained field", timing=False)
    err_k2 = max(err_k2, err_trained)

    # ---- phase 9: K3's path, the ops entry point, against plain ------------
    k3_launches, err_k3, k3_ms, k3_plain_ms = phase_k3(
        dev, card, NeradTrainer.make_area_dist(scene).pmf)

    # ---- phase 10: one nerad step, card against CPU ------------------------
    phase_card_vs_cpu(dev)

    print(f"[smoke] total {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": [
        {"name": "bvh8_traverse", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches, "max_abs_err": max(err_a, err_b, err_c), "ms": k_main_ms,
         "plain_ms": p_main_ms},
        {"name": "fused_mlp", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": train["k2"], "max_abs_err": err_k2, "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "prefix_sum", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": k3_launches, "max_abs_err": err_k3, "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
