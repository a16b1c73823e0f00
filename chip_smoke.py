#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (mitsuba3_experiments_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

 1. needs a CUDA card; prints `nvidia-smi`'s name and power limit;
 2. builds the four kernels, one nvcc each, all started together: K1 the
    BVH8 traversal in persistent warps (csrc/bvh_traverse.cu), K2 the fused
    MLP (csrc/fused_mlp.cu), K3 the single-pass look-back scan
    (csrc/prefix_sum.cu), K4 the dependent gather chain
    (csrc/gather_chain.cu); prints their ptxas lines (registers, stack,
    spills);
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
    then K1 alone (no overflow check) is timed on each of those launches
    (CUDA events, 5 repeats), printed by kind with its rays and active
    lanes, and summed over the pass: K1's share of the main path;
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
    float32 within rtol 1e-4 of a float64 cumsum; then one call must make
    exactly one device allocation, its output;
10. one nerad step on the card against the same step on the CPU (Cornell
    box + a 4k-triangle sphere, a small fused field, batch 1,024, m_rhs 8),
    from the same parameters: losses within rtol 1e-3, MLP gradients within
    rtol 2e-2 / atol 1e-5;
11. K4's path, the probe entry point ops.gather_probe.dep_chain, on the
    seeded 431,104 x 88 table (151.8 MB, three times the L2) at 65,536 and
    1,843,200 lanes x 64 steps: K4 launched and the plain chain not; the
    final index equal on every lane and the accumulator equal bit for bit
    to the plain chain's; ns per row of the kernel, the plain chain and
    independent index_select (CUDA events); K4's bytes bound and its share
    of it; one step's round trip at 132 lanes of one thread per block;
12. the production forward and fwd+bwd at depth 8 on phase 3's stand-in
    (1280x720, spp 4, rr_depth 4): render_persistent with the tent filter,
    whose image must equal render()'s per pixel (rtol 1e-4 / atol 1e-5: the
    film's atomic splat adds in another order) — render() run as one pass
    (spp_per_pass=4), keyed like the persistent renderer (phase 4 splits
    the 4 spp into two passes, whose rays carry other keys); then
    record_full_pipelined(return_film=True, rfilter="box") and
    replay_grads(mode="auto" -> full, chunk 131,072) of the MSE against
    the forward image, with respect to materials.base_color and
    emitters.radiance, as the JAX package's bench.py does: both gradients
    finite and nonzero, K1 launched and the plain traversal not; fwd+bwd
    seconds, rays/s and peak device memory; then the recorder's first batch
    (2^21 camera rays) recorded again must give the same record, and every
    K1 launch it makes (closest hit over the 2,097,152 rays and over each
    bounce's compacted survivors, any hit over each bounce's compacted NEE
    lanes) is held against the plain traversal on the same tensors, as in
    phase 3; the first chunk's replayed radiance must equal the recorder's
    own per-ray radiance (rtol 1e-4);
13. the depth-65 companion (the reference bedroom's depth): 1280x720,
    spp 1, max_depth 65, replay_grads(mode="auto" -> sorted) fed the
    recorder's film: gradients finite and nonzero, seconds and rays/s;
14. record and replay on the card against the CPU on the 32x24
    sphere / floor / light scene (spp 2, depth 4): prims and occlusion
    equal, gradients within rtol 1e-3 / atol 1e-4 max|g|.

Each kernel's counts are set to 0 just before the path that runs it and
read just after: K1's around the render of phase 4 and again around the
production fwd+bwd of phase 12 (whose count the JSON line gives), K2's
from the training of phase 8, K3's from the ops entry point of phase 9 (no
path of the renderer or trainer scans: the CDFs are built on the host, as
in the JAX package), K4's from its probe entry point in phase 11.  The
kernels' JSON line gives each kernel's and its plain version's times at
the main path's shapes: K1 on the render's camera batch (phase 5, which
also prints the sum over the pass; phase 3 prints them at 65,536 rays), K2
on 524,288 field rows (phase 7), K3 on the stand-in's 1,964,564 face areas
(phase 9), K4 at 65,536 lanes x 64 steps (phase 11).  Beside them,
`bound_ms`, the least time the card could take for the same work: the
larger of the bytes the work must move (each input read once, each output
written once; for K1 and K4 the distinct table rows this run's data
reaches) over 3.35 TB/s and its operations over the peak rate of their
type (float32 67 TFLOP/s, bf16 989 TFLOP/s), and
`library_ms`, one PyTorch call computing the same function where there is
one (torch.cumsum for K3; none traverses a BVH, runs the whole MLP or
walks a dependent chain).  `ms`, `plain_ms` and `library_ms` are CUDA
events around calls made through the wrappers as a caller makes them (K1
with its overflow check), so they include the host's launch time where a
call is shorter than its launch.  `device_ms` is the kernel's own device
time: the same calls queued behind a device sleep, K1 without its
overflow check.

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
K4_REPLACES = "scripts/pallas_gather_probe.py:79"
K4_SOURCE = "mitsuba3_experiments_tpu_torch/csrc/gather_chain.cu"
FIELD_ROWS = 524_288       # NeradTrainer() RHS lanes: 16,384 x 32
TRAIN_STEPS = 50
SCAN_SIZES = (1_843_200, 1 << 26)
CHAIN_LANES = (65_536, 1_843_200)
CHAIN_ITERS = 64
REPLAY_CHUNK = 131_072
DEEP = 65                  # the reference bedroom's max_depth
# the card's published peaks (H100 SXM data sheet, 700 W)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_OPS_S = 989e12
ROW_BYTES = 88 * 4
# K1's float operations per fetched row, read off csrc/bvh_traverse.cu (a
# fused multiply-add counts 2, a compare or min/max 1): an internal row is
# 8 slab tests of 12 sub/mul, 10 min/max and 5 compares; a leaf row 8
# triangle tests of about 60
K1_OPS_INTERNAL_ROW = 8 * 27
K1_OPS_LEAF_ROW = 8 * 60


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


def device_ms(fn, reps):
    """Device milliseconds per call of `fn`, as `cuda_ms` but with the calls
    queued behind a ~2 ms device sleep, so that the host's time to launch
    them is not counted where a call is shorter than its launch."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
    return cuda_ms(fn, reps)


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


def k1_launches(run):
    """Calls `run()` and returns every K1 launch it made: [(args, kwargs,
    kernel outputs)], in launch order."""
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda

    launch = bvh_cuda.traverse_cuda
    made = []

    def recording(*args, **kwargs):
        out = launch(*args, **kwargs)
        made.append((args, kwargs, out))
        return out

    bvh_cuda.traverse_cuda = recording
    try:
        run()
    finally:
        bvh_cuda.traverse_cuda = launch
    return made


def render_queries(scene, integrator):
    """Runs the first pass of the smoke render (seed 0, pass 0, the same
    1280x720x2 wavefront) through `render` and returns every traversal it
    made: [(args, kwargs, kernel outputs)], in launch order."""
    from mitsuba3_experiments_tpu_torch.integrators import render

    return k1_launches(
        lambda: render(scene, integrator, spp=SPP // 2, spp_per_pass=SPP // 2, rfilter="tent"))


def build_all():
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda
    from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.ops import gather_probe_cuda, prefix_sum_cuda

    libs = [bvh_cuda.LIBRARY, fused_mlp_cuda.LIBRARY, prefix_sum_cuda.LIBRARY,
            gather_probe_cuda.LIBRARY]
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
    ms, kernel device ms), the times only when `timing`."""
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
            return err, None, None, None
        for _ in range(3):
            kernel(), plain()
        k_ms = cuda_ms(kernel, 20)
        p_ms = cuda_ms(plain, 20)
        k_dev = device_ms(kernel, 20)
    print(f"[K2 {label}] kernel {k_ms:.4f} ms (device time {k_dev:.4f} ms), plain {p_ms:.4f} ms "
          f"({card})")
    return err, k_ms, p_ms, k_dev


def counters():
    """(name, module, attribute) of every launch and plain-call count."""
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
    from mitsuba3_experiments_tpu_torch.models import fused_mlp, fused_mlp_cuda, mlp
    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda, prefix_sum_cuda

    return (("k1", bvh_cuda, "launches"), ("plain_traverse", bvh_torch, "calls"),
            ("k2", fused_mlp_cuda, "launches"), ("plain_mlp", mlp, "calls"),
            ("recomputes", fused_mlp, "recomputes"), ("k3", prefix_sum_cuda, "launches"),
            ("plain_scan", prefix_sum_cuda, "plain_calls"),
            ("k4", gather_probe_cuda, "launches"), ("plain_chain", gather_probe, "plain_calls"))


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
    # a call allocates its output and nothing else (the look-back's status
    # words and ticket stay on the device from call to call)
    x = cases[-1][1]
    prefix_sum_cuda.scan_cuda(x)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(device)["allocation.all.allocated"]
    prefix_sum_cuda.scan_cuda(x)
    allocs = torch.cuda.memory_stats(device)["allocation.all.allocated"] - before
    print(f"[K3] device allocations made by one call: {allocs}")
    check(allocs == 1, f"a K3 call made {allocs} device allocations, not only its output")
    for name, x in cases:
        k_ms = cuda_ms(lambda: prefix_sum_cuda.scan_cuda(x), 20)
        p_ms = cuda_ms(lambda: ops.prefix_sum(x), 20)
        lib_ms = cuda_ms(lambda: torch.cumsum(x, 0), 20)
        k_dev = device_ms(lambda: prefix_sum_cuda.scan_cuda(x), 20)
        lib_dev = device_ms(lambda: torch.cumsum(x, 0), 20)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
        print(f"[K3] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.cumsum "
              f"{lib_ms:.4f} ms, bytes bound {bound:.4f} ms, kernel at {bound / k_ms:.3f} of it; "
              f"device time: kernel {k_dev:.4f} ms ({bound / k_dev:.3f} of the bound), "
              f"torch.cumsum {lib_dev:.4f} ms ({card})")
    return counts["k3"], err, k_ms, p_ms, lib_ms, bound, k_dev


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


def phase_k4(dev, card):
    """Phase 11: K4's path, the probe entry point, against the plain chain
    at the probe's table size; returns the 65,536-lane numbers (launches,
    max abs err, kernel ms, plain ms, bound ms)."""
    import torch

    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda

    table = torch.as_tensor(gather_probe.build_table(0), device=dev)
    rows_n = table.shape[0]
    rng = np.random.default_rng(1)
    print(f"[K4] table {rows_n} x {table.shape[1]} float32 ({table.numel() * 4 / 1e6:.1f} MB)")
    first = None
    for n in CHAIN_LANES:
        idx0 = torch.as_tensor(rng.integers(0, rows_n, n).astype(np.int32), device=dev)
        torch.cuda.synchronize()
        reset_counts()
        idx, acc = gather_probe.dep_chain(table, idx0, CHAIN_ITERS)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["k4"] == 1 and counts["plain_chain"] == 0,
              f"dep_chain did not launch K4 once: {counts}")
        ref_idx, ref_acc = gather_probe.dep_chain_plain(table, idx0, CHAIN_ITERS)
        bad_idx = int((idx != ref_idx).sum())
        bad_acc = int((acc.view(torch.int32) != ref_acc.view(torch.int32)).sum())
        err = float((acc - ref_acc).abs().max())
        print(f"[K4] {n} lanes x {CHAIN_ITERS}: final idx differs on {bad_idx} lanes, acc not "
              f"bit-equal on {bad_acc}, max abs err {err:.3e}")
        check(bad_idx == 0 and bad_acc == 0, f"K4 differs from the plain chain at {n} lanes")

        idxs = torch.as_tensor(rng.integers(0, rows_n, (CHAIN_ITERS, n)).astype(np.int32),
                               device=dev)
        fetched = n * CHAIN_ITERS
        def kernel(idx0=idx0):
            gather_probe_cuda.dep_chain_cuda(table, idx0, CHAIN_ITERS, check=False)

        def plain(idx0=idx0):
            gather_probe.dep_chain_plain(table, idx0, CHAIN_ITERS)

        def ind(idxs=idxs):
            gather_probe.ind_gather_plain(table, idxs)

        for fn in (kernel, plain, ind):
            fn()
        k_ms, p_ms, i_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3), cuda_ms(ind, 3)
        k_dev = device_ms(kernel, 20)
        distinct, nbytes = gather_probe.chain_bytes(table, idx0, CHAIN_ITERS)
        bound = nbytes / HBM_BYTES_S * 1e3
        traffic = fetched * ROW_BYTES / HBM_BYTES_S * 1e3
        print(f"[K4] {n} lanes: kernel {k_ms:.4f} ms = {k_ms * 1e6 / fetched:.4f} ns/row, plain "
              f"chain {p_ms:.4f} ms = {p_ms * 1e6 / fetched:.4f} ns/row, independent index_select "
              f"{i_ms:.4f} ms = {i_ms * 1e6 / fetched:.4f} ns/row; kernel device time "
              f"{k_dev:.4f} ms ({card})")
        print(f"[K4] {n} lanes: {distinct} distinct rows reached: bytes bound {bound:.4f} ms "
              f"(kernel at {bound / k_ms:.4f} of it); every fetch from device memory would be "
              f"{traffic:.4f} ms (kernel at {traffic / k_ms:.4f} of that)")
        if first is None:
            first = (counts["k4"], err, k_ms, p_ms, bound, k_dev)
        del idxs
    # latency view: one thread per block on 132 blocks, so each step of a
    # lane waits for one device-memory round trip and nothing else
    idx0 = torch.as_tensor(rng.integers(0, rows_n, 132).astype(np.int32), device=dev)
    def lat():
        gather_probe_cuda.dep_chain_cuda(table, idx0, CHAIN_ITERS, block=1, check=False)

    lat()
    l_ms = cuda_ms(lat, 20)
    print(f"[K4] 132 lanes, block 1: {l_ms:.4f} ms = {l_ms * 1e6 / CHAIN_ITERS:.1f} ns per "
          f"dependent step ({card})")
    return first


def replay_scene(device):
    """The 32x24 sphere / floor / area-light scene of the JAX package's
    replay tests."""
    from mitsuba3_experiments_tpu_torch.core import math as tm
    from mitsuba3_experiments_tpu_torch.scene import load_dict
    from mitsuba3_experiments_tpu_torch.scene import mesh as meshlib

    sph = meshlib.sphere(radius=1.0, n_theta=20, n_phi=40)
    quad = meshlib.rectangle(subdiv=4)
    light = meshlib.rectangle(subdiv=1)
    fv = (quad.vertices * 4.0) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    lv = light.vertices @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32) + np.array(
        [0, 4, 0], np.float32)
    return load_dict({
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
    }, device=device)[0]


DIFF_KEYS = ("materials.base_color", "emitters.radiance")


def fwd_bwd(scene, target, spp, depth, card, label):
    """record_full_pipelined(return_film=True) + replay_grads(mode="auto"),
    timed as one synchronized step; returns (record, gradients, counts,
    seconds)."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import record_full_pipelined, replay_grads
    from mitsuba3_experiments_tpu_torch.scene import params

    w, h = scene.camera.resolution
    n_rays = w * h * spp
    pad = -(-n_rays // REPLAY_CHUNK) * REPLAY_CHUNK
    diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}
    mode = "sorted" if depth >= 16 else "full"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rec, film = record_full_pipelined(scene, 0, n_rays, spp=spp, max_depth=depth, rr_depth=4,
                                      pad_to=pad, return_film=True, rfilter="box")
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    g = replay_grads(scene, diff, params.update, target, 0, rec, n_rays, chunk=REPLAY_CHUNK,
                     spp=spp, max_depth=depth, rr_depth=4, rfilter="box", mode="auto", film=film)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] {w}x{h} spp {spp} depth {depth}: fwd+bwd {dt:.3f} s = {n_rays / dt:.1f} "
          f"rays/s (record {rec_s:.3f} s, replay_grads mode auto -> {mode} {dt - rec_s:.3f} s, "
          f"{pad // REPLAY_CHUNK} chunks of {REPLAY_CHUNK}); peak device memory {peak:.2f} GB; "
          f"counts {counts} ({card})")
    for k in DIFF_KEYS:
        gk = g[k]
        print(f"[{label}] d loss / d {k}: shape {tuple(gk.shape)}, max |g| "
              f"{float(gk.abs().max()):.6e}, sum {float(gk.sum()):.6e}")
        check(bool(torch.isfinite(gk).all()), f"{label}: gradient of {k} is not finite")
        check(float(gk.abs().max()) > 0.0, f"{label}: gradient of {k} is zero")
    check(counts["k1"] > 0, f"{label}: the recorder did not launch K1")
    check(counts["plain_traverse"] == 0, f"{label}: the recorder ran the plain traversal")
    return rec, g, counts, dt


def phase_production(scene, integrator, card):
    """Phase 12: the production forward, then fwd+bwd at depth 8; returns
    (forward image, fwd+bwd counts, K1's max abs error against plain on the
    recorder's first batch)."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import (
        PathRecord, render, render_persistent, replay_radiance)
    from mitsuba3_experiments_tpu_torch.integrators import persistent
    from mitsuba3_experiments_tpu_torch.intersect import bvh_torch

    w, h = RES
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = render_persistent(scene, seed=0, spp=SPP, max_depth=MAX_DEPTH, rr_depth=4,
                            rfilter="tent")
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"[persistent] {w}x{h} spp {SPP} depth {MAX_DEPTH} tent: {fwd_s:.3f} s, "
          f"{w * h * SPP / fwd_s:.1f} camera rays/s, counts {counts} ({card})")
    check(counts["k1"] > 0 and counts["plain_traverse"] == 0,
          "render_persistent did not run on K1 alone")
    ref = render(scene, integrator, spp=SPP, spp_per_pass=SPP, rfilter="tent")
    close = torch.isclose(img, ref, rtol=1e-4, atol=1e-5).all(dim=-1)
    err = float((img - ref).abs().max())
    print(f"[persistent] against render() in one pass: pixels within rtol 1e-4/atol 1e-5 "
          f"{float(close.float().mean()):.6f} ({int((~close).sum())} outside), max abs err "
          f"{err:.3e}, means {float(img.mean()):.6f} / {float(ref.mean()):.6f}")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
          "the persistent image is not finite or is black")
    check(bool(close.all()), "render_persistent differs from render() beyond rtol 1e-4/atol 1e-5")
    del ref

    rec, _, counts, _ = fwd_bwd(scene, img, SPP, MAX_DEPTH, card, "fwd+bwd d8")
    # the recorder's first batch (2^21 camera rays) again through the same
    # wavefront, every K1 launch kept: its record must equal the frame's, so
    # these launches are the counted run's own, on the same tensors; each is
    # held against the plain traversal (closest hit over the live lanes,
    # any hit over the compacted NEE lanes)
    n_rays = w * h * SPP
    batch = persistent.N_LANES
    part = PathRecord.empty(batch, MAX_DEPTH, scene.device)
    rayL = []
    made = k1_launches(lambda: rayL.append(persistent.trace_rays(
        scene, 0, 0, batch, batch, spp=SPP, max_depth=MAX_DEPTH, rr_depth=4, rec=part)))
    rayL = rayL[0]
    first = rec.rows(slice(0, batch))
    for f in ("prim", "u", "v", "occl"):
        check(bool(torch.equal(getattr(part, f), getattr(first, f))),
              f"the first batch recorded again differs in {f}")
    del part
    err_k1, plain_s = 0.0, 0.0
    for i, (args, kw, out_k) in enumerate(made):
        kind = "shadow" if kw["any_hit"] else "closest"
        t0 = time.perf_counter()
        out_p = bvh_torch.traverse_plain(*args, any_hit=kw["any_hit"], layout=kw["layout"])
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        err_k1 = max(err_k1, hold(f"record batch0 #{i} {kind} {args[2].shape[0]}", out_k, out_p,
                                  kw["any_hit"], int(args[5].sum())))
    kinds = {kw["any_hit"] for _, kw, _ in made}
    check(kinds == {False, True}, "the recorder's first batch made no closest-hit or no "
          "any-hit launch")
    print(f"[fwd+bwd d8] the recorder's first batch: {len(made)} K1 launches held against plain "
          f"({plain_s:.1f} s of plain), max abs err {err_k1:.3e}")
    del made

    # the first chunk's replay gives the recorder's own per-ray radiance
    with torch.no_grad():
        L, _, _ = replay_radiance(scene, rec.rows(slice(0, REPLAY_CHUNK)), 0, 0, spp=SPP,
                                  max_depth=MAX_DEPTH, rr_depth=4, ray_end=n_rays)
    L = torch.where(torch.isfinite(L), L, 0.0)
    ref_L = rayL[:REPLAY_CHUNK]
    close = float(torch.isclose(L, ref_L, rtol=1e-4, atol=1e-7).all(dim=-1).float().mean())
    print(f"[fwd+bwd d8] first chunk: replayed radiance within rtol 1e-4 of the recorder's on "
          f"{close:.6f} of {REPLAY_CHUNK} rays, max abs err {float((L - ref_L).abs().max()):.3e}")
    check(close == 1.0, "the replayed radiance differs from the recorder's")
    return img, counts, err_k1


def phase_card_vs_cpu_replay(device):
    """Phase 14: record + replay on the card and on the CPU."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import (
        PathIntegrator, record_full_pipelined, render, replay_grads)
    from mitsuba3_experiments_tpu_torch.scene import params

    spp, depth = 2, 4
    out = {}
    for dev in (device, torch.device("cpu")):
        scene = replay_scene(dev)
        n = 32 * 24 * spp
        pad = n + 128
        target = render(scene, PathIntegrator(max_depth=depth), seed=9, spp=spp, rfilter="box")
        rec, film = record_full_pipelined(scene, 3, n, spp=spp, max_depth=depth, rr_depth=4,
                                          pad_to=pad, return_film=True)
        diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}
        g = replay_grads(scene, diff, params.update, target, 3, rec, n, chunk=pad // 2, spp=spp,
                         max_depth=depth, rr_depth=4, mode="full")
        out[dev.type] = (rec, {k: v.cpu().numpy() for k, v in g.items()})
    (rc, gc), (rh, gh) = out["cuda"], out["cpu"]
    d_prim = int((rc.prim.cpu() != rh.prim).sum())
    d_occl = int((rc.occl.cpu() != rh.occl).sum())
    print(f"[replay card vs cpu] record entries differing: prim {d_prim}, occl {d_occl} of "
          f"{rh.prim.numel()}")
    check(d_prim == 0 and d_occl == 0, "the card's record differs from the CPU's")
    for k in DIFF_KEYS:
        scale = float(np.abs(gh[k]).max())
        worst = float((np.abs(gc[k] - gh[k]) - 1e-3 * np.abs(gh[k])).max())
        print(f"[replay card vs cpu] {k}: max |g| {scale:.6e}, largest |diff| - 1e-3 |cpu| "
              f"{worst:.3e} (atol {1e-4 * scale:.3e})")
        check(scale > 0 and bool(np.allclose(gc[k], gh[k], rtol=1e-3, atol=1e-4 * scale)),
              f"replayed gradient of {k} differs between card and CPU")


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
        rows0, leaf0 = bvh_torch.rows, bvh_torch.leaf_rows
        t0 = time.perf_counter()
        out_p = bvh_torch.traverse_plain(*args, any_hit=kw["any_hit"], layout=kw["layout"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        plain_s.append(dt)
        if i == 0:   # what the camera batch's traversal fetches: K1's bound
            cam_rows, cam_leaf = bvh_torch.rows - rows0, bvh_torch.leaf_rows - leaf0
            cam_distinct = bvh_torch.last_distinct_rows
        err_c = max(err_c, hold(f"pass0 #{i} {kind}", out_k, out_p, kw["any_hit"],
                                int(args[5].sum())))
        print(f"[pass0 #{i} {kind}] plain {dt:.2f} s")
    # K1 alone on each launch of the pass, kernel only (the comparison above
    # made the overflow check): device time, 5 repeats
    per_ms, by_kind = [], {}
    for i, (args, kw, _) in enumerate(made):
        kind = "camera" if i == 0 else ("shadow" if kw["any_hit"] else "bounce")

        def launch(args=args, kw=kw):
            bvh_cuda._launch(*args, **kw)

        launch()
        ms = device_ms(launch, 5)
        per_ms.append(ms)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        print(f"[pass0 #{i} {kind}] {args[2].shape[0]} rays, {int(args[5].sum())} active: "
              f"kernel {ms:.4f} ms ({card})")
    args, kw, _ = made[0]
    n_main = args[2].shape[0]
    for _ in range(2):
        bvh_cuda.traverse_cuda(*args, **kw)
    k_main_ms = cuda_ms(lambda: bvh_cuda.traverse_cuda(*args, **kw), 5)
    p_main_ms = plain_s[0] * 1e3   # the comparison's own plain call, synchronized
    print(f"[pass0] {len(made)} traversals of {n_main} rays held against plain "
          f"({sum(plain_s):.1f} s of plain); camera batch: kernel {k_main_ms:.4f} ms with the "
          f"wrapper's overflow check, {per_ms[0]:.4f} ms of device time alone, "
          f"plain {p_main_ms:.3f} ms ({card})")
    print(f"[pass0] K1 over the pass's {len(made)} launches: {sum(per_ms):.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in by_kind.items()) + f") ({card})")
    # K1's least time on the camera batch: each distinct row it reaches read
    # once plus the rays in and the hits out, or its float operations
    k1_bytes = cam_distinct * ROW_BYTES + n_main * (12 + 12 + 4 + 1 + 16)
    k1_ops = (cam_rows - cam_leaf) * K1_OPS_INTERNAL_ROW + cam_leaf * K1_OPS_LEAF_ROW
    k1_bound = max(k1_bytes / HBM_BYTES_S, k1_ops / F32_OPS_S) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BYTES_S >= k1_ops / F32_OPS_S else "operations"
    print(f"[pass0] camera batch fetched {cam_rows} rows ({cam_leaf} leaf, {cam_distinct} "
          f"distinct of {scene.bvh.unified.shape[0]}): bytes {k1_bytes / 1e6:.1f} MB = "
          f"{k1_bytes / HBM_BYTES_S * 1e3:.4f} ms, float32 operations {k1_ops / 1e9:.2f} G = "
          f"{k1_ops / F32_OPS_S * 1e3:.4f} ms: bound {k1_bound:.4f} ms by {k1_by}, kernel at "
          f"{k1_bound / k_main_ms:.4f} of it; every fetch from device memory would be "
          f"{cam_rows * ROW_BYTES / HBM_BYTES_S * 1e3:.4f} ms")
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
    err_k2, k2_ms, k2_plain_ms, k2_dev = phase_k2(dev, card, field, cfg, "init field",
                                                  timing=True)

    # ---- phase 8: the nerad path on the stand-in ---------------------------
    trainer = NeradTrainer(field_cfg=cfg)
    train, _, trained = phase_nerad(scene, card, trainer=trainer)
    err_trained, _, _, _ = phase_k2(dev, card, trained, cfg, "trained field", timing=False)
    err_k2 = max(err_k2, err_trained)

    # ---- phase 9: K3's path, the ops entry point, against plain ------------
    k3_launches, err_k3, k3_ms, k3_plain_ms, k3_lib_ms, k3_bound, k3_dev = phase_k3(
        dev, card, NeradTrainer.make_area_dist(scene).pmf)

    # ---- phase 10: one nerad step, card against CPU ------------------------
    phase_card_vs_cpu(dev)

    # ---- phase 11: K4's path, the probe entry point, against plain ---------
    k4_launches, err_k4, k4_ms, k4_plain_ms, k4_bound, k4_dev = phase_k4(dev, card)

    # ---- phase 12: production forward + fwd+bwd, depth 8 -------------------
    target, prod, err_d = phase_production(scene, integrator, card)

    # ---- phase 13: the depth-65 companion ----------------------------------
    fwd_bwd(scene, target, 1, DEEP, card, "fwd+bwd d65")

    # ---- phase 14: record + replay, card against CPU -----------------------
    phase_card_vs_cpu_replay(dev)

    # K2's least time on 524,288 rows: the features in, the weights and the
    # outputs once, or its bf16 products at the tensor cores' rate
    sizes = (32, 64, 64, 64, 3)
    k2_bytes = FIELD_ROWS * (sizes[0] + sizes[-1]) * 4 + sum(
        (a + 1) * b * 4 for a, b in zip(sizes[:-1], sizes[1:]))
    k2_ops = 2 * FIELD_ROWS * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    k2_bound = max(k2_bytes / HBM_BYTES_S, k2_ops / BF16_OPS_S) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BYTES_S >= k2_ops / BF16_OPS_S else "operations"
    print(f"[K2] bound on {FIELD_ROWS} rows: {k2_bytes / 1e6:.1f} MB = "
          f"{k2_bytes / HBM_BYTES_S * 1e3:.4f} ms, {k2_ops / 1e9:.2f} G bf16 operations = "
          f"{k2_ops / BF16_OPS_S * 1e3:.4f} ms: {k2_bound:.4f} ms by {k2_by}, kernel at "
          f"{k2_bound / k2_ms:.4f} of it")
    print(f"[smoke] total {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": [
        {"name": "bvh8_traverse", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": prod["k1"], "max_abs_err": max(err_a, err_b, err_c, err_d), "ms": k_main_ms,
         "plain_ms": p_main_ms, "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "device_ms": per_ms[0]},
        {"name": "fused_mlp", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": train["k2"], "max_abs_err": err_k2, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None, "device_ms": k2_dev},
        {"name": "prefix_sum", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": k3_launches, "max_abs_err": err_k3, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": "bytes", "library_ms": k3_lib_ms,
         "device_ms": k3_dev},
        {"name": "gather_chain", "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
         "launches": k4_launches, "max_abs_err": err_k4, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound, "bound_by": "bytes", "library_ms": None, "device_ms": k4_dev},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
