#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (mitsuba3_experiments_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

 1. needs a CUDA card; prints `nvidia-smi`'s name and power limit;
 2. builds the five kernel sources, one nvcc each, and the host library
    (g++ on native/*.cpp), all started together: K1 the BVH8 traversal in
    persistent warps (csrc/bvh_traverse.cu), K2 the fused MLP on bf16
    tensor cores (csrc/fused_mlp.cu), K3 the single-pass look-back scan
    (csrc/prefix_sum.cu), K4 the dependent gather chain in coalesced row
    loads (csrc/gather_chain.cu), K5 the path replay's forward and adjoint
    (csrc/replay_path.cu); prints their ptxas lines (registers, stack,
    spills) and each build's seconds;
 3. holds the kernel against its plain torch version on the same 65,536
    seeded rays, closest hit and any hit, into a 100k-triangle blob and the
    ~2M-triangle bedroom-class stand-in, both in the default spatial-split
    (SBVH) tree, whose leaves must repeat faces: closest-hit faces must be
    equal and t/u/v allclose (rtol 1e-6, atol 1e-7); any-hit hit/miss
    equal; prints the stand-in's build seconds;
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
 5b. the stand-in built again with object splits only (BVHLayout(sbvh=
    False)): its build seconds, and for each tree the rows fetched per
    camera ray and K1's bound from the distinct rows its camera batch
    reaches (plain traversal), then K1's device time on the camera batch
    and summed over the first pass's launches, tree by tree in turns
    (spatial, object, object, spatial);
 6. a small reference render (Cornell box + a 4k-triangle sphere, 32x32,
    spp 2, depth 4) on the card must agree with the same render on the CPU,
    whose plain path the CPU tests hold against the JAX package;
 6b. the differentiable render (PathIntegrator(differentiable=True)) of
    that scene at spp 4, depth 4: the gradients of an MSE with respect to
    materials.base_color and emitters.radiance on the card equal the CPU's
    (rtol 1e-3 / atol 1e-4 max|g|) and the card's replay_render_grad on
    the same seed (rtol 5e-3 / atol 5e-4 max|g|);
 7. K2 against its plain version (apply_mlp) on the field's real inputs at
    full width: FieldConfig() (sizes 32-64-64-64-3), init_field from a
    seeded torch.Generator, hashgrid_encode + sh_eval features of 524,288
    seeded points and directions (the RHS batch of a training step):
    allclose at rtol 2e-2 / atol 2e-2, and at least 99% of the rows equal
    to 1e-5; both timed with CUDA events; then K2 alone at 16,384 rows (the
    step's left-hand side) and 921,600 (the nerad render), the same checks,
    device time beside the bound;
 8. the neural-radiosity path on phase 3's stand-in: NeradTrainer() at its
    defaults (batch 16,384, m_rhs 32: 524,288 RHS lanes; lr 1e-3) with
    FieldConfig(fused=True), 50 steps — every loss finite, the mean of the
    last 10 below the mean of the first 10; K1 and K2 launched, the plain
    MLP forward (apart from the backward's recompute) and plain traversal
    run 0 times; then render(scene, NeradIntegrator(trainer, field), spp=1)
    at 1280x720 — the image finite with a mean above 0, K2 launched; then
    phase 7's check again on the trained field, whose biases and hash grid
    are no longer those of init_field (zero biases, grid features ~1e-4);
 8b. neural radiance caching on the stand-in: NRCTrainer with
    FieldConfig(fused=True) at batch 16,384 for 24 steps — every loss
    finite, K1 and K2 launched, no plain traversal, no plain MLP forward
    outside the backward's recompute; every K1 launch of the first step
    held against the plain traversal, as in phase 3; K2 held against
    apply_mlp on the first step's cache-query rows (at least 0.99 of them
    within 1e-5) and timed there; then the stand-in rendered at 1280x720,
    spp 1 by NRCIntegrator with the trained cache (K1 and K2 alone), and
    again with the plain MLP in the same cache: allclose within rtol 2e-2 /
    atol 2e-3;
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
    of it; the L2 diagnostic: the same at both lane counts over a 65,536-row
    table (23.1 MB, inside the L2), equal to plain, ns per row; one step's
    round trip at 132 chains of one chain per block;
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
12c. K5 against its plain version (replay_radiance_plain with autograd) on
    the same card tensors: the first 131,072 rows of phase 12's record
    (depth 8) and the longest chunk of phase 13's as the sorted replay
    orders it (131,072 rows, depth 65, its depth class): L within rtol 1e-4
    / atol 1e-5 on at least 0.9999 of the rows, the gradients of sum(L dL)
    (dL a seeded normal) with respect to the base colours and the emitter
    radiances within rtol 1e-3 / atol 1e-4 max|g|, and K5's non-finite
    rows the plain replay's; both kernels and the plain version timed with
    CUDA events in turns (plain, kernel, kernel, plain), K5's bound from
    the record entries and face rows its hit vertices read and their
    operations, each vertex counted by its own material's kind (k5_work);
    then one replay_grads_full chunk under torch.profiler:
    its busy share, device operations and aten operators.  Phases 6b, 12,
    13, 13b, 14, 19a, 20b and 21 replay on K5: each prints its K5 launches
    (forward + adjoint) beside K1's and fails if it ran none or ran the
    plain replay;
13b. the truncated replay: the stand-in's camera at 32x18, spp 1, depth
    32, chunks of 64 rows — at least one chunk's longest path must be at
    most half the depth; replay_grads(mode="trunc"), which is the full
    replay (its depth loop stops once a chunk has no live row), gives
    finite, nonzero gradients; timed;
14. record and replay on the card against the CPU on the 32x24
    sphere / floor / light scene (spp 2, depth 4): prims and occlusion
    equal, gradients within rtol 1e-3 / atol 1e-4 max|g|;
15. the integrator zoo on phase 3's stand-in at 1280x720, one phase each:
    15a SimpleIntegrator (spp 4, depth 8, tent), 15b render_wavefront (spp
    4, depth 8, tent), 15c ParticleTracer (spp 1), 15d render_spectral (spp
    1, depth 8), 15e BDPTIntegrator (spp 1, max_depth 8), 15f SPPM (two
    frames at its defaults), 15g RestirGI (two render_frame_chunked frames
    at its defaults, but the inner path's max_depth 4).  Each prints its
    seconds, camera rays/s (light paths/s for the particle tracer, photons/s
    for SPPM) and K1's launches beside the card's name and power limit; its
    image must be finite with a mean above 0, K1 must have launched and the
    plain traversal not; K1 is held against the plain traversal on the
    first 65,536 active lanes of its first closest-hit launch and, where the
    integrator traces shadow or connection rays, its first any-hit launch,
    with 0 mismatches; the image mean is held against phase 12's
    render_persistent image at the bounds written beside each call (the JAX
    package's own test's, or PERF.md's);
16. each new integrator on the Cornell box + a 4k-triangle sphere at 32x32
    on the card against the CPU: means within 1e-3 relative, at least 0.99
    of the pixels within rtol 1e-3 / atol 1e-4 (as phase 6);
17. the MCMC and learned-sampling slice: 17a Pssmlt(mode="path") and 17b
    Pssmlt(mode="simple") on phase 3's stand-in at 1280x720 (921,600
    chains, depth 8, rr_depth 4, PSSMLT_ITERS rounds, 40 of them bootstrap),
    each through phase 15's checks (seconds, rounds/s, chain-steps/s, K1's
    launches and no plain traversal, the first closest-hit launch and, in
    path mode, the first any-hit launch held against plain on 65,536
    lanes), b (the bootstrap rounds' mean luminance) within 0.05 relative
    of the mean luminance of phase 12's render_persistent image (17a) or
    15a's SimpleIntegrator image (17b), 17a's image mean within 0.1 of
    render_persistent's (17b's image, biased low by the chains' start-up,
    is printed); 17c run_chain_1d at its defaults on the card: the JAX
    test's assertions, the histogram within L1 0.02 of the CPU run; 17d
    train_flow on the double spiral, affine then rqs, FlowConfig()'s
    widths, FLOW_ITERS steps of 4096: the least loss below 0, at least 0.95
    of 4,096 samples inside (-0.2, 1.2)^2, ms per step and one step's
    kernels and peak memory (utils.profile), one step's loss on the card
    within 1e-4 of the CPU's;
    17e train_reparam at ReparamConfig()'s widths, 1000 steps of 4096, on
    a gaussian bump: the last loss below 1.0, the mapped samples closer to
    the bump; ms per step;
18. five Pssmlt rounds, path and simple mode, on the 32x32 Cornell box +
    sphere on the card against the CPU from the same state: at least 0.99
    of the chains in the same state, accumulator means within 1e-3
    relative.
19. parallel/ on torch.distributed.  19a: a one-rank NCCL group in this
    process (file:// rendezvous under out/), the stand-in at 1280x720:
    render_sharded(PathIntegrator(max_depth=8, rr_depth=4), spp 4, tent)
    equal to phase 4's image on every pixel (rtol 1e-4 / atol 1e-5), again
    with chunks of SHARD_CHUNK lanes (the last launch of each pass padded),
    K1 held against plain on the first closest-hit and any-hit launch of
    the first; render_persistent_sharded(spp 4, depth 8, tent) equal to
    phase 12's render_persistent image; sharded_replay_grad (spp 4, depth
    8, rr_depth 4, chunks of 131,072 rays) against phase 12's target: its
    gradients equal to phase 12's replay_grads within rtol 1e-3 / atol 1e-4
    max|g|; sharded_grad_step (the differentiable render, spp_per_pass 1,
    depth 8, at 1280x720): loss and gradients finite, gradients nonzero.
    Each prints its seconds, camera rays/s, K1 launches and peak device
    memory; then the four entry points run on phase 6's 32x32 Cornell box
    + sphere as 19b's reference, and the group is destroyed.  19b: two
    spawned processes on cuda:0 in a gloo group (NCCL takes one rank a
    card), file:// rendezvous, joined within JOIN_S: each entry point on
    the small scene, a padded chunk included, equal to the world-1 result
    (images rtol 1e-4 / atol 1e-5, losses rtol 1e-4, gradients rtol 2e-3 /
    atol 2e-4 max|g|), both ranks equal, K1 launched in each; a rank that
    fails or hangs fails the run.
20. the flagship loader and inverse rendering on its scene.  20a: a
    bedroom-class skeleton XML written from numpy (tests/
    torch_bedroom_skeleton.py: the bedroom camera, a tent film, max_depth
    65, FLAGSHIP_OBJ obj shapes behind LFS pointers, one of them ~75% of
    the size total and one missing, an LFS-pointer bitmap, two area
    emitters) through `scene.flagship.load_flagship` at 1280x720 and
    FLAGSHIP_TRIS triangles into a fresh cache under out/, then again from
    that cache: tables equal byte for byte; build and cache-read seconds;
    render_pipelined(spp 4, depth 8, rr_depth 4, tent) finite and above 0,
    K1 held against plain on its first closest-hit and any-hit launch
    (as in phase 15); seconds, camera rays/s, K1 launches, peak memory.
    20b: INVERT_STEPS Adam steps of scripts/torch_flagship_invert.py's
    `invert_step` (record_full_pipelined + replay_grads, spp 4, depth 8,
    chunks of 131,072) from its start point against its box-filtered
    target: the last step's loss and radiance error below the first's;
    each step's record and replay seconds and K1 launches.
21. bench_torch.py, the port's benchmark, in a subprocess twice: the small
    lockstep rung (BENCH_SMALL=1) and the headline (1280x720, spp 4, depth
    8, BENCH_SKIP_D65=1).  Each must exit 0 with its JSON line last: a
    finite value above 0, extra.device the card's name, and on its "#"
    lines K1 launched and no plain traversal; the headline's fwd+bwd rays/s
    within +-30% of phase 12's in this run.  Its lines are printed.

Each kernel's counts are set to 0 just before the path that runs it and
read just after: K1's around the render of phase 4, the differentiable
render and its backward (6b), the NRC training and render (8b), the
production fwd+bwd of phase 12, the trunc record (13b), each phase of 15
and 17a, 17b, each entry point of 19a and 19b's two ranks, the render of
20a, each step of 20b and the bench's timed calls in 21 (counted by the
bench's own processes and read off its "#" lines) — the JSON line gives the
sum of all but the first — K5's from each phase that replays (6b, 12,
13, 13b, 14, 19a, 20b, 21's headline), K2's
from the training of phase 8 and the NRC training and render (8b), summed, K3's
from the ops entry point of phase 9 (no path of the renderer or trainer
scans: the CDFs are built on the host, as in the JAX package), K4's from
its probe entry point in phase 11.  The kernels' JSON line gives each
kernel's and its plain version's times at the main path's shapes: K1 on
the render's camera batch (phase 5, which
also prints the sum over the pass; phase 3 prints them at 65,536 rays), K2
on 524,288 field rows (phase 7), K3 on the stand-in's 1,964,564 face areas
(phase 9), K4 at 65,536 lanes x 64 steps (phase 11), K5 (forward +
adjoint) on phase 12c's depth-8 chunk of 131,072 rows.  Beside them,
`bound_ms`, the least time the card could take for the same work: the
larger of the bytes the work must move (each input read once, each output
written once; for K1, K4 and K5 the distinct table rows this run's data
reaches) over 3.35 TB/s and its operations over the peak rate of their
type (float32 67 TFLOP/s, bf16 989 TFLOP/s), and
`library_ms`, one PyTorch call computing the same function where there is
one (torch.cumsum for K3; none traverses a BVH, runs the whole MLP,
walks a dependent chain or replays a path).  `ms`, `plain_ms` and `library_ms` are CUDA
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
K5_REPLACES = "mitsuba3_experiments_tpu/integrators/replay.py:792"
K5_SOURCE = "mitsuba3_experiments_tpu_torch/csrc/replay_path.cu"
FIELD_ROWS = 524_288       # NeradTrainer() RHS lanes: 16,384 x 32
K2_OTHER_ROWS = (16_384, 921_600)   # the nerad step's LHS batch, the 1280x720 nerad render
K2_SIZES = (32, 64, 64, 64, 3)      # FieldConfig()'s MLP
TRAIN_STEPS = 50
SCAN_SIZES = (1_843_200, 1 << 26)
CHAIN_LANES = (65_536, 1_843_200)
CHAIN_ITERS = 64
L2_TABLE_ROWS = 65_536     # K4's diagnostic table, 23.1 MB: fits in the H100's 50 MB L2
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
# K5's float32 operations, read off csrc/replay_path.h as it computes them
# (an add, multiply, divide, compare, min/max, sqrt or transcendental counts
# 1; a negation, an absolute value, a select and integer arithmetic 0, so a
# counter-based draw counts 1 for its scale).  A hit vertex: the surface
# interaction 105 and the emission gate 2, on an emitter's face 42 more for
# its MIS and radiance.  A hit short of max_depth also shades: the area
# NEE sample 75 and a compare a step of its binary search, six draws, two
# frame changes, roulette and the next direction 55, the BSDF sample (its
# kind's count below, and 22 of flip and gates), a textured albedo 48, a
# mask's opacity lobe 28; where the light is not occluded and the material
# smooth, the BSDF's evaluation at the NEE direction (its kind's count, and
# 22 of flip, MIS and the sum; a mask 9 more).  The adjoint's derivative
# terms (the suffix sums, the weight's and the value's albedo scales, the
# table sums): 50 a shaded vertex, 85 more on a mask, 6 an emitter hit.
# Kinds: diffuse, conductor, rough conductor, dielectric, rough dielectric,
# plastic, rough plastic, mask (its nested kind's), null, principled.
K5_OPS_SAMPLE = (23, 108, 223, 39, 290, 100, 340, 0, 0, 237)
K5_OPS_EVAL = (11, 4, 222, 4, 184, 87, 231, 0, 4, 158)
K5_OPS_HIT, K5_OPS_EMITTER_HIT, K5_OPS_SHADE = 107, 42, 130
K5_OPS_TEXTURE, K5_OPS_MASK, K5_OPS_MASK_EVAL = 48, 28, 9
K5_OPS_SAMPLE_COMMON, K5_OPS_EVAL_COMMON = 22, 22
K5_OPS_DERIV, K5_OPS_DERIV_MASK, K5_OPS_DERIV_EMITTER = 50, 85, 6
K5_FACE_BYTES = 29 * 4    # the face row's floats that _make_si reads
K5_ENTRY_BYTES = 13       # a record entry: prim, u, v (4 bytes each) and occl (1)
# K5's launches (forward, adjoint) on the main path, by phase: each phase
# that replays adds its own (note_k5); phase 12c's comparisons are not counted
K5_BY_PHASE: dict = {}


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


def k1_launches(run, first_only=False):
    """Calls `run()` and returns every K1 launch it made: [(args, kwargs,
    kernel outputs)], in launch order; with `first_only`, only the first
    closest-hit and the first any-hit launch (a long run's launches would
    otherwise hold all their rays and hits on the card)."""
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda

    launch = bvh_cuda.traverse_cuda
    made = []

    def recording(*args, **kwargs):
        out = launch(*args, **kwargs)
        if not first_only or all(m[1]["any_hit"] != kwargs["any_hit"] for m in made):
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

    from mitsuba3_experiments_tpu_torch.integrators import replay_cuda
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda
    from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.ops import gather_probe_cuda, prefix_sum_cuda
    from mitsuba3_experiments_tpu_torch.scene import native

    libs = [bvh_cuda.LIBRARY, fused_mlp_cuda.LIBRARY, prefix_sum_cuda.LIBRARY,
            gather_probe_cuda.LIBRARY, replay_cuda.LIBRARY, native.LIBRARY]
    t0 = time.perf_counter()

    def build(lib):
        start = time.perf_counter()
        return lib.build(), time.perf_counter() - start

    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(build, libs))
    print(f"[build] {len(libs) - 1} kernels and the host library in "
          f"{time.perf_counter() - t0:.2f} s")
    for so, dt in built[:-1]:
        print(f"[build] {so}: {dt:.2f} s")
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[build] {line.strip()}")
    print(f"[build] host library (g++, native/*.cpp) {built[-1][0]}: {built[-1][1]:.2f} s")
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


def k2_least_ms(n, sizes):
    """K2's least time on n rows: the features in, the weights and the
    outputs once, or its bf16 products at the tensor cores' rate; returns
    (ms, "bytes" or "operations") and prints both terms."""
    nbytes = n * (sizes[0] + sizes[-1]) * 4 + sum(
        (a + 1) * b * 4 for a, b in zip(sizes[:-1], sizes[1:]))
    ops = 2 * n * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    bound = max(nbytes / HBM_BYTES_S, ops / BF16_OPS_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_S >= ops / BF16_OPS_S else "operations"
    print(f"[K2] bound on {n} rows: {nbytes / 1e6:.1f} MB = {nbytes / HBM_BYTES_S * 1e3:.4f} ms, "
          f"{ops / 1e9:.2f} G bf16 operations = {ops / BF16_OPS_S * 1e3:.4f} ms: {bound:.4f} ms by "
          f"{by}")
    return bound, by


def phase_k2_sizes(device, card, field, cfg):
    """Phase 7's other row counts: K2 at the nerad step's left-hand side
    (16,384 rows) and the nerad render (921,600), each against apply_mlp
    and timed (device time) beside its bound."""
    import torch

    from mitsuba3_experiments_tpu_torch.models import apply_mlp, fused_mlp, fused_mlp_cuda

    flat = tuple(t.detach() for t in fused_mlp.mlp_params_flat(field.mlp))
    params = [{"w": w, "b": b} for w, b in zip(flat[0::2], flat[1::2])]
    for n in K2_OTHER_ROWS:
        with torch.no_grad():
            h = field_inputs(field, cfg, n, device, seed=12)
            got = fused_mlp_cuda.fused_mlp_cuda(flat, h, K2_SIZES, "leaky_relu", cfg.fused_tile)
            ref = apply_mlp(params, h)
            torch.cuda.synchronize()
            close = float(torch.isclose(got, ref, rtol=1e-5, atol=1e-5).all(dim=1).float().mean())
            check(bool(torch.allclose(got, ref, rtol=2e-2, atol=2e-2)) and close >= 0.99,
                  f"K2 at {n} rows differs from apply_mlp (rows equal {close:.6f})")
            k_dev = device_ms(
                lambda: fused_mlp_cuda.fused_mlp_cuda(flat, h, K2_SIZES, "leaky_relu",
                                                      cfg.fused_tile), 20)
        bound, _ = k2_least_ms(n, K2_SIZES)
        print(f"[K2 init field] {n} rows: rows equal to 1e-5: {close:.6f}; kernel device time "
              f"{k_dev:.4f} ms, bound {bound:.4f} ms, kernel at {bound / k_dev:.4f} of it ({card})")


def counters():
    """(name, module, attribute) of every launch and plain-call count."""
    from mitsuba3_experiments_tpu_torch.integrators import replay, replay_cuda
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
    from mitsuba3_experiments_tpu_torch.models import fused_mlp, fused_mlp_cuda, mlp
    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda, prefix_sum_cuda

    return (("k1", bvh_cuda, "launches"), ("plain_traverse", bvh_torch, "calls"),
            ("k5_fwd", replay_cuda, "forward_launches"),
            ("k5_adj", replay_cuda, "adjoint_launches"), ("plain_replay", replay, "plain_calls"),
            ("k2", fused_mlp_cuda, "launches"), ("plain_mlp", mlp, "calls"),
            ("recomputes", fused_mlp, "recomputes"), ("k3", prefix_sum_cuda, "launches"),
            ("plain_scan", prefix_sum_cuda, "plain_calls"),
            ("k4", gather_probe_cuda, "launches"), ("plain_chain", gather_probe, "plain_calls"))


def reset_counts():
    for _, mod, attr in counters():
        setattr(mod, attr, 0)


def note_k5(label, counts, card):
    """Checks that a phase's replay ran on K5 (its forward and its adjoint)
    and never on the plain version; prints the launches beside K1's and
    adds them to K5_BY_PHASE."""
    f, a = counts["k5_fwd"], counts["k5_adj"]
    print(f"[{label}] K5 launches {f} forward + {a} adjoint, plain replays "
          f"{counts['plain_replay']}; K1 launches {counts['k1']} ({card})")
    check(f > 0 and a > 0, f"{label}: the replay did not launch K5")
    check(counts["plain_replay"] == 0, f"{label}: the replay ran its plain version")
    old = K5_BY_PHASE.get(label, (0, 0))
    K5_BY_PHASE[label] = (old[0] + f, old[1] + a)


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
    # the L2 diagnostic: the same chains over a table that fits in the 50 MB
    # L2 (65,536 rows, 23.1 MB); a time per row as on the big table means
    # that device memory is not what bounds the kernel
    small = torch.as_tensor(gather_probe.build_table(0, rows=L2_TABLE_ROWS), device=dev)
    for n in CHAIN_LANES:
        idx0 = torch.as_tensor(rng.integers(0, L2_TABLE_ROWS, n).astype(np.int32), device=dev)
        idx, acc = gather_probe_cuda.dep_chain_cuda(small, idx0, CHAIN_ITERS)
        ref_idx, ref_acc = gather_probe.dep_chain_plain(small, idx0, CHAIN_ITERS)
        check(bool(torch.equal(idx, ref_idx) and torch.equal(acc.view(torch.int32),
                                                             ref_acc.view(torch.int32))),
              f"K4 differs from the plain chain on the L2-sized table at {n} lanes")
        k_dev = device_ms(lambda idx0=idx0: gather_probe_cuda.dep_chain_cuda(
            small, idx0, CHAIN_ITERS, check=False), 20)
        print(f"[K4] L2-sized table ({L2_TABLE_ROWS} rows, {small.numel() * 4 / 1e6:.1f} MB), {n} "
              f"lanes x {CHAIN_ITERS}: equal to plain; kernel device time {k_dev:.4f} ms = "
              f"{k_dev * 1e6 / (n * CHAIN_ITERS):.4f} ns/row ({card})")
    del small
    # latency view: one chain per block on 132 blocks, so each step of a
    # chain waits for one device-memory round trip and nothing else
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
    note_k5(label, counts, card)
    return rec, g, counts, dt


def phase_production(scene, integrator, card):
    """Phase 12: the production forward, then fwd+bwd at depth 8; returns
    (forward image, fwd+bwd counts, K1's max abs error against plain on the
    recorder's first batch, the fwd+bwd gradients)."""
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

    rec, grads, counts, fb_s = fwd_bwd(scene, img, SPP, MAX_DEPTH, card, "fwd+bwd d8")
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
    return img, counts, err_k1, grads, w * h * SPP / fb_s, rec


def k5_work(scene, sl, kw):
    """The float32 operations and bytes that K5's two functions need on a
    chunk, counted from its record: the forward walks each row's path once
    for L; the adjoint walks it once more and adds the derivative terms.
    Each vertex is charged its own material's kind (the nested one under a
    mask), texture, emitter and NEE, as K5_OPS_* count them.  Each function
    reads the record entries of the hit vertices, the face rows they hit
    (distinct faces), the rows' ray indices when sorted and L or dL; the
    adjoint writes the two tables.  The escapes (at most one a row), the
    material, texture and emitter tables are left out, which only lowers
    the bound.  Returns (hit vertices, distinct faces, operations, bytes)."""
    import torch

    rows, D = sl.prim.shape
    steps = kw.get("n_steps") or D
    ids = kw["idx"] if kw.get("idx") is not None else \
        torch.arange(rows, device=sl.prim.device) + kw["idx0"]
    prim = sl.prim[:, :steps]
    hit = (prim >= 0) & (ids < kw["ray_end"])[:, None]
    col = torch.nonzero(hit)[:, 1]
    faces = prim[hit].long()
    frow = scene.geometry.face_packed[faces]
    mat = frow[:, 25].contiguous().view(torch.int32).long().clamp(min=0)
    emitter = frow[:, 26].contiguous().view(torch.int32) >= 0
    mats = scene.materials
    is_mask = mats.kind[mat] == 7
    eff = torch.where(is_mask, mats.nested_id[mat].long().clamp(min=0), mat)
    kind = mats.kind[eff].long()
    shaded = col + 1 < kw["max_depth"]
    nee = shaded & ((mats.flags[mat] & 15) != 0) & ~sl.occl[:, :steps][hit]
    textured = (mats.tex_id[eff] >= 0).long() + (is_mask & (mats.tex_id[mat] >= 0)).long()
    ops_of = lambda t: torch.tensor(t, dtype=torch.int64, device=kind.device)[kind]  # noqa: E731
    search = int(np.ceil(np.log2(scene.emitters.em_face_packed.shape[0] + 1)))
    walk = K5_OPS_HIT + emitter * K5_OPS_EMITTER_HIT + shaded * (
        K5_OPS_SHADE + search + K5_OPS_SAMPLE_COMMON + ops_of(K5_OPS_SAMPLE)
        + textured * K5_OPS_TEXTURE + is_mask * K5_OPS_MASK) + nee * (
        K5_OPS_EVAL_COMMON + ops_of(K5_OPS_EVAL) + is_mask * K5_OPS_MASK_EVAL)
    deriv = shaded * (K5_OPS_DERIV + is_mask * K5_OPS_DERIV_MASK) + emitter * K5_OPS_DERIV_EMITTER
    ops = int((2 * walk + deriv).sum())
    hits, distinct = int(faces.numel()), int(torch.unique(faces).numel())
    per_kernel = hits * K5_ENTRY_BYTES + distinct * K5_FACE_BYTES + rows * 12 \
        + (rows * 8 if kw.get("idx") is not None else 0)
    tables = (mats.base_color.shape[0] + scene.emitters.radiance.shape[0]) * 12
    return hits, distinct, ops, 2 * per_kernel + tables


def k5_case(name, scene, sl, kw, card, seed_dl):
    """Phase 12c on one chunk: K5's L and gradients (of sum(L * dL), dL a
    seeded normal) against replay_radiance_plain's L and autograd gradients
    on the same card tensors, then both timed with CUDA events in turns
    (plain, kernel, kernel, plain).  Returns a dict of the numbers."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import replay, replay_cuda
    from mitsuba3_experiments_tpu_torch.scene import params

    rows, D = sl.prim.shape
    tabs = {k: params.traverse(scene)[k].detach().clone() for k in DIFF_KEYS}
    dL = torch.as_tensor(np.random.default_rng(seed_dl).normal(size=(rows, 3)),
                         dtype=torch.float32, device=sl.prim.device)
    packed = replay_cuda.pack_args(scene, sl, **kw)
    # rows whose radiance is not finite carry no gradient (the film's splat
    # zeroes them): K5 must give non-finite values on the plain replay's
    # rows and no others, and dL is 0 on those rows for both versions
    with torch.no_grad():
        fin_plain = torch.isfinite(replay.replay_radiance_plain(scene, sl, **kw)[0]).all(dim=1)
    fin_k5 = torch.isfinite(replay_cuda.replay_forward(packed)).all(dim=1)
    check(bool(torch.equal(fin_k5, fin_plain)),
          f"12c {name}: K5's non-finite rows ({int((~fin_k5).sum())}) are not the plain "
          f"replay's ({int((~fin_plain).sum())})")
    dL[~fin_plain] = 0.0

    def kernel_fwd():
        return replay_cuda.replay_forward(packed)

    def kernel_adj():
        return replay_cuda.replay_adjoint(packed, dL)

    def plain():
        q = {k: v.clone().requires_grad_(True) for k, v in tabs.items()}
        L = replay.replay_radiance_plain(params.update(scene, q), sl, **kw)[0]
        return L.detach(), torch.autograd.grad((L * dL).sum(), list(q.values()))

    torch.cuda.synchronize()
    t_plain, t_fwd, t_adj, dev_fwd, dev_adj = [], [], [], [], []
    ref_L, ref_g = None, None
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = plain()
            end.record()
            torch.cuda.synchronize()
            t_plain.append(start.elapsed_time(end))
            if ref_L is None:
                ref_L, ref_g = out
            del out
        else:
            L, g = kernel_fwd(), kernel_adj()
            torch.cuda.synchronize()
            t_fwd.append(cuda_ms(kernel_fwd, 5))
            t_adj.append(cuda_ms(kernel_adj, 5))
            dev_fwd.append(device_ms(kernel_fwd, 5))
            dev_adj.append(device_ms(kernel_adj, 5))
    fin = torch.isfinite(L).all(dim=1) & torch.isfinite(ref_L).all(dim=1)
    close = float(torch.isclose(L, ref_L, rtol=1e-4, atol=1e-5, equal_nan=True)
                  .all(dim=1).float().mean())
    err = float((L[fin] - ref_L[fin]).abs().max())
    print(f"[12c {name}] {rows} rows x {D}, {kw.get('n_steps') or D} steps: L of K5 within rtol "
          f"1e-4 / atol 1e-5 of the plain replay on {close:.6f} of the rows, max abs err "
          f"{err:.3e} ({int((~fin).sum())} rows not finite)")
    check(close >= 0.9999, f"12c {name}: only {close:.6f} of K5's rows equal the plain replay's")
    for k, gk, gr in zip(DIFF_KEYS, g, ref_g):
        scale = float(gr.abs().max())
        worst = float((gk - gr).abs().max())
        print(f"[12c {name}] d sum(L dL) / d {k}: max |g| {scale:.6e}, max |K5 - plain| "
              f"{worst:.3e}")
        check(scale > 0 and bool(torch.isfinite(gk).all()), f"12c {name}: no gradient of {k}")
        check(bool(torch.allclose(gk, gr, rtol=1e-3, atol=1e-4 * scale)),
              f"12c {name}: K5's gradient of {k} differs from the plain replay's")
    hit_vertices, distinct, ops, nbytes = k5_work(scene, sl, kw)
    bound = max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_S >= ops / F32_OPS_S else "operations"
    ms = float(np.mean(t_fwd) + np.mean(t_adj))
    dev = float(np.mean(dev_fwd) + np.mean(dev_adj))
    print(f"[12c {name}] in turns (plain, kernel, kernel, plain): plain fwd+bwd "
          f"{t_plain[0]:.3f}, {t_plain[1]:.3f} ms; K5 forward {t_fwd[0]:.4f}, {t_fwd[1]:.4f} ms "
          f"(device {dev_fwd[0]:.4f}, {dev_fwd[1]:.4f}), adjoint {t_adj[0]:.4f}, {t_adj[1]:.4f} "
          f"ms (device {dev_adj[0]:.4f}, {dev_adj[1]:.4f}) ({card})")
    print(f"[12c {name}] bound: {hit_vertices} hit vertices on {distinct} faces, "
          f"{ops / hit_vertices:.1f} float32 operations a vertex, {nbytes / 1e6:.2f} MB = "
          f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms, {ops / 1e9:.3f} G float32 operations = "
          f"{ops / F32_OPS_S * 1e3:.4f} ms: {bound:.4f} ms by {by}; K5 (forward + adjoint) "
          f"{ms:.4f} ms, at {bound / ms:.4f} of it; plain {np.mean(t_plain) / ms:.1f}x K5")
    return {"err": err, "ms": ms, "device_ms": dev, "plain_ms": float(np.mean(t_plain)),
            "bound_ms": bound, "bound_by": by}


def phase_k5(scene, card, rec8, rec65, target):
    """Phase 12c: K5 against replay_radiance_plain on the first 131,072 rows
    of phase 12's record (depth 8) and on the longest chunk of phase 13's
    (depth 65) as replay_grads_sorted sorts it, each timed beside its bound;
    then one replay_grads_full chunk (depth 8) under torch.profiler: its
    device busy share, device operations and the host's aten operators.
    Returns the depth-8 numbers for the kernels' JSON line (and the
    depth-65 ones under "d65")."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import path_lengths, replay, replay_grads_full
    from mitsuba3_experiments_tpu_torch.scene import params

    w, h = RES
    d8 = k5_case("depth 8, first chunk", scene, rec8.rows(slice(0, REPLAY_CHUNK)),
                 dict(seed=0, idx0=0, spp=SPP, max_depth=MAX_DEPTH, rr_depth=4,
                      ray_end=w * h * SPP), card, 8)
    lens = path_lengths(rec65)
    order = torch.argsort(-lens, stable=True)[:REPLAY_CHUNK]
    steps = min(c for c in replay._depth_classes(DEEP) if c >= int(lens[order[0]]))
    d65 = k5_case("depth 65, longest sorted chunk", scene, rec65.rows(order),
                  dict(seed=0, idx0=0, idx=order, n_steps=steps, spp=1, max_depth=DEEP,
                       rr_depth=4, ray_end=w * h), card, 65)
    del order, lens

    prof_mod = load_by_path(os.path.join("scripts", "torch_profile_render.py"))
    diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}
    chunk = rec8.rows(slice(0, REPLAY_CHUNK))

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        replay_grads_full(scene, diff, params.update, target, 0, chunk, w * h * SPP,
                          chunk=REPLAY_CHUNK, spp=SPP, max_depth=MAX_DEPTH, rr_depth=4)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run()
    wall = [run() for _ in range(3)]
    wall_s, prof = prof_mod.profiled(run)
    events, busy, by_kind = prof_mod.device_breakdown(
        prof, os.path.join("out", "chip_smoke_k5_chunk.trace.json"))
    aten = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    print(f"[12c profile] one replay_grads_full chunk of {REPLAY_CHUNK} rows (depth 8): wall "
          + ", ".join(f"{x * 1e3:.2f}" for x in wall) + f" ms unprofiled; profiled "
          f"{wall_s * 1e3:.2f} ms, device busy {busy:.3f} ms (share {busy / (wall_s * 1e3):.4f} "
          f"profiled, {busy / (np.median(wall) * 1e3):.4f} of the unprofiled median), "
          f"{len(events)} device operations, {aten} aten operators ({card})")
    for k, (c, ms) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"[12c profile]   {k:28s} {c:5d} ops {ms:10.3f} ms")
    d8["d65"] = d65
    d8["err"] = max(d8["err"], d65["err"])
    return d8


def phase_card_vs_cpu_replay(device, card):
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
        if dev.type == "cuda":
            torch.cuda.synchronize()
            reset_counts()
        g = replay_grads(scene, diff, params.update, target, 3, rec, n, chunk=pad // 2, spp=spp,
                         max_depth=depth, rr_depth=4, mode="full")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            note_k5("14 replay on the card", read_counts(), card)
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


def pass0_ms(made, reps=5):
    """K1 alone (no overflow check) on each launch `made` of a pass: device
    ms of each, as `device_ms` gives it."""
    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda

    out = []
    for args, kw, _ in made:
        def launch(args=args, kw=kw):
            bvh_cuda._launch(*args, **kw)

        launch()
        out.append(device_ms(launch, reps))
    return out


def k1_least_ms(n, rows, leaf, distinct):
    """K1's least time on a closest-hit batch of n rays whose plain
    traversal fetched `rows` rows (`leaf` of them leaf rows, `distinct`
    distinct): each distinct row read once plus the rays in and the hits
    out, or its float operations; returns (ms, "bytes" or "operations",
    bytes, operations)."""
    nbytes = distinct * ROW_BYTES + n * (12 + 12 + 4 + 1 + 16)
    ops = (rows - leaf) * K1_OPS_INTERNAL_ROW + leaf * K1_OPS_LEAF_ROW
    bound = max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
    return bound, ("bytes" if nbytes / HBM_BYTES_S >= ops / F32_OPS_S else "operations"), \
        nbytes, ops


def phase_trees(sbvh_scene, sbvh_made, sbvh_rows, scene_dict, integrator, card):
    """Phase 5b: the stand-in built with object splits only, against the
    spatial-split tree (`sbvh_rows`: phase 5's plain row counts of its
    camera batch, (rows, leaf rows, distinct rows)): build seconds, K1 held
    against plain on the object-split tree's camera batch, rows fetched per
    camera ray and the bound from the distinct rows each tree's camera batch
    reaches, and K1's device time on the camera batch and summed over the
    pass's launches, timed in turns (spatial, object, object, spatial).
    Returns (the turns' times, K1's max abs error on the camera batch)."""
    import torch

    from mitsuba3_experiments_tpu_torch.intersect import bvh_torch
    from mitsuba3_experiments_tpu_torch.scene import load_dict
    from mitsuba3_experiments_tpu_torch.scene.bvh8 import BVHLayout

    t0 = time.perf_counter()
    obj_scene, _ = load_dict(scene_dict, bvh_layout=BVHLayout(sbvh=False),
                             device=sbvh_scene.device)
    print(f"[trees] object-split stand-in: {obj_scene.bvh.unified.shape[0]} BVH rows, "
          f"{int((obj_scene.bvh.leaf_face >= 0).sum())} leaf slots, build "
          f"{time.perf_counter() - t0:.2f} s")
    obj_made = render_queries(obj_scene, integrator)
    rows0, leaf0 = bvh_torch.rows, bvh_torch.leaf_rows
    args, kw, out_k = obj_made[0]
    out_p = bvh_torch.traverse_plain(*args, any_hit=False, layout=kw["layout"])
    torch.cuda.synchronize()
    err = hold("object-split camera batch", out_k, out_p, False, int(args[5].sum()))
    obj_rows = (bvh_torch.rows - rows0, bvh_torch.leaf_rows - leaf0, bvh_torch.last_distinct_rows)
    trees = {"sbvh": (sbvh_scene, sbvh_made), "object": (obj_scene, obj_made)}
    for (name, (sc, made)), (rows, leaf, distinct) in zip(trees.items(), (sbvh_rows, obj_rows)):
        n = made[0][0][2].shape[0]
        bound, by, _, _ = k1_least_ms(n, rows, leaf, distinct)
        print(f"[trees] {name}: camera batch of {n} rays fetched {rows} rows ({rows / n:.3f} per "
              f"ray, {leaf} leaf), {distinct} distinct of {sc.bvh.unified.shape[0]}: bound "
              f"{bound:.4f} ms by {by}; the pass made {len(made)} launches")
    turns = {"sbvh": [], "object": []}
    for name in ("sbvh", "object", "object", "sbvh"):
        per = pass0_ms(trees[name][1])
        turns[name].append((per[0], sum(per)))
        print(f"[trees] {name}: K1 device time, camera batch {per[0]:.4f} ms, pass-0 sum of "
              f"{len(per)} launches {sum(per):.4f} ms ({card})")
    del obj_made, trees, obj_scene
    return turns, err


def phase_diff_render(dev, card):
    """Phase 6b: the differentiable lockstep render on the 32x32 Cornell box
    with a sphere (spp 4, depth 4): the gradients of an MSE with respect to
    the base colours and emitter radiances on the card against the CPU's
    (rtol 1e-3 / atol 1e-4 max|g|), and against the card's replay
    (replay_render_grad, same seed; rtol 5e-3 / atol 5e-4 max|g|, the JAX
    package's replay-against-AD tolerance); returns the K1 launches of the
    card's render and backward."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import (
        PathIntegrator, render, replay_render_grad)
    from mitsuba3_experiments_tpu_torch.scene import params

    spp, depth = 4, 4
    out = {}
    for d in (dev, torch.device("cpu")):
        scene = small_nerad_scene(d)
        with torch.no_grad():
            target = render(scene, PathIntegrator(max_depth=depth), seed=9, spp=spp)
        p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True)
             for k in DIFF_KEYS}
        if d.type == "cuda":
            torch.cuda.synchronize()
            reset_counts()
        t0 = time.perf_counter()
        img = render(params.update(scene, p), PathIntegrator(max_depth=depth, differentiable=True),
                     seed=5, spp=spp)
        ((img - target) ** 2).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            print(f"[diff render] 32x32 spp {spp} depth {depth} on the card: render + backward "
                  f"{time.perf_counter() - t0:.3f} s, counts {counts} ({card})")
            check(counts["k1"] > 0 and counts["plain_traverse"] == 0,
                  "the differentiable render did not run its queries on K1 alone")
            w, h = scene.camera.resolution
            reset_counts()
            rep = replay_render_grad(scene, {k: params.traverse(scene)[k] for k in DIFF_KEYS},
                                     params.update, target, 5, 0, w * h * spp, spp=spp,
                                     max_depth=depth, rr_depth=4)
            torch.cuda.synchronize()
            note_k5("6b replay_render_grad", read_counts(), card)
        out[d.type] = {k: p[k].grad.cpu().numpy() for k in DIFF_KEYS}
    for k in DIFF_KEYS:
        gc, gh, gr = out["cuda"][k], out["cpu"][k], rep[k].cpu().numpy()
        scale = float(np.abs(gh).max())
        worst = float((np.abs(gc - gh) - 1e-3 * np.abs(gh)).max())
        worst_r = float((np.abs(gr - gc) - 5e-3 * np.abs(gc)).max())
        print(f"[diff render] d loss / d {k}: max |g| {scale:.6e}; card vs cpu largest |diff| - "
              f"1e-3 |cpu| {worst:.3e} (atol {1e-4 * scale:.3e}); replay vs AD on the card "
              f"largest |diff| - 5e-3 |AD| {worst_r:.3e} (atol {5e-4 * scale:.3e})")
        check(scale > 0 and bool(np.isfinite(gc).all()), f"no finite gradient of {k}")
        check(bool(np.allclose(gc, gh, rtol=1e-3, atol=1e-4 * scale)),
              f"the card's AD gradient of {k} differs from the CPU's")
        check(bool(np.allclose(gr, gc, rtol=5e-3, atol=5e-4 * float(np.abs(gc).max()))),
              f"the card's replay gradient of {k} differs from its AD gradient")
    return counts["k1"]


# per-chunk maxima of path length are extreme-value statistics: at depth 16
# every chunk of 64 or more of the stand-in's camera rays holds a path of
# 9 or more bounces, so none falls to a shorter depth class; at depth 32
# chunks of 64 often end by 16.  Each chunk's replay costs ~1 s of host
# time at this depth, so the frame is kept to 9 chunks.
TRUNC_RES = (32, 18)
TRUNC_DEPTH = 32
TRUNC_CHUNK = 64


def phase_trunc(scene, card):
    """Phase 13b: replay_grads(mode="trunc") on a small stand-in frame (the
    stand-in's camera at 32x18, spp 1, depth 32, chunks of 64 rows), where
    at least one chunk's paths end by half the depth: gradients finite and
    nonzero, timed once.  'trunc' is the full replay (replay_radiance leaves
    a chunk's depth loop once no row is live), which the CPU tests hold
    against the JAX package's truncated replay.  Returns the record's K1
    launches."""
    import dataclasses

    import torch

    from mitsuba3_experiments_tpu_torch.integrators import (
        path_lengths, record_full_pipelined, render_persistent, replay_grads)
    from mitsuba3_experiments_tpu_torch.scene import params

    small = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera,
                                                                  resolution=TRUNC_RES))
    w, h = TRUNC_RES
    n = w * h
    pad = -(-n // TRUNC_CHUNK) * TRUNC_CHUNK
    target = render_persistent(small, seed=1, spp=1, max_depth=TRUNC_DEPTH, rr_depth=4)
    torch.cuda.synchronize()
    reset_counts()
    rec = record_full_pipelined(small, 0, n, spp=1, max_depth=TRUNC_DEPTH, rr_depth=4,
                                pad_to=pad)
    torch.cuda.synchronize()
    launches = read_counts()["k1"]
    lens = path_lengths(rec).reshape(-1, TRUNC_CHUNK).amax(dim=1).tolist()
    short = sum(1 for x in lens if x <= TRUNC_DEPTH // 2)
    print(f"[trunc] {w}x{h} spp 1 depth {TRUNC_DEPTH}: {len(lens)} chunks of {TRUNC_CHUNK}, "
          f"longest path per chunk {lens}; {short} chunks truncated")
    check(short > 0, "no chunk of the trunc replay is truncated")
    diff = {k: params.traverse(small)[k] for k in DIFF_KEYS}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    grads = replay_grads(small, diff, params.update, target, 0, rec, n, chunk=TRUNC_CHUNK,
                         spp=1, max_depth=TRUNC_DEPTH, rr_depth=4, mode="trunc")
    torch.cuda.synchronize()
    print(f"[trunc] replay_grads(mode='trunc'): {time.perf_counter() - t0:.3f} s ({card})")
    note_k5("13b trunc replay", read_counts(), card)
    for k in DIFF_KEYS:
        g = grads[k]
        scale = float(g.abs().max())
        print(f"[trunc] d loss / d {k}: max |g| {scale:.6e}")
        check(scale > 0 and bool(torch.isfinite(g).all()), f"trunc: no finite gradient of {k}")
    return launches


NRC_BATCH = 16_384
NRC_STEPS = 24


def phase_nrc(scene, card, steps=NRC_STEPS):
    """Phase 8b: NRCTrainer(FieldConfig(fused=True)) on the stand-in, batch
    16,384: every loss finite, K1 and K2 launched, no plain traversal and no
    plain MLP forward outside the backward's recompute; every K1 launch of
    the first step held against the plain traversal on the same tensors, as
    in phase 3; K2 held against apply_mlp on the rows of the first step's
    cache queries (at least 0.99 of the rows within 1e-5) and timed there;
    then the stand-in rendered at 1280x720 spp 1 by NRCIntegrator with the
    trained cache, and again with the plain MLP (FieldConfig(fused=False))
    in the same cache: the images allclose within rtol 2e-2 / atol 2e-3
    (K2's bf16 rounding, as tests/test_torch_cuda.py holds them).  Returns
    (training counts, render counts, K2's rows and device ms per query,
    K1's and K2's max abs errors)."""
    import dataclasses

    import torch

    from mitsuba3_experiments_tpu_torch.integrators import NRCIntegrator, NRCTrainer, render
    from mitsuba3_experiments_tpu_torch.intersect import bvh_torch
    from mitsuba3_experiments_tpu_torch.models import (
        FieldConfig, apply_mlp, fused_mlp, fused_mlp_cuda)

    cfg = FieldConfig(fused=True)
    trainer = NRCTrainer(field_cfg=cfg, batch_size=NRC_BATCH)
    init, step = trainer.make_train_step(scene)
    field, opt = init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    reset_counts()
    launch = fused_mlp_cuda.fused_mlp_cuda
    queries = []

    def recording(params_flat, x, *args):
        queries.append((x.detach(), args))
        return launch(params_flat, x, *args)

    losses, step_s, made = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        if i == 0:   # the first step's K1 and K2 launches kept for the checks
            fused_mlp_cuda.fused_mlp_cuda = recording
            try:
                made = k1_launches(lambda: losses.append(step(field, opt, i)))
            finally:
                fused_mlp_cuda.fused_mlp_cuda = launch
        else:
            losses.append(step(field, opt, i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    print(f"[nrc] {steps} steps of batch {NRC_BATCH}: median step {np.median(step_s[5:]):.4f} s, "
          f"first {step_s[0]:.4f} s; losses first {losses[:3].tolist()} last "
          f"{losses[-3:].tolist()}; counts {train} ({card})")
    check(bool(np.isfinite(losses).all()), "an NRC loss is not finite")
    check(train["k1"] > 0 and train["k2"] > 0, "NRC training did not launch K1 and K2")
    check(train["plain_traverse"] == 0, "NRC training ran the plain traversal")
    check(train["plain_mlp"] == train["recomputes"],
          "NRC training ran the plain MLP forward outside the backward's recompute")
    err_k1, plain_s = 0.0, 0.0
    for i, (args, kw, out_k) in enumerate(made):
        t0 = time.perf_counter()
        out_p = bvh_torch.traverse_plain(*args, any_hit=kw["any_hit"], layout=kw["layout"])
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        kind = "shadow" if kw["any_hit"] else "closest"
        err_k1 = max(err_k1, hold(f"nrc step0 #{i} {kind}", out_k, out_p, kw["any_hit"],
                                  int(args[5].sum())))
    check(len(made) > 0, "the first NRC step made no K1 launch")
    print(f"[nrc] the first step: {len(made)} K1 launches held against plain ({plain_s:.1f} s "
          f"of plain), max abs err {err_k1:.3e}")
    del made
    # K2 on the cache-query rows of the first step, with the field as it is now
    k2_rows, k2_dev, err_k2 = 0, 0.0, 0.0
    flat = tuple(t.detach() for t in fused_mlp.mlp_params_flat(field.mlp))
    with torch.no_grad():
        for x, args in queries:
            got = launch(flat, x, *args)
            ref = apply_mlp([{"w": w, "b": b} for w, b in zip(flat[0::2], flat[1::2])], x)
            torch.cuda.synchronize()
            close = float(torch.isclose(got, ref, rtol=1e-5, atol=1e-5).all(dim=1).float().mean())
            err = float((got - ref).abs().max())
            err_k2 = max(err_k2, err)
            k2_rows = x.shape[0]
            k2_dev = device_ms(lambda: launch(flat, x, *args), 20)
            print(f"[nrc] K2 on a cache query of {k2_rows} rows: rows equal to apply_mlp within "
                  f"1e-5 {close:.6f}, max abs err {err:.3e}; device time {k2_dev:.4f} ms ({card})")
            check(close >= 0.99, f"K2 on the NRC query rows: only {close:.6f} rows equal apply_mlp")
    check(len(queries) == 2, f"an NRC step made {len(queries)} K2 launches, not 2")

    w, h = scene.camera.resolution
    integ = NRCIntegrator(max_depth=trainer.max_depth, spread_c=trainer.spread_c,
                          cache=(field, trainer))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = render(scene, integ, spp=1)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    rend = read_counts()
    img_np = img.cpu().numpy()
    print(f"[nrc] render {w}x{h} spp 1 with the cache: {render_s:.3f} s, image mean "
          f"{img_np.mean():.6f}, counts {rend} ({card})")
    check(bool(np.isfinite(img_np).all()) and float(img_np.mean()) > 0.0,
          "the NRC image is not finite or is black")
    check(rend["k2"] > 0 and rend["plain_mlp"] == 0 and rend["plain_traverse"] == 0,
          "the NRC render did not run on K1 and K2 alone")
    plain = dataclasses.replace(trainer, field_cfg=dataclasses.replace(cfg, fused=False))
    ref = render(scene, dataclasses.replace(integ, cache=(field, plain)), spp=1)
    err = float((img - ref).abs().max())
    close = float(torch.isclose(img, ref, rtol=1e-5, atol=1e-5).all(dim=-1).float().mean())
    print(f"[nrc] the same render with the plain MLP: image mean {float(ref.mean()):.6f}, max abs "
          f"diff {err:.3e}, pixels within 1e-5 {close:.6f}")
    check(bool(torch.allclose(img, ref, rtol=2e-2, atol=2e-3)),
          f"the NRC render on K2 differs from the plain MLP's (max abs diff {err:.3e})")
    return train, rend, k2_rows, k2_dev, err_k1, err_k2


# ---- phases 15a-15g and 16: the integrator zoo ------------------------------

ZOO_HOLD_LANES = 65_536
ZOO_SMALL_TOL = (1e-3, 1e-4)   # card against CPU: rtol, atol (as phase 6)


def hold_first_lanes(name, made):
    """K1 against the plain traversal on a launch's first ZOO_HOLD_LANES
    active lanes; returns the max abs error (phase 3's checks)."""
    import torch

    from mitsuba3_experiments_tpu_torch.intersect import bvh_torch

    (unified, n_nodes, o, d, maxt, active), kw, out_k = made
    idx = torch.nonzero(active).squeeze(1)[:ZOO_HOLD_LANES]
    sub = (o[idx].contiguous(), d[idx].contiguous(), maxt[idx].contiguous(),
           torch.ones(idx.shape, dtype=torch.bool, device=o.device))
    out_p = bvh_torch.traverse_plain(unified, n_nodes, *sub, any_hit=kw["any_hit"],
                                     layout=kw["layout"])
    return hold(name, tuple(x[idx] for x in out_k), out_p, kw["any_hit"], idx.numel())


def zoo_stage(label, run, card, units, n_units, shadow_rays):
    """Runs one integrator of phase 15 on the stand-in: seconds, units/s,
    K1's launches (and no plain traversal), the image finite and above 0,
    K1 held against plain on its first closest-hit launch and, where the
    integrator traces shadow or connection rays (`shadow_rays`), its first
    any-hit launch.  Returns (image as numpy, K1 launches, max abs err,
    seconds)."""
    import torch

    out = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    made = k1_launches(lambda: out.append(run()), first_only=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    first = {}
    for launch in made:
        first.setdefault(launch[1]["any_hit"], launch)
    del made
    img = out[0].cpu().numpy()
    print(f"[{label}] {secs:.3f} s, {n_units / secs:.1f} {units}/s, K1 launches {counts['k1']}, "
          f"plain traversals {counts['plain_traverse']} ({card})")
    print(f"[{label}] image mean {img.mean():.6f} (channels "
          + ", ".join(f"{c:.6f}" for c in img.reshape(-1, 3).mean(0)) + ")")
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"{label}: the image is not finite or is black")
    check(counts["k1"] > 0 and counts["plain_traverse"] == 0,
          f"{label}: the ray queries did not run on K1 alone")
    kinds = {False, True} if shadow_rays else {False}
    check(set(first) == kinds, f"{label}: K1 launched for {sorted(first)} (any_hit), not "
          f"{sorted(kinds)}")
    err = max(hold_first_lanes(f"{label} first {'any' if k else 'closest'} hit", first[k])
              for k in kinds)
    return img, counts["k1"], err, secs


def mean_ratio(label, img, ref, lo, hi, mask=None):
    """Checks lo < mean(img) / mean(ref) < hi (over `mask` when given)."""
    if mask is not None:
        img, ref = img[mask], ref[mask]
    r = float(img.mean()) / float(ref.mean())
    print(f"[{label}] mean against render_persistent's: ratio {r:.4f} (bounds {lo}, {hi})")
    check(lo < r < hi, f"{label}: image mean ratio {r:.4f} to the path render outside ({lo}, {hi})")


def phase_zoo(scene, card, ref):
    """Phases 15a-15g: each integrator of the zoo on the stand-in at
    1280x720, its image mean against render_persistent's `ref` (spp 4,
    depth 8, tent) at the tolerance of the JAX package's own test of it
    (PERF.md, PR 7 findings, for the bounds that test does not give).
    Returns ({phase: K1 launches}, max abs err of the holds, 15a's image)."""
    from mitsuba3_experiments_tpu_torch.integrators import (
        BDPTIntegrator, ParticleTracer, RestirGI, SimpleIntegrator, SpectralIntegrator, SPPM,
        render, render_spectral, render_wavefront)

    w, h = RES
    launches, err = {}, 0.0

    def stage(key, label, run, units="camera rays", n_units=w * h, shadow_rays=True):
        nonlocal err
        img, k1, e, _ = zoo_stage(f"{key} {label}", run, card, units, n_units, shadow_rays)
        launches[key] = k1
        err = max(err, e)
        return img

    # 15a: BSDF sampling only; tests/test_golden_oracle.py holds its mean to
    # 3%, on the Cornell box; on the stand-in the path tracer reads low
    # behind null and mask surfaces, which NEE's shadow rays take for opaque
    # and BSDF sampling does not (PERF.md, PR 7: 1.0334 in run 2)
    simple_img = stage("15a", "simple spp 4 depth 8",
                       lambda: render(scene, SimpleIntegrator(max_depth=8), spp=SPP,
                                      rfilter="tent"),
                       n_units=w * h * SPP, shadow_rays=False)
    mean_ratio("15a simple", simple_img, ref, 0.97, 1.06)
    # 15b: the same per-ray estimates as render_persistent, filter splats in
    # another order (tests/test_wavefront.py: atol 5e-5 against render())
    img = stage("15b", "render_wavefront spp 4 depth 8 tent",
                lambda: render_wavefront(scene, spp=SPP, max_depth=MAX_DEPTH, rfilter="tent"),
                n_units=w * h * SPP)
    diff = float(np.abs(img - ref).max())
    print(f"[15b render_wavefront] max abs diff to render_persistent's image {diff:.3e}")
    check(diff <= 5e-5, f"render_wavefront differs from render_persistent by {diff:.3e}")
    # 15c: light paths splatted to the camera (W*H of them at spp 1, in
    # passes of 2^18 whose remainder is dropped, as in JAX); the
    # direct-emission pass adds W*H camera rays
    chunk = min(w * h, 1 << 18)
    n_paths = max(w * h // chunk, 1) * chunk
    img = stage("15c", "ptracer spp 1", lambda: ParticleTracer().render(scene, spp=1),
                units="light paths", n_units=n_paths)
    # the JAX test's (0.9, 1.1) is for the diffuse Cornell box; the particle
    # tracer cannot connect camera-visible delta surfaces (PERF.md, PR 7)
    mean_ratio("15c ptracer", img, ref, 0.8, 1.1)
    # 15d: tests/test_spectral.py holds channel means to rtol 0.2 under the
    # Cornell box's white light; the stand-in's warm lights read brighter
    # after upsampling and white balance (PERF.md, PR 7)
    img = stage("15d", "render_spectral spp 1 depth 8",
                lambda: render_spectral(scene, SpectralIntegrator(max_depth=8), spp=1),
                shadow_rays=False)
    for c in range(3):
        mean_ratio(f"15d spectral channel {c}", img[..., c], ref[..., c], 0.8, 1.3)
    # 15e: max_depth cut from 16 to 8 for time; the JAX test's 5% is for the
    # diffuse Cornell box: the stand-in's null and mask surfaces block
    # connections and NEE alike, and its estimate is heavy-tailed (PERF.md)
    img = stage("15e", "bdpt spp 1 max_depth 8",
                lambda: render(scene, BDPTIntegrator(max_depth=8), spp=1))
    mean_ratio("15e bdpt", img, ref, 0.85, 1.05)
    # 15f: two frames at its defaults; tests/test_bdpt_sppm.py holds the
    # mean over pixels brighter than 0.05 within a factor of 2 at 32x32; at
    # 1280x720 a cell holds far more than the 32 visible points a photon
    # looks at (max_per_cell), so most get none (PERF.md, PR 7: 0.3990)
    sppm = SPPM()

    def sppm_frames():
        st = sppm.init_state(scene)
        for i in range(2):
            img, st = sppm.render_frame(scene, st, i)
        return img

    img = stage("15f", "sppm two frames", sppm_frames, units="photons",
                n_units=2 * sppm.photon_count, shadow_rays=False)
    mean_ratio("15f sppm", img, ref, 0.3, 2.0, mask=ref.mean(-1) > 0.05)
    # 15g: two banded frames at its defaults but the inner path's depth, cut
    # from 8 to 4 for time, their average; the JAX test's 12% is for the
    # average of 16 frames after 8 (PERF.md, PR 7)
    restir = RestirGI(max_depth=4)

    def restir_frames():
        st, acc = restir.init_state(scene), 0.0
        for i in range(2):
            img, st = restir.render_frame_chunked(scene, st, i)
            acc = acc + img
        return acc / 2

    img = stage("15g", "restirgi two banded frames depth 4", restir_frames, n_units=2 * w * h)
    mean_ratio("15g restirgi", img, ref, 0.25, 2.5)
    return launches, err, simple_img


def zoo_small_runs():
    """(name, run(scene) -> image) of each new integrator at phase 16's
    small settings."""
    from mitsuba3_experiments_tpu_torch.integrators import (
        BDPTIntegrator, ParticleTracer, RestirGI, SimpleIntegrator, SpectralIntegrator, SPPM,
        render, render_spectral, render_wavefront)

    def frames(integ, step):
        def run(scene):
            st = integ.init_state(scene)
            for i in range(2):
                img, st = step(integ, scene, st, i)
            return img
        return run

    return (
        ("simple", lambda s: render(s, SimpleIntegrator(max_depth=3), spp=2)),
        ("render_wavefront", lambda s: render_wavefront(s, spp=2, max_depth=3, rfilter="tent")),
        ("ptracer", lambda s: ParticleTracer(max_depth=3).render(s, spp=1)),
        ("render_spectral", lambda s: render_spectral(s, SpectralIntegrator(max_depth=3),
                                                      spp=2)),
        ("bdpt", lambda s: render(s, BDPTIntegrator(max_depth=3), spp=1)),
        ("bdpt (1,1)", lambda s: render(s, BDPTIntegrator(max_depth=3, mis=False), spp=1)),
        ("sppm", frames(SPPM(max_depth=3, photon_count=1 << 12, initial_radius=0.1),
                        lambda i, s, st, k: i.render_frame(s, st, k))),
        ("restirgi", frames(RestirGI(max_depth=2),
                            lambda i, s, st, k: i.render_frame_chunked(s, st, k, chunk=512))),
    )


def phase_zoo_card_vs_cpu(device):
    """Phase 16: each new integrator on the Cornell box + a 4k-triangle
    sphere at 32x32, on the card (K1) and on the CPU (the plain traversal,
    whose path the CPU tests hold against the JAX package): means within
    1e-3 relative, at least 0.99 of the pixels within rtol 1e-3 / atol
    1e-4, as phase 6."""
    import torch

    rtol, atol = ZOO_SMALL_TOL
    cpu_scene = small_nerad_scene(torch.device("cpu"))
    card_scene = small_nerad_scene(device)
    for name, run in zoo_small_runs():
        reset_counts()
        got = run(card_scene).cpu().numpy()
        k1 = read_counts()["k1"]
        ref = run(cpu_scene).numpy()
        rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
        close = float(np.isclose(got, ref, rtol=rtol, atol=atol).all(-1).mean())
        print(f"[16 {name}] 32x32 cornell+sphere: mean card {got.mean():.6f} cpu {ref.mean():.6f} "
              f"(rel {rel:.2e}), pixels within rtol {rtol}/atol {atol}: {close:.4f}, K1 "
              f"launches {k1}")
        check(k1 > 0, f"16 {name}: the card run did not launch K1")
        check(rel < 1e-3, f"16 {name}: card and CPU image means differ by {rel:.2e}")
        check(close >= 0.99, f"16 {name}: only {close:.4f} of the pixels agree with the CPU")

# ---- phases 17a-17e and 18: the MCMC and learned-sampling slice -------------

PSSMLT_ITERS = 60          # 40 of them bootstrap rounds, as the JAX tests run it
# the JAX tests' 400 steps of the same checks, not train_flow's default 2000:
# at 12.8 and 41.7 ms a host-bound step (affine, rqs; PERF.md) 2000 steps
# would take 109 s, over the whole budget of phases 17-18
FLOW_ITERS, FLOW_BATCH = 400, 4096
REPARAM_ITERS, REPARAM_BATCH = 1000, 4096
BUMP, BUMP_SIG = (0.7, 0.3), 0.2   # tests/test_models.py's reparam target


def phase_pssmlt(scene, card, ref, simple_ref):
    """Phases 17a-17b: Pssmlt on the stand-in at 1280x720, one chain per
    pixel (921,600), depth 8, rr_depth 4, PSSMLT_ITERS rounds, through
    `run_chains` (what `render` runs); each timed with its K1 launches (and
    no plain traversal), its first closest-hit (and, in path mode, any-hit)
    launch held against plain on 65,536 lanes.  b, the bootstrap rounds'
    mean luminance (36,864,000 uniform samples), is held within 0.05
    relative of the mean luminance of render_persistent's image (path mode)
    or SimpleIntegrator's (simple mode), the same estimators' images.  The
    path-mode image mean is held within 0.1 of render_persistent's
    (tests/test_mcmc.py's bound); the simple-mode image's ratio is printed:
    the chains start from the bootstrap's last state, not from the
    stationary distribution, and with BSDF sampling alone the image reads
    far low for hundreds of rounds (PERF.md; ROADMAP queue 3).
    Returns ({phase: K1 launches}, max abs err of the holds)."""
    import torch

    from mitsuba3_experiments_tpu_torch.core import math as m
    from mitsuba3_experiments_tpu_torch.integrators import Pssmlt

    w, h = RES
    launches, err = {}, 0.0
    for key, mode, against, name, shadow in (("17a", "path", ref, "render_persistent's", True),
                                             ("17b", "simple", simple_ref, "15a simple's", False)):
        integ = Pssmlt(max_depth=MAX_DEPTH, rr_depth=4, mode=mode)
        label = f"{key} pssmlt {mode}"
        b = []

        def run():
            state, accum = integ.run_chains(scene, seed=0, n_iterations=PSSMLT_ITERS)
            b.append(float(integ.normalization(state)))
            return (accum / (PSSMLT_ITERS - integ.bootstrap_count)).reshape(h, w, 3)

        img, k1, e, secs = zoo_stage(label, run, card, "chain-steps", w * h * PSSMLT_ITERS,
                                     shadow)
        print(f"[{label}] {w * h} chains x {PSSMLT_ITERS} rounds ({integ.bootstrap_count} "
              f"bootstrap): {PSSMLT_ITERS / secs:.3f} rounds/s, "
              f"{w * h * PSSMLT_ITERS / secs:.1f} chain-steps/s, K1 {k1} launches = "
              f"{k1 / PSSMLT_ITERS:.2f} per round ({card})")
        lum = float(m.luminance(torch.from_numpy(against)).mean())
        r_b = b[0] / lum
        print(f"[{label}] b {b[0]:.6f} against the mean luminance {lum:.6f} of {name} image: "
              f"ratio {r_b:.4f} (bounds 0.95, 1.05)")
        check(0.95 < r_b < 1.05, f"{label}: b / mean luminance {r_b:.4f} outside (0.95, 1.05)")
        if mode == "path":
            mean_ratio(label, img, against, 0.9, 1.1)
        else:
            print(f"[{label}] image mean against {name}: ratio "
                  f"{float(img.mean()) / float(against.mean()):.4f} (start-up bias, not held)")
        launches[key], err = k1, max(err, e)
    return launches, err


def phase_metropolis(card):
    """Phase 17c: run_chain_1d at its defaults (16,384 chains, 300 rounds)
    on the card: tests/test_mcmc.py's assertions, and the final histogram
    within L1 0.02 of the same run on the CPU."""
    from mitsuba3_experiments_tpu_torch import utils
    from mitsuba3_experiments_tpu_torch.integrators.metropolis import analytic_target, run_chain_1d

    secs, (kls, hist, target) = utils.benchmark(lambda: run_chain_1d(device="cuda"), warmup=0,
                                                iters=1)
    _, cpu_hist, _ = run_chain_1d(device="cpu")
    centers = (np.arange(64) + 0.5) / 64
    t = analytic_target(centers)
    t = t / t.sum()
    hole = float(hist[(centers > 0.51) & (centers < 0.59)].sum())
    mean_err = abs(float((hist * centers).sum() - (t * centers).sum()))
    l1 = float(np.abs(hist - cpu_hist).sum())
    print(f"[17c metropolis] 16384 chains x 300 rounds: {secs:.3f} s; KL {[round(k, 5) for k in kls]}, "
          f"hole mass {hole:.5f}, mean error {mean_err:.5f}, L1 to the CPU run {l1:.5f} ({card})")
    check(kls[-1] < 0.05 and kls[-1] <= kls[0] + 1e-3, f"17c: KL history {kls}")
    check(hole < 0.01 and mean_err < 0.02, f"17c: hole mass {hole}, mean error {mean_err}")
    check(l1 <= 0.02, f"17c: histogram L1 {l1:.5f} to the CPU run")


def phase_flows(card):
    """Phase 17d: train_flow on spiral_sample at JAX's defaults (6 couplings,
    hidden 64, 2000 steps, batch 4096, lr 1e-3), affine then rqs: the least
    recorded loss below 0 and at least 0.95 of 4,096 samples inside
    (-0.2, 1.2)^2; ms per step (utils.benchmark) and one step's device
    kernels and peak memory (utils.kernel_history); one step on the card
    against the same step on the CPU, loss within 1e-4 relative."""
    import torch

    from mitsuba3_experiments_tpu_torch import utils
    from mitsuba3_experiments_tpu_torch.models import normflow as nf

    for coupling in ("affine", "rqs"):
        cfg = nf.FlowConfig(coupling=coupling)
        label = f"17d normflow {coupling}"
        secs, (params, losses) = utils.benchmark(
            lambda: nf.train_flow(nf.spiral_sample, cfg, n_iters=FLOW_ITERS, batch=FLOW_BATCH,
                                  lr=1e-3, device="cuda"), warmup=0, iters=1)
        with torch.no_grad():
            xs, _ = nf.flow_sample(params, cfg, torch.Generator(device="cuda").manual_seed(2),
                                   4096)
        inside = float(((xs > -0.2) & (xs < 1.2)).all(-1).float().mean())
        g = torch.Generator(device="cuda").manual_seed(3)
        _, step = nf.make_train_step(params, cfg, lr=1e-3)
        hist = utils.kernel_history(step, nf.spiral_sample(g, FLOW_BATCH))
        print(f"[{label}] {FLOW_ITERS} steps of {FLOW_BATCH}: {secs:.3f} s = "
              f"{secs * 1e3 / FLOW_ITERS:.3f} ms/step; one step {hist['kernels']} device kernels, "
              f"{hist['device_ms']:.3f} ms of device time, {hist['host_ops']} host operators, "
              f"peak {hist['peak_bytes'] / 1e6:.1f} MB ({card})")
        print(f"[{label}] losses every 100 steps {[round(x, 4) for x in losses]}; "
              f"{inside:.4f} of 4096 samples inside (-0.2, 1.2)^2")
        check(min(losses) < 0.0, f"{label}: least loss {min(losses)} not below 0")
        check(inside >= 0.95, f"{label}: only {inside:.4f} of the samples inside")
        # one step, card against CPU, from the same parameters and batch
        init = nf.init_flow(torch.Generator().manual_seed(4), cfg, device="cpu")
        batch = nf.spiral_sample(torch.Generator().manual_seed(5), FLOW_BATCH)
        card_init = [[{k: v.to("cuda", copy=True) for k, v in l.items()} for l in net]
                     for net in init]
        loss_cpu = float(nf.make_train_step(init, cfg, n_iters=FLOW_ITERS)[1](batch))
        loss_card = float(nf.make_train_step(card_init, cfg, n_iters=FLOW_ITERS)[1](
            batch.to("cuda")))
        rel = abs(loss_card / loss_cpu - 1.0)
        print(f"[{label}] one step: loss card {loss_card:.7f} cpu {loss_cpu:.7f} (rel {rel:.2e})")
        check(rel < 1e-4, f"{label}: card and CPU step losses differ by {rel:.2e}")


def phase_reparam(card):
    """Phase 17e: train_reparam at ReparamConfig()'s defaults, 1000 steps of
    4096, against tests/test_models.py's gaussian bump: the last loss below
    1.0 and the mapped samples' median distance to the bump below 0.8 of
    the uniform samples'."""
    import torch

    from mitsuba3_experiments_tpu_torch import utils
    from mitsuba3_experiments_tpu_torch.models import reparam as rp

    center = torch.tensor(BUMP, device="cuda")

    def log_p(x):
        return (-0.5 * torch.sum((x - center) ** 2, -1) / BUMP_SIG ** 2
                - float(np.log(2 * np.pi * BUMP_SIG ** 2)))

    secs, (params, losses) = utils.benchmark(
        lambda: rp.train_reparam(log_p, rp.ReparamConfig(), n_iters=REPARAM_ITERS,
                                 batch=REPARAM_BATCH, lr=3e-3, seed=1, device="cuda"),
        warmup=0, iters=1)
    z = torch.rand((4096, 2), generator=torch.Generator(device="cuda").manual_seed(9),
                   device="cuda")
    with torch.no_grad():
        x = rp.apply_map(params, z)
    c = np.array(BUMP)
    d = float(np.median(np.linalg.norm(x.cpu().numpy() - c, axis=-1)))
    d_uniform = float(np.median(np.linalg.norm(z.cpu().numpy() - c, axis=-1)))
    print(f"[17e reparam] {REPARAM_ITERS} steps of {REPARAM_BATCH}: {secs:.3f} s = "
          f"{secs * 1e3 / REPARAM_ITERS:.3f} ms/step ({card}); losses "
          f"{[round(x, 4) for x in losses]}; median distance {d:.4f} against {d_uniform:.4f}")
    check(len(losses) == REPARAM_ITERS // 100 and losses[-1] < 1.0, f"17e: losses {losses}")
    check(d < 0.8 * d_uniform, f"17e: median distance {d:.4f} not below 0.8 x {d_uniform:.4f}")


def phase_pssmlt_card_vs_cpu(device):
    """Phase 18: five Pssmlt rounds (two bootstrap, depth 4, as phase 16
    cuts depth for the CPU's time), path and simple mode, on the Cornell box
    + a 4k-triangle sphere at 32x32, on the card (K1) and on the CPU (the
    plain traversal, whose path the CPU tests hold against the JAX package)
    from the same state: at least 0.99 of the chains in the same state
    (position, roulette uniforms and radiance within rtol 1e-3 / atol 1e-4,
    as phase 16), the accumulators' means within 1e-3 relative."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import Pssmlt

    rtol, atol = ZOO_SMALL_TOL
    n = 32 * 32
    for mode in ("path", "simple"):
        integ = Pssmlt(max_depth=4, mode=mode, bootstrap_count=2)
        runs = []
        for dev in (device, torch.device("cpu")):
            scene = small_nerad_scene(dev)
            st = integ.init_state(n, device=dev)
            acc = torch.zeros((n, 3), device=dev)
            reset_counts()
            for i in range(5):
                st, acc = integ.step(scene, st, acc, 3, i, i < integ.bootstrap_count)
            runs.append((st, acc.cpu(), read_counts()["k1"]))
        (sg, ag, k1), (sc, ac, _) = runs
        same = torch.ones(n, dtype=torch.bool)
        for a, b in ((sg.pos, sc.pos), (sg.L, sc.L), (sg.u_rr.T, sc.u_rr.T)):
            same &= torch.isclose(a.cpu(), b, rtol=rtol, atol=atol).all(-1)
        share = float(same.float().mean())
        rel = abs(float(ag.mean()) / float(ac.mean()) - 1.0)
        print(f"[18 pssmlt {mode}] 32x32 cornell+sphere, 5 rounds: {share:.4f} of the chains in "
              f"the same state on the card and the CPU, accumulator means {float(ag.mean()):.6f} / "
              f"{float(ac.mean()):.6f} (rel {rel:.2e}), K1 launches {k1}")
        check(k1 > 0, f"18 {mode}: the card run did not launch K1")
        check(share >= 0.99, f"18 {mode}: only {share:.4f} of the chains agree with the CPU")
        check(rel < 1e-3, f"18 {mode}: accumulator means differ by {rel:.2e}")


# ---- phases 19a-19b: parallel/ on torch.distributed --------------------------

# 19a's padded render: a pass of 1,843,200 lanes takes two launches of this
# many, the second with 156,800 lanes past the wavefront
SHARD_CHUNK = 1_000_000
# 19b (and 19a's world-1 reference of it): phase 6's 32x32 Cornell box +
# sphere, spp 2, depth 4; a chunk of 700 lanes a rank pads the last launch
SMALL_SPP, SMALL_DEPTH, SMALL_CHUNK = 2, 4, 700
JOIN_S = 240                # 19b's two ranks, start-up included
SMALL_IMAGES = ("render", "render_chunk", "persistent")


def rendezvous(name):
    """A file:// rendezvous under out/, the file removed first (a process
    group needs a new one)."""
    path = os.path.abspath(os.path.join("out", name))
    os.makedirs("out", exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return f"file://{path}"


def images_equal(label, got, ref, rtol=1e-4, atol=1e-5):
    """Checks every pixel of `got` within rtol/atol of `ref` (numpy)."""
    close = np.isclose(got, ref, rtol=rtol, atol=atol).all(axis=-1)
    print(f"[{label}] pixels within rtol {rtol}/atol {atol}: {close.mean():.6f} "
          f"({int((~close).sum())} outside), max abs err {np.abs(got - ref).max():.3e}, "
          f"means {got.mean():.6f} / {ref.mean():.6f}")
    check(bool(np.isfinite(got).all()) and float(got.mean()) > 0.0,
          f"{label}: the image is not finite or is black")
    check(bool(close.all()), f"{label}: the images differ beyond rtol {rtol}/atol {atol}")


def grads_equal(label, got, ref, rtol, atol_rel):
    """Checks each gradient of `got` within rtol / atol_rel max|ref| of
    `ref` (dicts of numpy arrays by DIFF_KEYS)."""
    for k in DIFF_KEYS:
        a, b = got[k], ref[k]
        scale = float(np.abs(b).max())
        worst = float((np.abs(a - b) - rtol * np.abs(b)).max())
        print(f"[{label}] d loss / d {k}: max |g| {scale:.6e}, largest |diff| - {rtol} |ref| "
              f"{worst:.3e} (atol {atol_rel * scale:.3e})")
        check(scale > 0.0 and bool(np.isfinite(a).all()), f"{label}: no finite gradient of {k}")
        check(bool(np.allclose(a, b, rtol=rtol, atol=atol_rel * scale)),
              f"{label}: the gradients of {k} differ")


def sharded_stage(label, run, card, n_rays, hold=False, replays=False):
    """Runs one sharded entry point, `run()`, with the counts set to 0 just
    before and read just after: seconds, camera rays/s, K1's launches (and
    no plain traversal), peak device memory; with `hold`, K1 against the
    plain traversal on its first closest-hit and first any-hit launch.
    Returns (result, K1 launches, max abs err of the holds)."""
    import torch

    out = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    if hold:
        made = k1_launches(lambda: out.append(run()), first_only=True)
    else:
        out.append(run())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] {secs:.3f} s, {n_rays / secs:.1f} camera rays/s, K1 launches "
          f"{counts['k1']}, plain traversals {counts['plain_traverse']}, peak device memory "
          f"{peak:.2f} GB ({card})")
    check(counts["k1"] > 0 and counts["plain_traverse"] == 0,
          f"{label}: the ray queries did not run on K1 alone")
    if replays:
        note_k5(label.split(" spp")[0], counts, card)
    err = 0.0
    if hold:
        first = {}
        for launch in made:
            first.setdefault(launch[1]["any_hit"], launch)
        del made
        check(set(first) == {False, True}, f"{label}: no closest-hit or no any-hit launch")
        err = max(hold_first_lanes(f"{label} first {'any' if k else 'closest'} hit", first[k])
                  for k in (False, True))
    return out[0], counts["k1"], err


def small_sharded(mesh, dev):
    """The four sharded entry points on phase 6's 32x32 Cornell box +
    sphere: {name: numpy result} (images, losses, gradients by DIFF_KEYS)."""
    import torch

    from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator
    from mitsuba3_experiments_tpu_torch.parallel import (
        render_persistent_sharded, render_sharded, sharded_grad_step, sharded_replay_grad)
    from mitsuba3_experiments_tpu_torch.scene import params

    scene = small_nerad_scene(dev)
    integ = PathIntegrator(max_depth=SMALL_DEPTH, rr_depth=2)
    target = torch.as_tensor(
        np.random.default_rng(19).uniform(0.0, 0.5, (32, 32, 3)).astype(np.float32), device=dev)
    diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}
    n = 32 * 32 * SMALL_SPP
    out = {
        "render": render_sharded(scene, integ, mesh, seed=3, spp=SMALL_SPP),
        "render_chunk": render_sharded(scene, integ, mesh, seed=3, spp=SMALL_SPP,
                                       chunk=SMALL_CHUNK),
        "persistent": render_persistent_sharded(scene, mesh, seed=3, spp=SMALL_SPP,
                                                max_depth=SMALL_DEPTH, rr_depth=2),
    }
    loss, g = sharded_replay_grad(scene, diff, target, 3, mesh, n_lanes=512, spp=SMALL_SPP,
                                  max_depth=SMALL_DEPTH, rr_depth=2, ray_end=n, chunk=256)
    out["replay_loss"] = loss
    out.update({f"replay:{k}": v for k, v in g.items()})
    loss, g = sharded_grad_step(scene, diff, target, 3, mesh,
                                PathIntegrator(max_depth=SMALL_DEPTH, rr_depth=2,
                                               differentiable=True))
    out["step_loss"] = loss
    out.update({f"step:{k}": v for k, v in g.items()})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def phase_sharded(scene, integrator, card, dev, render_img, persistent_img, replay_grads):
    """Phase 19a: a one-rank NCCL group in this process; the four sharded
    entry points on the stand-in at 1280x720 against phases 4 and 12, then
    on the small scene as 19b's reference.  Returns ({entry point: K1
    launches}, max abs err of the holds, the small scene's results)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, persistent
    from mitsuba3_experiments_tpu_torch.parallel import (
        make_mesh, render_persistent_sharded, render_sharded, sharded_grad_step,
        sharded_replay_grad)
    from mitsuba3_experiments_tpu_torch.scene import params

    w, h = RES
    n = w * h * SPP
    target = torch.as_tensor(persistent_img, device=dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=rendezvous("rendezvous_19a"), rank=0,
                            world_size=1, timeout=timedelta(seconds=120))
    launches = {}
    try:
        mesh = make_mesh(1)
        t0 = time.perf_counter()
        ping = torch.ones(1, device=dev)
        dist.all_reduce(ping, group=mesh.get_group("dp"))
        torch.cuda.synchronize()
        print(f"[19a] one-rank NCCL group: the first all-reduce (the communicator's set-up) "
              f"{time.perf_counter() - t0:.3f} s ({card})")
        img, launches["render_sharded"], err = sharded_stage(
            "19a render_sharded", lambda: render_sharded(scene, integrator, mesh, spp=SPP,
                                                         rfilter="tent"), card, n, hold=True)
        images_equal("19a render_sharded against phase 4's render", img.cpu().numpy(),
                     render_img)
        img, launches["render_sharded chunk"], _ = sharded_stage(
            f"19a render_sharded chunk {SHARD_CHUNK}",
            lambda: render_sharded(scene, integrator, mesh, spp=SPP, rfilter="tent",
                                   chunk=SHARD_CHUNK), card, n)
        images_equal("19a render_sharded padded against phase 4's render", img.cpu().numpy(),
                     render_img)
        img, launches["render_persistent_sharded"], _ = sharded_stage(
            "19a render_persistent_sharded",
            lambda: render_persistent_sharded(scene, mesh, seed=0, spp=SPP, max_depth=MAX_DEPTH,
                                              rr_depth=4, rfilter="tent"), card, n)
        images_equal("19a render_persistent_sharded against phase 12's render_persistent",
                     img.cpu().numpy(), persistent_img)
        del img
        diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}
        (loss, g), launches["sharded_replay_grad"], _ = sharded_stage(
            f"19a sharded_replay_grad spp {SPP} depth {MAX_DEPTH}, chunks of {REPLAY_CHUNK}",
            lambda: sharded_replay_grad(scene, diff, target, 0, mesh, n_lanes=persistent.N_LANES,
                                        spp=SPP, max_depth=MAX_DEPTH, rr_depth=4, rfilter="box",
                                        ray_end=n, chunk=REPLAY_CHUNK), card, n,
            replays=True)
        print(f"[19a sharded_replay_grad] loss {float(loss):.6e}")
        grads_equal("19a sharded_replay_grad against phase 12's replay_grads",
                    {k: v.cpu().numpy() for k, v in g.items()},
                    {k: v.cpu().numpy() for k, v in replay_grads.items()}, 1e-3, 1e-4)
        (loss, g), launches["sharded_grad_step"], _ = sharded_stage(
            f"19a sharded_grad_step {w}x{h} spp_per_pass 1 depth {MAX_DEPTH}",
            lambda: sharded_grad_step(scene, diff, target, 0, mesh,
                                      PathIntegrator(max_depth=MAX_DEPTH, rr_depth=4,
                                                     differentiable=True)), card, w * h)
        print(f"[19a sharded_grad_step] loss {float(loss):.6e}")
        check(bool(torch.isfinite(loss)), "19a sharded_grad_step: the loss is not finite")
        for k, v in g.items():
            print(f"[19a sharded_grad_step] d loss / d {k}: max |g| {float(v.abs().max()):.6e}")
            check(bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0.0,
                  f"19a sharded_grad_step: the gradient of {k} is not finite or is zero")
        del g, diff
        small = small_sharded(mesh, dev)
    finally:
        dist.destroy_process_group()
    return launches, err, small


def rank_19b(rank, init, out):
    """One of 19b's two ranks: a gloo group of two processes, both on
    cuda:0, the small scene's four entry points, its results in
    out/rank<rank>.npz."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
    from mitsuba3_experiments_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=timedelta(seconds=60))
    try:
        res = small_sharded(make_mesh(2), dev)
        res["k1"] = np.array(bvh_cuda.launches)
        res["plain_traverse"] = np.array(bvh_torch.calls)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def phase_two_ranks(card, world1):
    """Phase 19b: two spawned ranks on the one card in a gloo group; every
    entry point's result equal to the world-1 run's (`world1`): images at
    rtol 1e-4 / atol 1e-5, losses at rtol 1e-4, gradients at rtol 2e-3 /
    atol 2e-4 max|g|; both ranks return the same.  Returns the ranks' K1
    launches."""
    import multiprocessing

    out = os.path.join("out", "19b")
    os.makedirs(out, exist_ok=True)
    for r in range(2):
        if os.path.exists(os.path.join(out, f"rank{r}.npz")):
            os.remove(os.path.join(out, f"rank{r}.npz"))
    ctx = multiprocessing.get_context("spawn")
    init = rendezvous("rendezvous_19b")
    procs = [ctx.Process(target=rank_19b, args=(r, init, out)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + JOIN_S
    for p in procs:
        p.join(timeout=max(deadline - time.perf_counter(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    secs = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"19b: the ranks exited with {codes} (a kill: a hang past {JOIN_S} s)")
    res = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    k1 = [int(r["k1"]) for r in res]
    print(f"[19b] two gloo ranks on cuda:0, 32x32 cornell+sphere: {secs:.1f} s with start-up, "
          f"K1 launches {k1}, plain traversals {[int(r['plain_traverse']) for r in res]} "
          f"({card})")
    check(min(k1) > 0 and all(int(r["plain_traverse"]) == 0 for r in res),
          "19b: a rank did not run its ray queries on K1 alone")
    for k, v in res[0].items():
        if k not in ("k1", "plain_traverse"):
            check(bool(np.array_equal(res[1][k], v)), f"19b: the ranks' {k} differ")
    for k in SMALL_IMAGES:
        images_equal(f"19b {k} against world 1", res[0][k], world1[k])
    for name in ("replay", "step"):
        got, ref = float(res[0][f"{name}_loss"]), float(world1[f"{name}_loss"])
        print(f"[19b] {name} loss {got:.6e} against world 1's {ref:.6e}")
        check(bool(np.isclose(got, ref, rtol=1e-4, atol=0.0)), f"19b: the {name} losses differ")
        grads_equal(f"19b {name} gradients against world 1",
                    {k: res[0][f"{name}:{k}"] for k in DIFF_KEYS},
                    {k: world1[f"{name}:{k}"] for k in DIFF_KEYS}, 2e-3, 2e-4)
    return sum(k1)


# ---- phase 20: the flagship loader, and inverse rendering on its scene ------

FLAGSHIP_OBJ = 70           # + 2 area emitters: the bedroom's 72 shapes
FLAGSHIP_TRIS = 2_000_000
INVERT_STEPS = 3


def load_by_path(rel):
    """The repository file `rel` (a script or test helper) as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(rel))[0],
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_flagship(card, dev):
    """Phases 20a-20b: a bedroom-class skeleton XML (tests/
    torch_bedroom_skeleton.py) through load_flagship at 1280x720 and 2M
    triangles, built then read back from its cache; render_pipelined held
    against plain on its first K1 launches; then INVERT_STEPS Adam steps of
    scripts/torch_flagship_invert.py's invert_step at depth MAX_DEPTH.
    Returns (K1 launches, max abs err of the holds)."""
    import shutil

    import torch

    from mitsuba3_experiments_tpu_torch.integrators import render_pipelined
    from mitsuba3_experiments_tpu_torch.scene import flagship, scene_to_numpy

    skeleton = load_by_path(os.path.join("tests", "torch_bedroom_skeleton.py"))
    invert = load_by_path(os.path.join("scripts", "torch_flagship_invert.py"))
    root = os.path.join("out", "flagship")
    cache = os.path.join(root, "cache")
    shutil.rmtree(root, ignore_errors=True)
    xml = skeleton.write_skeleton(root, n_obj=FLAGSHIP_OBJ)
    kw = dict(res=RES, spp=SPP, tri_budget=FLAGSHIP_TRIS, cache_dir=cache, xml_path=xml,
              device=dev)
    t0 = time.perf_counter()
    scene, meta = flagship.load_flagship(**kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again, meta2 = flagship.load_flagship(**kw)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    files = os.listdir(cache)
    check(len(files) == 1 and files[0].endswith(".npz"), f"20a: the cache holds {files}")
    a, b = scene_to_numpy(scene), scene_to_numpy(again)
    same = a.keys() == b.keys() and meta == meta2 and all(
        (v.dtype == b[k].dtype and v.shape == b[k].shape and v.tobytes() == b[k].tobytes())
        if isinstance(v, np.ndarray) else v == b[k] for k, v in a.items())
    check(same, "20a: the scene read from the cache differs from the one built")
    del again, a, b
    rows = scene.bvh.unified.shape[0]
    mb = os.path.getsize(os.path.join(cache, files[0])) / 1e6
    print(f"[20a] load_flagship of a {FLAGSHIP_OBJ + 2}-shape skeleton at {RES[0]}x{RES[1]}: "
          f"{scene.n_faces} triangles, {rows} BVH rows, "
          f"{int(scene.materials.kind.shape[0])} materials; build {build_s:.2f} s, cache read "
          f"{read_s:.2f} s ({mb:.1f} MB), tables equal byte for byte ({card})")
    check(scene.n_faces > 0.9 * FLAGSHIP_TRIS, f"20a: only {scene.n_faces} triangles")
    check(meta["integrator"].get("max_depth") == 65 and meta["rfilter"] == "tent",
          f"20a: the XML's integrator and film did not come through: {meta}")

    w, h = RES
    out = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    made = k1_launches(lambda: out.append(render_pipelined(
        scene, seed=0, spp=SPP, max_depth=MAX_DEPTH, rr_depth=4, rfilter="tent")),
        first_only=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    img = out[0].cpu().numpy()
    print(f"[20a] render_pipelined spp {SPP} depth {MAX_DEPTH} tent: {secs:.3f} s, "
          f"{w * h * SPP / secs:.1f} camera rays/s, K1 launches {counts['k1']}, plain traversals "
          f"{counts['plain_traverse']}, peak device memory {peak:.2f} GB ({card})")
    print(f"[20a] image mean {img.mean():.6f} min {img.min():.6f} max {img.max():.6f}")
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          "20a: the image is not finite or is black")
    check(counts["k1"] > 0 and counts["plain_traverse"] == 0,
          "20a: the render did not run on K1 alone")
    first = {}
    for launch in made:
        first.setdefault(launch[1]["any_hit"], launch)
    del made, out
    check(set(first) == {False, True}, "20a: the render made no closest-hit or no any-hit launch")
    err = max(hold_first_lanes(f"20a first {'any' if k else 'closest'} hit", first[k])
              for k in (False, True))
    del first
    k1 = counts["k1"]

    # 20b: the driver's own step, at the headline depth
    target = render_pipelined(scene, seed=0, spp=SPP, max_depth=MAX_DEPTH, rr_depth=4,
                              rfilter="box")
    true_rad = scene.emitters.radiance.clone()
    true_col = scene.materials.base_color.clone()
    p = invert.start_params(scene)
    opt = torch.optim.Adam(list(p.values()), lr=invert.LR)
    rad0, col0 = invert.errors(p, true_rad, true_col)
    print(f"[20b] start: rad_err {rad0:.4f} col_err {col0:.4f}")
    curve = []
    for it in range(INVERT_STEPS):
        reset_counts()
        row, _ = invert.invert_step(scene, p, opt, target, it, spp=SPP, depth=MAX_DEPTH,
                                    chunk=REPLAY_CHUNK)
        counts = read_counts()
        rad, col = invert.errors(p, true_rad, true_col)
        curve.append((row["loss"], rad))
        k1 += counts["k1"]
        note_k5("20b invert_step", counts, card)
        print(f"[20b] step {it}: loss {row['loss']:.6e} rad_err {rad:.4f} col_err {col:.4f}; "
              f"{row['s']:.3f} s (record {row['record_s']:.3f} s, replay {row['replay_s']:.3f} "
              f"s), K1 launches {counts['k1']}, plain traversals {counts['plain_traverse']} "
              f"({card})")
        check(counts["k1"] > 0 and counts["plain_traverse"] == 0,
              f"20b step {it}: the record did not run on K1 alone")
        check(np.isfinite(row["loss"]) and np.isfinite(rad), f"20b step {it}: not finite")
    check(curve[-1][0] < curve[0][0], f"20b: the loss did not fall: {curve}")
    check(curve[-1][1] < curve[0][1] < rad0, f"20b: rad_err did not fall: {rad0}, {curve}")
    return k1, err


# ---- phase 21: bench_torch.py, the port's benchmark ---------------------------

BENCH_S = 600              # each bench_torch.py run's time limit
BENCH_BAND = 0.3           # the headline's fwd+bwd rays/s against phase 12's
BENCH_RUNS = (("21 small", {"BENCH_SMALL": "1"}), ("21 headline", {"BENCH_SKIP_D65": "1"}))


def phase_bench(card, prod_rate):
    """Phase 21: bench_torch.py's small rung, then its headline without the
    depth-65 companion, each in a subprocess from the repository root.
    Returns the K1 launches of their timed calls."""
    import re

    import torch

    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    repo = os.path.dirname(os.path.abspath(__file__))
    k1 = 0
    for label, env in BENCH_RUNS:
        env = {**{k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}, **env}
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(repo, "bench_torch.py")], cwd=repo,
                             env=env, capture_output=True, text=True, timeout=BENCH_S)
        secs = time.perf_counter() - t0
        lines = out.stdout.strip().splitlines()
        for line in lines:
            print(f"[{label}] {line}")
        check(out.returncode == 0, f"{label}: bench_torch.py exited {out.returncode}: "
              f"{out.stderr.strip()[-2000:]}")
        res = json.loads(lines[-1])
        value = res["value"]
        check(np.isfinite(value) and value > 0, f"{label}: value {value}")
        check(res["extra"]["device"] == name, f"{label}: extra.device {res['extra']['device']}")
        counts = [tuple(int(x) for x in m.groups()) for m in
                  (re.search(r"K1 launches (\d+), plain traversals (\d+)", line) for line in lines)
                  if m]
        check(len(counts) == 2 and all(c[0] > 0 and c[1] == 0 for c in counts),
              f"{label}: K1 launches and plain traversals {counts}")
        k1 += sum(c[0] for c in counts)
        k5 = [m.groups() for m in (re.search(r"K5 launches (\d+) \+ (\d+), plain replays (\d+)",
                                             line) for line in lines) if m]
        if label == "21 headline":
            check(len(k5) == 1, f"{label}: no K5 count on the fwd+bwd line")
            f, a, plain = (int(x) for x in k5[0])
            note_k5(label, {"k5_fwd": f, "k5_adj": a, "plain_replay": plain,
                            "k1": counts[1][0]}, card)
        print(f"[{label}] {secs:.1f} s with start-up: fwd+bwd {value:.1f} rays/s, fwd "
              f"{res['extra']['fwd_rays_per_s']:.1f} rays/s, K1 launches (fwd, fwd+bwd) "
              f"{[c[0] for c in counts]} ({card})")
    ratio = value / prod_rate
    print(f"[21 headline] fwd+bwd {value:.1f} rays/s against phase 12's {prod_rate:.1f}: "
          f"{ratio:.4f}")
    check(abs(ratio - 1.0) <= BENCH_BAND, f"21: the bench's fwd+bwd is {ratio:.4f} of phase 12's")
    return k1


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

    standin = standin_dict(res=RES, spp=SPP)
    t0 = time.perf_counter()
    scene, _ = load_dict(standin, device=dev)
    build_s = time.perf_counter() - t0
    refs = int((scene.bvh.leaf_face >= 0).sum())
    print(f"[standin] {scene.n_faces} triangles, {scene.bvh.unified.shape[0]} BVH rows "
          f"({scene.bvh.unified.numel() * 4 / 1e6:.1f} MB), spatial-split build {build_s:.2f} s; "
          f"{refs} leaf references, {refs - scene.n_faces} of them repeats")
    check(scene.bvh.layout.sbvh and refs > scene.n_faces,
          "the stand-in's tree has no repeated references: not a spatial-split build")
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
    per_ms, by_kind = pass0_ms(made), {}
    for i, ((args, kw, _), ms) in enumerate(zip(made, per_ms)):
        kind = "camera" if i == 0 else ("shadow" if kw["any_hit"] else "bounce")
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
    k1_bound, k1_by, k1_bytes, k1_ops = k1_least_ms(n_main, cam_rows, cam_leaf, cam_distinct)
    print(f"[pass0] camera batch fetched {cam_rows} rows ({cam_leaf} leaf, {cam_distinct} "
          f"distinct of {scene.bvh.unified.shape[0]}): bytes {k1_bytes / 1e6:.1f} MB = "
          f"{k1_bytes / HBM_BYTES_S * 1e3:.4f} ms, float32 operations {k1_ops / 1e9:.2f} G = "
          f"{k1_ops / F32_OPS_S * 1e3:.4f} ms: bound {k1_bound:.4f} ms by {k1_by}, kernel at "
          f"{k1_bound / k_main_ms:.4f} of it; every fetch from device memory would be "
          f"{cam_rows * ROW_BYTES / HBM_BYTES_S * 1e3:.4f} ms")

    # ---- phase 5b: the object-split tree against the spatial-split one ----
    turns, err_e = phase_trees(scene, made, (cam_rows, cam_leaf, cam_distinct), standin,
                               integrator, card)
    del made, standin

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

    # ---- phase 6b: the differentiable render, card vs CPU and vs replay -----
    k1_diff = phase_diff_render(dev, card)

    # ---- phase 7: K2 against plain on the field's real inputs -------------
    from mitsuba3_experiments_tpu_torch.models import FieldConfig, NeradTrainer, init_field

    cfg = FieldConfig(fused=True)
    with torch.no_grad():
        field = init_field(torch.Generator().manual_seed(7), cfg, device=dev)
    err_k2, k2_ms, k2_plain_ms, k2_dev = phase_k2(dev, card, field, cfg, "init field",
                                                  timing=True)
    phase_k2_sizes(dev, card, field, cfg)

    # ---- phase 8: the nerad path on the stand-in ---------------------------
    trainer = NeradTrainer(field_cfg=cfg)
    train, _, trained = phase_nerad(scene, card, trainer=trainer)
    err_trained, _, _, _ = phase_k2(dev, card, trained, cfg, "trained field", timing=False)
    err_k2 = max(err_k2, err_trained)

    # ---- phase 8b: neural radiance caching on the stand-in -----------------
    nrc_train, nrc_render, nrc_rows, nrc_k2_ms, err_f, err_nrc_k2 = phase_nrc(scene, card)
    err_k2 = max(err_k2, err_nrc_k2)

    # ---- phase 9: K3's path, the ops entry point, against plain ------------
    k3_launches, err_k3, k3_ms, k3_plain_ms, k3_lib_ms, k3_bound, k3_dev = phase_k3(
        dev, card, NeradTrainer.make_area_dist(scene).pmf)

    # ---- phase 10: one nerad step, card against CPU ------------------------
    phase_card_vs_cpu(dev)

    # ---- phase 11: K4's path, the probe entry point, against plain ---------
    k4_launches, err_k4, k4_ms, k4_plain_ms, k4_bound, k4_dev = phase_k4(dev, card)

    # ---- phase 12: production forward + fwd+bwd, depth 8 -------------------
    target, prod, err_d, prod_grads, prod_rate, rec8 = phase_production(scene, integrator, card)

    # ---- phase 13: the depth-65 companion ----------------------------------
    rec65, _, _, _ = fwd_bwd(scene, target, 1, DEEP, card, "fwd+bwd d65")

    # ---- phase 12c: K5 against its plain version, timed, bound, profiled ---
    k5 = phase_k5(scene, card, rec8, rec65, target)
    del rec8, rec65

    # ---- phase 13b: the truncated replay against the full one --------------
    k1_trunc = phase_trunc(scene, card)

    # ---- phase 14: record + replay, card against CPU -----------------------
    phase_card_vs_cpu_replay(dev, card)

    # ---- phases 15a-15g: the integrator zoo on the stand-in ----------------
    zoo, err_g, simple_img = phase_zoo(scene, card, target.cpu().numpy())

    # ---- phase 16: the zoo, card against CPU --------------------------------
    phase_zoo_card_vs_cpu(dev)

    # ---- phases 17a-17e: PSSMLT, Metropolis, flows, reparam ------------------
    t17 = time.perf_counter()
    mcmc, err_h = phase_pssmlt(scene, card, target.cpu().numpy(), simple_img)
    phase_metropolis(card)
    phase_flows(card)
    phase_reparam(card)

    # ---- phase 18: PSSMLT, card against CPU -----------------------------------
    phase_pssmlt_card_vs_cpu(dev)
    print(f"[smoke] phases 17-18: {time.perf_counter() - t17:.1f} s ({card})")

    # ---- phases 19a-19b: parallel/ on torch.distributed ----------------------
    t19 = time.perf_counter()
    sharded, err_i, small = phase_sharded(scene, integrator, card, dev, img_np,
                                          target.cpu().numpy(), prod_grads)
    k1_two_ranks = phase_two_ranks(card, small)
    print(f"[smoke] phases 19a-19b: {time.perf_counter() - t19:.1f} s ({card})")

    # ---- phases 20a-20b: the flagship loader, inverse rendering --------------
    t20 = time.perf_counter()
    k1_flagship, err_j = phase_flagship(card, dev)
    print(f"[smoke] phases 20a-20b: {time.perf_counter() - t20:.1f} s ({card})")

    # ---- phase 21: bench_torch.py ------------------------------------------------
    t21 = time.perf_counter()
    k1_bench = phase_bench(card, prod_rate)
    print(f"[smoke] phase 21: {time.perf_counter() - t21:.1f} s ({card})")

    k2_bound, k2_by = k2_least_ms(FIELD_ROWS, K2_SIZES)
    print(f"[K2] {FIELD_ROWS} rows: kernel at {k2_bound / k2_ms:.4f} of the bound, device time at "
          f"{k2_bound / k2_dev:.4f} of it")
    for name, runs in turns.items():
        print(f"[trees] {name} in turns: camera batch "
              + ", ".join(f"{c:.4f}" for c, _ in runs) + " ms; pass-0 sum "
              + ", ".join(f"{p:.4f}" for _, p in runs) + f" ms ({card})")
    print(f"[nrc] K2 at {nrc_rows} query rows: device time {nrc_k2_ms:.4f} ms, bound "
          f"{k2_least_ms(nrc_rows, K2_SIZES)[0]:.4f} ms; launches: training {nrc_train['k2']}, "
          f"render {nrc_render['k2']}")
    k1_launches = (prod["k1"] + k1_diff + k1_trunc + nrc_train["k1"] + nrc_render["k1"]
                   + sum(zoo.values()) + sum(mcmc.values()) + sum(sharded.values())
                   + k1_two_ranks + k1_flagship + k1_bench)
    k2_launches = train["k2"] + nrc_train["k2"] + nrc_render["k2"]
    k5_launches = sum(f + a for f, a in K5_BY_PHASE.values())
    print("[smoke] K5 launches (forward + adjoint): " + ", ".join(
        f"{k} {f} + {a}" for k, (f, a) in K5_BY_PHASE.items()) + f"; {k5_launches} in all")
    print(f"[smoke] K1 launches: fwd+bwd d8 {prod['k1']}, differentiable render {k1_diff}, "
          f"trunc record {k1_trunc}, NRC training {nrc_train['k1']}, NRC render "
          f"{nrc_render['k1']}, zoo " + ", ".join(f"{k} {v}" for k, v in zoo.items())
          + ", pssmlt " + ", ".join(f"{k} {v}" for k, v in mcmc.items())
          + ", 19a " + ", ".join(f"{k} {v}" for k, v in sharded.items())
          + f", 19b (two ranks) {k1_two_ranks}, 20 (flagship render + invert) {k1_flagship}"
          + f", 21 (bench_torch.py) {k1_bench}"
          + f"; K2 launches: nerad training {train['k2']}, NRC training "
          f"{nrc_train['k2']}, NRC render {nrc_render['k2']}")
    print(f"[smoke] total {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": [
        {"name": "bvh8_traverse", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": k1_launches,
         "max_abs_err": max(err_a, err_b, err_c, err_d, err_e, err_f, err_g, err_h, err_i,
                            err_j),
         "ms": k_main_ms, "plain_ms": p_main_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "device_ms": per_ms[0]},
        {"name": "fused_mlp", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": k2_launches, "max_abs_err": err_k2, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None, "device_ms": k2_dev},
        {"name": "prefix_sum", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": k3_launches, "max_abs_err": err_k3, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": "bytes", "library_ms": k3_lib_ms,
         "device_ms": k3_dev},
        {"name": "gather_chain", "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
         "launches": k4_launches, "max_abs_err": err_k4, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound, "bound_by": "bytes", "library_ms": None, "device_ms": k4_dev},
        {"name": "replay_path", "route": "cuda", "source": K5_SOURCE, "replaces": K5_REPLACES,
         "launches": k5_launches, "max_abs_err": k5["err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None, "device_ms": k5["device_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
