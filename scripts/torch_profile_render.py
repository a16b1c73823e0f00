#!/usr/bin/env python3
"""Where the time of the port's forward render goes, on one CUDA card.

    python3 scripts/torch_profile_render.py [--out out/profile_render.json] [--runs 5]

Builds `load_dict(standin_dict())` (the ~2M-triangle stand-in at 1280x720)
and renders it with `render(scene, PathIntegrator(max_depth=8, rr_depth=4),
spp=4, rfilter="tent")`, as `chip_smoke.py` does.  After one render to warm
up (it also builds the traversal kernel):

  * `--runs` warm renders, each timed on the host clock around a
    synchronized render;
  * the peak device memory of one render (`torch.cuda.max_memory_allocated`);
  * one render under `torch.profiler`: its device operations (kernels,
    memcpy, memset) summed by kind, and the busy share, the union of their
    intervals over the profiled render's wall time.

Prints a summary and writes it as JSON to `--out`; the chrome trace goes
beside it.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kind_of(name: str, cat: str) -> str:
    low = name.lower()
    if cat != "kernel":
        return "memcpy / memset"
    if "bvh8_traverse" in name:
        return "K1 bvh8_traverse_kernel"
    if "index" in low or "gather" in low or "scatter" in low:
        return "torch gather / index"
    if "reduce" in low:
        return "reductions"
    if "catarray" in low:
        return "cat"
    if "elementwise" in low:
        return "torch elementwise kernels"
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds in, ms out)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("out", "profile_render.json"))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_render: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render
    from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    scene, _ = load_dict(standin_dict(), device="cuda")
    build_s = time.perf_counter() - t0
    integrator = PathIntegrator(max_depth=8, rr_depth=4)

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        render(scene, integrator, spp=4, rfilter="tent")
        torch.cuda.synchronize()
        return time.perf_counter() - t

    first_s = run()
    torch.cuda.reset_peak_memory_stats()
    warm_s = [run() for _ in range(args.runs)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    trace = os.path.splitext(args.out)[0] + ".trace.json"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]

    by_kind = {}
    for e in events:
        k = by_kind.setdefault(kind_of(e.get("name", ""), e["cat"]), [0, 0.0])
        k[0] += 1
        k[1] += e["dur"] / 1e3
    busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events)
    w, h = scene.camera.resolution
    warm_sorted = sorted(warm_s)
    median_s = warm_sorted[len(warm_sorted) // 2]
    summary = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "triangles": scene.n_faces, "build_s": build_s, "first_render_s": first_s,
        "warm_render_s": warm_s, "warm_median_s": median_s,
        "warm_median_camera_rays_per_s": w * h * 4 / median_s,
        "peak_memory_gb": peak_gb, "profiled_wall_ms": wall_s * 1e3,
        "device_ops": len(events), "device_busy_ms": busy,
        "busy_share": busy / (wall_s * 1e3),
        "by_kind": {k: {"ops": c, "ms": ms, "share_of_busy": ms / busy}
                    for k, (c, ms) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])},
    }
    print(f"stand-in {scene.n_faces} triangles, build {build_s:.2f} s; first render "
          f"{first_s:.4f} s; warm {', '.join(f'{s:.4f}' for s in warm_s)} s, median "
          f"{median_s:.4f} s = {summary['warm_median_camera_rays_per_s']:.1f} camera rays/s; "
          f"peak {peak_gb:.2f} GB ({card})")
    print(f"profiled render: wall {wall_s * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"(share {summary['busy_share']:.4f}), {len(events)} device operations")
    for k, v in summary["by_kind"].items():
        print(f"  {k:28s} {v['ops']:7d} ops {v['ms']:10.3f} ms {100 * v['share_of_busy']:6.2f}%")
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
