#!/usr/bin/env python3
"""Where the time of the port's replay gradients goes, on one CUDA card.

    python3 scripts/torch_profile_replay.py [--out out/profile_replay.json] [--chunk 131072]

Builds `load_dict(standin_dict())` (the ~2M-triangle stand-in at 1280x720)
and records its camera rays at spp 4, depth 8, rr_depth 4 with
`record_full_pipelined(return_film=True, rfilter="box")`, as `chip_smoke.py`
phase 12 does; the target is the recorder's own developed film.  Then:

  * one replay chunk (`replay_grads_full` of base colours and emitter
    radiances over the first rows of the record) at half, one and twice
    `--chunk` rows, each timed on the host clock around a synchronized call
    after a warm-up call, with its peak device memory: a time that stays
    flat as the chunk grows is bound by the host's launches, not the device;
  * one chunk of `--chunk` rows under `torch.profiler`: its device
    operations summed by kind, the busy share (the union of their
    intervals over the profiled wall time), the top kernels and the number
    of aten operators the host issued.

Prints a summary and writes it as JSON to `--out`; the chrome trace goes
beside it.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from torch_profile_render import card_name, device_breakdown, profiled

SPP, DEPTH, RR_DEPTH = 4, 8, 4
DIFF_KEYS = ("materials.base_color", "emitters.radiance")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("out", "profile_replay.json"))
    ap.add_argument("--chunk", type=int, default=131_072)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_replay: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mitsuba3_experiments_tpu_torch.integrators import record_full_pipelined, replay_grads_full
    from mitsuba3_experiments_tpu_torch.render import film as filmlib
    from mitsuba3_experiments_tpu_torch.scene import load_dict, params, standin_dict

    card = card_name()
    print(card, flush=True)

    scene, _ = load_dict(standin_dict(), device="cuda")
    w, h = scene.camera.resolution
    n_rays = w * h * SPP
    pad = -(-n_rays // (2 * args.chunk)) * 2 * args.chunk
    rec, film = record_full_pipelined(scene, 0, n_rays, spp=SPP, max_depth=DEPTH,
                                      rr_depth=RR_DEPTH, pad_to=pad, return_film=True,
                                      rfilter="box")
    target = filmlib.develop(film)
    diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}

    def chunk_of(rows):
        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            replay_grads_full(scene, diff, params.update, target, 0, rec.rows(slice(0, rows)),
                              n_rays, chunk=rows, spp=SPP, max_depth=DEPTH, rr_depth=RR_DEPTH)
            torch.cuda.synchronize()
            return time.perf_counter() - t
        return run

    sweep = []
    for rows in (args.chunk // 2, args.chunk, 2 * args.chunk):
        run = chunk_of(rows)
        run()
        torch.cuda.reset_peak_memory_stats()
        dt = run()
        peak = torch.cuda.max_memory_allocated() / 1e9
        sweep.append({"rows": rows, "s": dt, "rays_per_s": rows / dt, "peak_memory_gb": peak})
        print(f"one replay chunk of {rows} rays: {dt:.4f} s = {rows / dt:.1f} rays/s, peak "
              f"device memory {peak:.2f} GB ({card})", flush=True)

    wall_s, prof = profiled(chunk_of(args.chunk))
    events, busy, by_kind = device_breakdown(prof, os.path.splitext(args.out)[0] + ".trace.json")
    avg = prof.key_averages()
    aten = sum(e.count for e in avg if e.key.startswith("aten::"))
    top = sorted((e for e in avg if e.device_type.name == "CUDA"),
                 key=lambda e: -e.self_device_time_total)[:6]
    summary = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "spp": SPP, "max_depth": DEPTH, "sweep": sweep, "profiled_rows": args.chunk,
        "profiled_wall_ms": wall_s * 1e3, "device_ops": len(events), "device_busy_ms": busy,
        "busy_share": busy / (wall_s * 1e3), "aten_ops": aten,
        "by_kind": {k: {"ops": c, "ms": ms, "share_of_busy": ms / busy}
                    for k, (c, ms) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": e.key, "calls": e.count, "ms": e.self_device_time_total / 1e3}
                        for e in top],
    }
    print(f"profiled replay chunk of {args.chunk}: wall {wall_s * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms (share {summary['busy_share']:.4f}), {len(events)} device operations, "
          f"{aten} aten operators on the host ({card})")
    for k, v in summary["by_kind"].items():
        print(f"  {k:28s} {v['ops']:7d} ops {v['ms']:10.3f} ms {100 * v['share_of_busy']:6.2f}%")
    for e in summary["top_kernels"]:
        print(f"  {e['ms']:9.3f} ms {e['calls']:6d}x {e['name'][:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
