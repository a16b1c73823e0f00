#!/usr/bin/env python3
"""Where the time of the port's neural-radiosity training step goes, on one
CUDA card.

    python3 scripts/torch_profile_nerad.py [--out out/profile_nerad.json] [--steps 20]

Builds `load_dict(standin_dict())` (the ~2M-triangle stand-in at 1280x720)
and trains `NeradTrainer(field_cfg=FieldConfig(fused=True))` at its
defaults (batch 16,384, m_rhs 32: 524,288 RHS lanes), as `chip_smoke.py`
does.  After 5 steps to warm up (they also build the kernels):

  * `--steps` warm steps, each timed on the host clock around a
    synchronized step, and the peak device memory of a step;
  * one step under `torch.profiler`: its device operations summed by kind
    (K1, K2, K3, cuBLAS products of the backward, torch elementwise,
    gather/scatter, ...) and the busy share, the union of their intervals
    over the profiled step's wall time;
  * three warm 1280x720 spp 1 renders with `NeradIntegrator`.

Prints a summary and writes it as JSON to `--out`; the chrome trace goes
beside it.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("out", "profile_nerad.json"))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_nerad: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(_HERE))
    sys.path.insert(0, _HERE)
    from torch_profile_render import card_name, device_breakdown, profiled

    from mitsuba3_experiments_tpu_torch.integrators import render
    from mitsuba3_experiments_tpu_torch.models import FieldConfig, NeradIntegrator, NeradTrainer
    from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict

    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    scene, _ = load_dict(standin_dict(), device="cuda")
    build_s = time.perf_counter() - t0
    trainer = NeradTrainer(field_cfg=FieldConfig(fused=True))
    init, step = trainer.make_train_step(scene)
    field, opt = init(torch.Generator().manual_seed(0))
    seed = iter(range(1 << 30))

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(field, opt, next(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for _ in range(5):
        run()
    torch.cuda.reset_peak_memory_stats()
    warm_s = [run() for _ in range(args.steps)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_s, prof = profiled(run)
    events, busy, by_kind = device_breakdown(prof, os.path.splitext(args.out)[0] + ".trace.json")

    integrator = NeradIntegrator(trainer, field)
    render_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render(scene, integrator, spp=1)
        torch.cuda.synchronize()
        render_s.append(time.perf_counter() - t)

    median_s = sorted(warm_s)[len(warm_s) // 2]
    summary = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "triangles": scene.n_faces, "build_s": build_s, "batch": trainer.batch_size,
        "m_rhs": trainer.m_rhs, "warm_step_s": warm_s, "warm_median_step_s": median_s,
        "peak_memory_gb": peak_gb, "profiled_wall_ms": wall_s * 1e3,
        "device_ops": len(events), "device_busy_ms": busy,
        "busy_share": busy / (wall_s * 1e3),
        "by_kind": {k: {"ops": c, "ms": ms, "share_of_busy": ms / busy}
                    for k, (c, ms) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])},
        "render_1280x720_spp1_s": render_s[1:],
    }
    print(f"stand-in {scene.n_faces} triangles, build {build_s:.2f} s; warm steps "
          f"{', '.join(f'{s:.4f}' for s in warm_s)} s, median {median_s:.4f} s; "
          f"peak {peak_gb:.2f} GB ({card})")
    print(f"profiled step: wall {wall_s * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"(share {summary['busy_share']:.4f}), {len(events)} device operations")
    for k, v in summary["by_kind"].items():
        print(f"  {k:28s} {v['ops']:7d} ops {v['ms']:10.3f} ms {100 * v['share_of_busy']:6.2f}%")
    print(f"warm nerad renders 1280x720 spp 1: {', '.join(f'{s:.4f}' for s in render_s[1:])} s")
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
