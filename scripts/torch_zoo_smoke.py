#!/usr/bin/env python3
"""chip_smoke.py's integrator-zoo phases alone, on one CUDA card.

    python3 scripts/torch_zoo_smoke.py      # from the repository root

Builds the kernels and the 2M-triangle stand-in at 1280x720, renders the
reference image of chip_smoke.py's phase 12 (render_persistent, spp 4,
depth 8, tent), then runs phases 15a-15g and 16 with their checks.  A mean
bound that does not hold is reported and the run goes on; the script exits
1 if any check failed.  For iterating on the zoo without the whole smoke
run.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_zoo_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from mitsuba3_experiments_tpu_torch.integrators import render_persistent
    from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict

    missed = []
    strict = cs.mean_ratio

    def reporting(*args, **kwargs):
        try:
            strict(*args, **kwargs)
        except RuntimeError as e:
            print(f"[zoo] BOUND NOT HELD: {e}", flush=True)
            missed.append(str(e))

    cs.mean_ratio = reporting
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    cs.build_all()
    dev = torch.device("cuda:0")
    scene, _ = load_dict(standin_dict(res=cs.RES, spp=cs.SPP), device=dev)
    ref = render_persistent(scene, seed=0, spp=cs.SPP, max_depth=cs.MAX_DEPTH, rr_depth=4,
                            rfilter="tent")
    t1 = time.perf_counter()
    zoo, err = cs.phase_zoo(scene, card, ref.cpu().numpy())
    print(f"[zoo] K1 launches {zoo}, max abs err {err}, phase 15 {time.perf_counter() - t1:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    cs.phase_zoo_card_vs_cpu(dev)
    print(f"[zoo] phase 16 {time.perf_counter() - t1:.1f} s; total "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
