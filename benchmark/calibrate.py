#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers `correct`
compares, for the program on many seeds and for the control on a few, in one
process at the cell's own size.

    python3 benchmark/calibrate.py --workload d8-fwd-bwd --seeds 12 --control 3

For each seed it makes the loop's inputs as a run does (`loops.LOOPS`), runs
one step of the window's own call, and compares its outputs with the
reference; for the first `--control` seeds it also puts the control (the
reference with its tables, rays and hits rounded to bfloat16) in the
program's place.  Prints one JSON line a seed, then the largest program
reading and the smallest control reading of each number.  Not a part of the
runs the benchmark's command makes.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, loops  # noqa: E402


def calibrate(name: str, seeds, n_control: int, device: str = "cuda", root: str = harness.ROOT,
              cache: str = harness.CACHE, log=print) -> dict:
    """{"program": {number: [readings]}, "control": {number: [readings]}}."""
    import torch

    from benchmark import reference as ref_mod

    cell = harness.load_cell(name, root)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    port = loops.Port()
    scene, _ = loops.load_scene(port, cell["bench_dir"], config, dev, cache)
    ref = ref_mod.RefScene.build(loops.scene_dict(cell["bench_dir"], config), dev)
    spans = harness.Spans(False, sync)
    out = {"program": {}, "control": {}}
    for j, seed in enumerate(seeds):
        t0 = time.perf_counter()
        loop = loops.LOOPS[traffic["loop"]](port, scene, config, traffic, seed, spans)
        step = loop.step(0)
        sync()
        t1 = time.perf_counter()
        got = {"seed": seed, "program": loop.check(ref_mod, ref, step)}
        t2 = time.perf_counter()
        if j < n_control:
            got["control"] = loop.check(ref_mod, ref, step, control=True)
        got["seconds"] = {"step": t1 - t0, "check": t2 - t1, "control": time.perf_counter() - t2}
        for side in ("program", "control"):
            for k, v in got.get(side, {}).items():
                out[side].setdefault(k, []).append(v)
        log(json.dumps(got))
        del loop, step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 1
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = calibrate(args.workload, seeds, args.control, log=lambda s: print(s, flush=True))
    summary = {k: {"program_max": max(v), "control_min": min(out["control"].get(k, [float("nan")]))}
               for k, v in out["program"].items()}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
