#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers `correct`
compares, for the program on many seeds and for the control on a few, in one
process at the cell's own size.

    python3 benchmark/calibrate.py --workload d8-fwd-bwd --seeds 12 --control 3

For each seed it makes the loop's inputs as a run does (the loop that
`harness.load_loop` finds: an entry of `loops.LOOPS` or a loop file), runs
one step of the window's own call, and compares its outputs with the
reference; for the first `--control` seeds it also puts the control (the
reference with its tables, rays and hits rounded to bfloat16) in the
program's place.  Prints one JSON line a seed, then the largest program
reading and the smallest control reading of each number.  Not a part of the
runs the benchmark's command makes.

A cell of `chips` n > 1 runs as n ranks through `run.py`'s launcher
(`multicard.launch`): each rank makes its loop with `ranks=` and takes the
step, every rank calls the loop's optional `gather(out)`, and rank 0 alone
holds the reference, checks and prints.
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

from benchmark import harness, loops, multicard  # noqa: E402


def calibrate(name: str, seeds, n_control: int, device="cuda", root: str = harness.ROOT,
              cache: str = harness.CACHE, log=print, ranks: multicard.Ranks | None = None):
    """{"program": {number: [readings]}, "control": {number: [readings]}};
    None on every rank of a several-card run but rank 0."""
    import torch

    from benchmark import reference as ref_mod

    cell = harness.load_cell(name, root)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    port = loops.Port()
    make_loop = harness.load_loop(cell["bench_dir"], traffic["loop"])
    lead = ranks is None or ranks.lead
    if not lead:
        ranks.barrier()                   # rank 0 reads or writes the table cache first
    scene, _ = loops.load_scene(port, cell["bench_dir"], config, dev, cache)
    if ranks is not None and lead:
        ranks.barrier()
    ref = ref_mod.RefScene.build(loops.scene_dict(cell["bench_dir"], config), dev) if lead else None
    spans = harness.Spans(False, sync)
    out = {"program": {}, "control": {}}
    for j, seed in enumerate(seeds):
        t0 = time.perf_counter()
        loop = make_loop(port, scene, config, traffic, seed, spans,
                         ranks=ranks or multicard.Ranks.one(dev))
        step = loop.step(0)
        sync()
        if hasattr(loop, "gather"):
            step = loop.gather(step)
        t1 = time.perf_counter()
        if lead:
            got = {"seed": seed, "program": loop.check(ref_mod, ref, step)}
            t2 = time.perf_counter()
            if j < n_control:
                got["control"] = loop.check(ref_mod, ref, step, control=True)
            got["seconds"] = {"step": t1 - t0, "check": t2 - t1,
                              "control": time.perf_counter() - t2}
            for side in ("program", "control"):
                for k, v in got.get(side, {}).items():
                    out[side].setdefault(k, []).append(v)
            log(json.dumps(got))
        if ranks is not None:
            ranks.barrier()               # the next seed's step waits for rank 0's check
        del loop, step
    return out if lead else None


def summary(name: str, out: dict) -> str:
    """The last line: each number's largest program and smallest control
    reading."""
    s = {k: {"program_max": max(v), "control_min": min(out["control"].get(k, [float("nan")]))}
         for k, v in out["program"].items()}
    return json.dumps({"workload": name, "readings": s})


def calibrate_ranks(name: str, n_seeds: int, n_control: int, first_seed: int, n: int,
                    device="cuda", root: str = harness.ROOT, cache: str = harness.CACHE,
                    log=print, timeout_s: float = multicard.GROUP_TIMEOUT_S) -> int:
    """Calibrates cell `name` as `n` ranks (this script in `n` processes);
    rank 0's lines go to `log`.  Returns the exit code."""
    argv = ["--workload", name, "--seeds", str(n_seeds), "--control", str(n_control),
            "--first-seed", str(first_seed)]
    rc, _ = multicard.launch(os.path.abspath(__file__), argv, n, device, root, cache,
                             time.perf_counter(), log=log, timeout_s=timeout_s)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    multicard.add_args(ap)
    args = ap.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.rank is not None:
        def body(ranks):
            out = calibrate(args.workload, seeds, args.control, ranks.device, args.root,
                            args.cache, log=log, ranks=ranks)
            if out is not None:
                log(summary(args.workload, out))
        return multicard.run_rank(body, args)
    import torch

    chips = harness.load_cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 1
    if chips > 1:
        return calibrate_ranks(args.workload, args.seeds, args.control, args.first_seed, chips,
                               log=log)
    out = calibrate(args.workload, seeds, args.control, log=log)
    log(summary(args.workload, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
