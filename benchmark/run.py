#!/usr/bin/env python3
"""The benchmark of mitsuba3_experiments_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload d8-fwd-bwd --seed 7 --seconds 45 --trace 0

Runs from the root of a checkout on a machine with an NVIDIA card.  The cell
(`BENCHMARK.json`'s `workloads`) names a configuration (`configs/`) and a
traffic mix (`traffic/`).  Set-up loads the scene (from `cache/`, written by
the first run of a checkout), makes the loop's inputs from `--seed` and takes
one untimed step; the window then runs steps back to back for `--seconds`.
After it, the port's state is freed and the plain reference (`reference/`)
checks what the last step produced.

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its per-layer
metrics, read from the harness's spans, the port's counters and a profiler
window of the configuration's `trace_steps` steps after the timed window.
Lines before the result start with "#"; the result is the last line of
standard output; the numbers `correct` compares, each with its limit, are
the last lines of standard error.  Without a card, with fewer cards than the
cell asks for, or with a JAX module loaded, it exits 1 and prints no result.

The mix's "loop" is an entry of `loops.LOOPS` or a file
`loop_kinds/<loop>.py` (`harness.load_loop`).  A cell of `chips` 1 runs in
this one process, with no process group.  A cell of `chips` n > 1 runs n
ranks, this script again in n processes (`multicard.launch`), rank r on
`cuda:r`, each in an NCCL group for its loop's collectives and a gloo group
for the harness's messages.  Only a loop file takes ranks: its loop is
built with `ranks=` (rank, size, device, group) and splits the work itself.
Rank 0 loads or builds the scene and writes the table cache; the others
read it after a barrier.  Every rank takes the untimed step; `setup_s` runs
from this process's start to the barrier after the last of them, and the
window opens there, timed on rank 0's host clock.  Every rank takes the same
steps: after each step every rank synchronizes its card, and one gloo
all-reduce tells every rank whether rank 0's clock has closed the window,
so a step ends once the slowest rank's card is done.  Over the ranks:

  * the rate is the loop's `n_rays` (the whole frame, all ranks together)
    times the steps, over rank 0's window;
  * `step_p90_ms` is over rank 0's step times, each ending after that
    all-reduce;
  * `peak_mem_gb` and `device.memory_peak_bytes` are the fullest card's;
  * a traced run profiles the same steps on every rank; rank 0's readers
    read rank 0's trace, with every rank's counters, span durations, step
    count, peak and busy seconds in `ctx["by_rank"]` (in rank order; a list
    of one on one card); `device.busy_s` is the ranks' mean busy seconds
    and `device.busy_s_ranks` each rank's; the breakdown is rank 0's.

After the window every rank calls the loop's optional `gather(out)`, which
may bring what the check samples to rank 0, and frees its state; rank 0
alone builds the reference on `cuda:0` and checks.  The result line of a
several-card run also has "ranks": each rank's steps and peak bytes.  A
rank that raises or loads JAX ends the run with exit code 1 and no result,
and the launcher kills the other ranks; a hung collective ends by its
group's timeout (`multicard.GROUP_TIMEOUT_S`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
if __name__ == "__main__":
    # one host thread for torch's CPU operators, set before torch loads: the
    # steps are bound by the host's launches, and their times spread less so
    os.environ["OMP_NUM_THREADS"] = "1"

from benchmark import harness, loops, multicard  # noqa: E402


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def peak_bytes(dev) -> int:
    """The process's peak on `dev`: the card's largest allocation, or on
    the CPU the largest resident set (tests)."""
    import torch

    if dev.type == "cuda":
        return torch.cuda.max_memory_allocated(dev)
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: str = harness.ROOT, cache: str = harness.CACHE, t_start: float = T_START,
             log=print, ranks: multicard.Ranks | None = None):
    """Runs cell `name` of `root`'s BENCHMARK.json once; returns (result
    line, check lines).  `device` "cpu" runs the port's plain CPU path (for
    tests at small sizes).  `ranks`: this process's rank of a several-card
    run (None: one card, no process group); every rank but 0 returns None."""
    import torch

    cell = harness.load_cell(name, root)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    port = loops.Port()
    t_import = time.perf_counter() - t_start
    spans = harness.Spans(trace, sync)
    bench_dir = cell["bench_dir"]
    make_loop = harness.load_loop(bench_dir, traffic["loop"])

    if ranks is not None and not ranks.lead:
        ranks.barrier()                   # rank 0 reads or writes the table cache first
    t0 = time.perf_counter()
    with spans("scene_load"):
        scene, hit = loops.load_scene(port, bench_dir, config, dev, cache)
    sync()
    scene_load_s = time.perf_counter() - t0
    if ranks is not None and ranks.lead:
        ranks.barrier()
    log(f"# scene {config['name']}: {scene.n_faces} triangles, {scene.bvh.unified.shape[0]} BVH "
        f"rows, {'read from the cache' if hit else 'built and cached'} in {scene_load_s:.3f} s")
    t1 = time.perf_counter()
    loop = make_loop(port, scene, config, traffic, seed, spans,
                     ranks=ranks or multicard.Ranks.one(dev))
    sync()
    t2 = time.perf_counter()
    with spans("warm"):
        loop.step("warm")
    sync()
    if ranks is not None:
        ranks.barrier()                   # the last rank's untimed step is done
    t3 = time.perf_counter()
    setup_s = t3 - t_start
    log(f"# set-up {setup_s:.3f} s: start and imports {t_import:.3f}, scene {scene_load_s:.3f}, "
        f"inputs {t2 - t1:.3f}, warm step {t3 - t2:.3f}")
    spans.durations = {}

    port.bvh_cuda.launches = port.bvh_torch.calls = 0
    port.replay_cuda.forward_launches = port.replay_cuda.adjoint_launches = 0
    port.replay.plain_calls = 0
    times, k1_steps, waits, last, i = [], [], [], None, 0
    w0 = time.perf_counter()
    while True:
        last = None                       # one step's outputs alive at a time
        k1_0 = port.bvh_cuda.launches
        s0 = time.perf_counter()
        last = loop.step(i)
        sync()
        s1 = time.perf_counter()
        over = s1 - w0 >= seconds
        if ranks is not None:             # rank 0's clock decides, after the slowest rank
            over = ranks.window_over(over)
            waits.append(time.perf_counter() - s1)
            s1 += waits[-1]
        times.append(s1 - s0)
        k1_steps.append(port.bvh_cuda.launches - k1_0)
        i += 1
        if over:
            break
    window_s = s1 - w0
    n = len(times)
    counts = port.counters()
    peak = peak_bytes(dev)
    log(f"# window: {n} steps in {window_s:.4f} s, {loop.n_rays} camera rays a step; "
        "per step: " + ", ".join(f"{k} {v / n:g}" for k, v in counts.items()))
    log(f"# step seconds: {' '.join(f'{t:.4f}' for t in times)}")
    log(f"# step K1 launches: {' '.join(str(k) for k in k1_steps)}")
    if waits:
        log(f"# window message ms (the slowest rank's lag included): mean "
            f"{1e3 * sum(waits) / n:.4f}, median {1e3 * harness.nearest_rank(waits, 0.5):.4f}, "
            f"p90 {1e3 * harness.nearest_rank(waits, 0.9):.4f}, max {1e3 * max(waits):.4f}")

    ctx = {"spans": {k: list(v) for k, v in spans.durations.items()}, "n_steps": n,
           "window_s": window_s, "scene_load_s": scene_load_s, "counters": counts,
           "loop": loop, "trace": None, "collected": {},
           "card": _card_line() if cuda else "cpu"}
    readers = {}
    if trace:
        readers = {m["name"]: harness.load_reader(bench_dir, m["name"]) for m in cell["per_layer"]}
        n_tr = config["trace_steps"]
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            for j in range(n_tr):
                last = None
                with torch.profiler.record_function(harness.STEP_SPAN):
                    last = loop.step(f"trace{j}")
                    sync()
                for r in readers.values():
                    if hasattr(r, "collect"):
                        r.collect(ctx, last)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        ctx["trace"] = harness.Trace.from_profiler(prof, n_tr, path)
        del prof
    mine = {"n_steps": n, "peak_bytes": int(peak), "counters": counts, "spans": ctx["spans"],
            "busy_s": ctx["trace"].busy_s() if trace else None}
    by_rank = ctx["by_rank"] = [mine] if ranks is None else ranks.gather(mine)
    if ranks is not None:
        steps = [b["n_steps"] for b in by_rank]
        log(f"# ranks' steps: {' '.join(map(str, steps))}; peak bytes: "
            f"{' '.join(str(b['peak_bytes']) for b in by_rank)}")
        if len(set(steps)) != 1:
            raise RuntimeError(f"the ranks took different numbers of steps: {steps}")
        peak = max(b["peak_bytes"] for b in by_rank)
    if hasattr(loop, "gather"):
        last = loop.gather(last)          # what the check samples, brought to rank 0

    # the program's state goes before the reference runs
    loop.release()
    del scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks is not None and not ranks.lead:
        return None
    from benchmark import reference as ref_mod

    r0 = time.perf_counter()
    ref = ref_mod.RefScene.build(loops.scene_dict(bench_dir, config), dev)
    numbers = loop.check(ref_mod, ref, last)
    log(f"# reference: {time.perf_counter() - r0:.3f} s")
    limits = cell["limits"]
    checks = {k: (v, limits[k]) for k, v in numbers.items()}
    correct = all(v == v and v <= lim for v, lim in checks.values())

    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {loop.metric: harness.rate(loop.n_rays, n, window_s),
               "step_p90_ms": harness.nearest_rank(times, 0.9) * 1e3,
               "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": len(by_rank), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr = ctx["trace"]
        device_info["busy_s"] = sum(b["busy_s"] for b in by_rank) / len(by_rank)
        if ranks is not None:
            device_info["busy_s_ranks"] = [b["busy_s"] for b in by_rank]
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    log(f"# card: {ctx['card']}; setup_s {setup_s:.3f} (scene {scene_load_s:.3f})")
    per_rank = None if ranks is None else {"steps": [b["n_steps"] for b in by_rank],
                                           "memory_peak_bytes": [b["peak_bytes"] for b in by_rank]}
    line = harness.result_line(correct, n, 0, metrics, device_info, checks, breakdown, per_rank)
    check_lines = [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in checks.items()]
    return line, check_lines


def run_ranks(name: str, seed: int, seconds: float, trace: bool, n: int, device="cuda",
              root: str = harness.ROOT, cache: str = harness.CACHE, t_start: float = T_START,
              log=print, timeout_s: float = multicard.GROUP_TIMEOUT_S):
    """Runs cell `name` as `n` ranks (this script in `n` processes) and
    waits for them; returns (result line, check lines), or None when a rank
    failed (its error is on standard error)."""
    argv = ["--workload", name, "--seed", str(seed), "--seconds", repr(seconds),
            "--trace", str(int(trace))]
    rc, got = multicard.launch(os.path.abspath(__file__), argv, n, device, root, cache, t_start,
                               log=log, timeout_s=timeout_s)
    return (got["line"], got["checks"]) if rc == 0 and got else None


def _rank_main(args) -> int:
    """One rank of a several-card run: runs the cell, and on rank 0 hands
    the result to the parent."""
    def body(ranks):
        got = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), ranks.device,
                       args.root, args.cache, multicard.started_at(args.started),
                       log=lambda s: print(s, flush=True), ranks=ranks)
        found = harness.forbidden_modules(sys.modules)
        if found:
            raise RuntimeError("modules of JAX or of the JAX package are loaded: "
                               + ", ".join(found))
        if got is not None:
            multicard.emit({"line": got[0], "checks": got[1]})
    return multicard.run_rank(body, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    multicard.add_args(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    import torch

    chips = harness.load_cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 1
    log = lambda s: print(s, flush=True)  # noqa: E731
    if chips == 1:
        line, check_lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     log=log)
    else:
        # a SIGTERM ends the launcher's wait through its clean-up, which ends the ranks
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
        got = run_ranks(args.workload, args.seed, args.seconds, bool(args.trace), chips, log=log)
        if got is None:
            return 1
        line, check_lines = got
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    print(line, flush=True)
    for c in check_lines:
        print(c, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
