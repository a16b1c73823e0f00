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
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
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

from benchmark import harness, loops  # noqa: E402


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = harness.ROOT, cache: str = harness.CACHE, t_start: float = T_START,
             log=print):
    """Runs cell `name` of `root`'s BENCHMARK.json once; returns (result
    line, check lines).  `device` "cpu" runs the port's plain CPU path (for
    tests at small sizes)."""
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

    t0 = time.perf_counter()
    with spans("scene_load"):
        scene, hit = loops.load_scene(port, bench_dir, config, dev, cache)
    sync()
    scene_load_s = time.perf_counter() - t0
    log(f"# scene {config['name']}: {scene.n_faces} triangles, {scene.bvh.unified.shape[0]} BVH "
        f"rows, {'read from the cache' if hit else 'built and cached'} in {scene_load_s:.3f} s")
    t1 = time.perf_counter()
    loop = loops.LOOPS[traffic["loop"]](port, scene, config, traffic, seed, spans)
    sync()
    t2 = time.perf_counter()
    with spans("warm"):
        loop.step("warm")
    sync()
    t3 = time.perf_counter()
    setup_s = t3 - t_start
    log(f"# set-up {setup_s:.3f} s: start and imports {t_import:.3f}, scene {scene_load_s:.3f}, "
        f"inputs {t2 - t1:.3f}, warm step {t3 - t2:.3f}")
    spans.durations = {}

    port.bvh_cuda.launches = port.bvh_torch.calls = 0
    port.replay_cuda.forward_launches = port.replay_cuda.adjoint_launches = 0
    port.replay.plain_calls = 0
    times, k1_steps, last, i = [], [], None, 0
    w0 = time.perf_counter()
    while True:
        last = None                       # one step's outputs alive at a time
        k1_0 = port.bvh_cuda.launches
        s0 = time.perf_counter()
        last = loop.step(i)
        sync()
        s1 = time.perf_counter()
        times.append(s1 - s0)
        k1_steps.append(port.bvh_cuda.launches - k1_0)
        i += 1
        if s1 - w0 >= seconds:
            break
    window_s = s1 - w0
    n = len(times)
    counts = port.counters()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"# window: {n} steps in {window_s:.4f} s, {loop.n_rays} camera rays a step; "
        "per step: " + ", ".join(f"{k} {v / n:g}" for k, v in counts.items()))
    log(f"# step seconds: {' '.join(f'{t:.4f}' for t in times)}")
    log(f"# step K1 launches: {' '.join(str(k) for k in k1_steps)}")

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

    # the program's state goes before the reference runs
    loop.release()
    del scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
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
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr = ctx["trace"]
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    log(f"# card: {ctx['card']}; setup_s {setup_s:.3f} (scene {scene_load_s:.3f})")
    line = harness.result_line(correct, n, 0, metrics, device_info, checks, breakdown)
    check_lines = [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in checks.items()]
    return line, check_lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = harness.load_cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 1
    line, check_lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 log=lambda s: print(s, flush=True))
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
