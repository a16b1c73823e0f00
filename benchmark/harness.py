"""The benchmark's general parts: the spec and what it names, the spans, the
statistics, the profiler trace and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own that this module finds by the
name `BENCHMARK.json` gives it:

  * a configuration: the file its `configs` entry names (`configs/<name>.json`);
  * a traffic mix: `traffic/<traffic>.json`, parameters of the loop its
    "loop" key names: an entry of `loops.LOOPS` or a loop file;
  * a loop file: `loop_kinds/<loop>.py`, whose `LOOP` is a class with the
    interface of `loops.Loop` (`metric`, `n_rays`, `step(i)`,
    `check(ref_mod, ref, out, control=False)`, `release()`, optionally
    `gather(out)`), built as `LOOP(port, scene, config, traffic, seed, spans,
    ranks=...)`: `ranks` (`multicard.Ranks`) gives its rank, the rank count,
    its device and the process group for its collectives (None on one
    card).  `n_rays` is the whole frame's, over all ranks;
  * a per-layer metric: `layer_metrics/<name>.py`, with `read(ctx)` (and,
    if it needs each traced step's outputs, `collect(ctx, out)`).  `ctx`
    holds rank 0's spans, counters, trace and loop, and `ctx["by_rank"]`
    each rank's `n_steps`, `peak_bytes`, `counters`, `spans` (host-clock
    durations by name) and `busy_s` (traced runs; else None), in rank order;
  * a cell's limits on the numbers `correct` compares: `limits/<workload>.json`.
"""
from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# top-level module names that must not be loaded in a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "mitsuba3_experiments_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` of `root`'s BENCHMARK.json with everything it names:
    {"workload", "config", "traffic", "limits", "end_to_end", "per_layer"}
    (the metrics the cell reports, each a spec entry)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    bench = os.path.dirname(os.path.dirname(os.path.join(root, conf["file"])))   # <bench>/configs/
    traffic = load_json(os.path.join(bench, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(bench, "limits", name + ".json"))

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "workload": cell, "config": config, "traffic": traffic, "limits": limits,
        "end_to_end": [e for e in spec["end_to_end"] if mine(e)],
        "per_layer": [e for e in spec["per_layer"] if mine(e)],
        "bench_dir": bench, "run_seconds": spec["run_seconds"],
    }


def _load_path(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir: str, name: str):
    """The module of `layer_metrics/<name>.py` (loaded by path: metric names
    hold dots)."""
    return _load_path(os.path.join(bench_dir, "layer_metrics", name + ".py"),
                      f"_layer_metric_{name.replace('.', '_')}")


def load_loop(bench_dir: str, name: str):
    """make(port, scene, config, traffic, seed, spans, ranks=...) of the
    loop a mix's "loop" names: an entry of `loops.LOOPS`, which runs on one
    card and is built without `ranks`, or else `loop_kinds/<name>.py`'s
    `LOOP` (loaded by path), built with it.  A name found in neither place
    raises KeyError."""
    from benchmark import loops

    if name in loops.LOOPS:
        cls = loops.LOOPS[name]

        def make(*args, ranks):
            if ranks.size > 1:
                raise ValueError(f"loop {name!r} of loops.LOOPS runs on one card; a cell of "
                                 f"{ranks.size} ranks needs a loop file under loop_kinds/")
            return cls(*args)
        return make
    path = os.path.join(bench_dir, "loop_kinds", name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no loop {name!r}: neither an entry of loops.LOOPS "
                       f"({', '.join(loops.LOOPS)}) nor a file {path}")
    cls = _load_path(path, f"_loop_kind_{name.replace('.', '_')}").LOOP
    return lambda *args, ranks: cls(*args, ranks=ranks)


def sub_seed(seed: int, tag: str) -> int:
    """A 32-bit seed for one purpose (`tag`) of a run's `--seed` (any
    whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:4], "little")


# ------------------------------------------------------------------ statistics
def rate(units_per_step: float, n_steps: int, seconds: float) -> float:
    """Units of all completed steps over the window's seconds."""
    return units_per_step * n_steps / seconds


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) by the nearest-rank rule: the
    ceil(q n)-th smallest value."""
    v = sorted(values)
    return v[max(1, math.ceil(q * len(v))) - 1]


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals (in their unit)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# ----------------------------------------------------------------------- spans
class Spans:
    """The harness's spans around each call into the port.  Off (`on`
    False) they do nothing; on, each is a `torch.profiler.record_function`
    range and a host-clock duration taken between two synchronizations."""

    def __init__(self, on: bool, sync):
        self.on = on
        self.sync = sync
        self.durations: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self.sync()
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)


# ----------------------------------------------------------------------- trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SPAN = "bench.step"
NAME_WIDTH = 160


class Trace:
    """A profiler trace (chrome JSON) cut to the traced steps: the device
    operations and the harness's annotations inside the steps' `STEP_SPAN`
    ranges (what runs between two traced steps is left out)."""

    def __init__(self, events: list, n_steps: int):
        self.steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                            if e.get("cat") == "user_annotation" and e.get("name") == STEP_SPAN)
        self.device = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            for a, b in self.steps:
                lo, hi = max(e["ts"], a), min(e["ts"] + e["dur"], b)
                if hi > lo:
                    self.device.append({"name": e.get("name", ""), "cat": e["cat"],
                                        "ts": lo, "dur": hi - lo})
        self.spans = [e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "user_annotation"]
        self.n_steps = n_steps

    @staticmethod
    def from_profiler(prof, n_steps: int, path: str) -> "Trace":
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events, n_steps)

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.steps) / 1e6

    def busy_s(self) -> float:
        return union_s((e["ts"], e["ts"] + e["dur"]) for e in self.device) / 1e6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name `match(name)` accepts."""
        return sum(e["dur"] for e in self.device
                   if e["cat"] == "kernel" and match(e["name"])) / 1e6

    def top_ops(self, n: int = 10):
        """The `n` device operations (by name, cut to NAME_WIDTH characters:
        the elementwise kernels' template names run to a thousand) with the
        most device seconds."""
        by = {}
        for e in self.device:
            k = e["name"][:NAME_WIDTH]
            by[k] = by.get(k, 0.0) + e["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest stretches of the traced steps with no device
        operation, each named by the innermost harness span open at its
        start."""
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        gaps = []
        for s0, s1 in self.steps:
            end = s0
            for a, b in iv:
                if b <= s0 or a >= s1:
                    continue
                if a > end:
                    gaps.append((end, a))
                end = max(end, b)
            if s1 > end:
                gaps.append((end, s1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            open_ = [s for s in self.spans if s["ts"] <= a < s["ts"] + s["dur"]]
            name = (min(open_, key=lambda s: (s["dur"], s["name"] == STEP_SPAN))["name"]
                    if open_ else "(no span)")
            out.append([name, (b - a) / 1e6])
        return out


# ---------------------------------------------------------------------- output
def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None, ranks=None) -> str:
    """The last line of standard output; `ranks` (a several-card run's
    readings by rank) before `checks` ({name: (value, limit)}), which comes
    last."""
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if ranks is not None:
        out["ranks"] = ranks
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN."""
    return sorted({name for name in modules if name.split(".", 1)[0] in FORBIDDEN})
