"""Profiling: how many device kernels a call launches, how long they run,
and named ranges in a trace.

Counterpart of ``mitsuba3_experiments_tpu.utils.profile``, which reads XLA's
cost analysis of a compiled function.  Here a call is run once under
`torch.profiler`:

  * `kernel_history(fn, *args)`: the device kernels the call launched (count,
    summed device time, the heaviest by time), its host operators and its
    peak device memory;
  * `span(name)` (alias `profile_range`): a named range in the trace
    (``torch.profiler.record_function``), and `count(name, n)`: a named
    counter, which `drain()` returns and clears.  Both work only while
    torch's profiler records, so the port's own spans and counters (the
    ``m3t.*`` names) appear in every profiled run and cost one call and one
    branch otherwise; `spanned(name)` puts each call of a function in one;
  * `trace(path)`: writes a Chrome trace of the enclosed code;
  * `benchmark(fn, *args)`: wall-clock seconds per call, the device
    synchronized around the timed loop;
  * `device_label(device)`: the card's `nvidia-smi` name and power limit,
    written beside every time a driver reports.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def device_label(device) -> str:
    """"cpu", or for a CUDA device the line `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints for it (a card set below its
    peak power runs slower under load)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={index}"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def kernel_history(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once under the profiler; returns {"kernels":
    device kernels launched, "device_ms": their summed device time, "top":
    [(name, launches, ms)] of the ten heaviest, "host_ops": aten operators called,
    "peak_bytes": `torch.cuda.max_memory_allocated()` over the call, None
    without a card}.  A CPU run launches no device kernel."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=_activities()) as prof:
        fn(*args, **kwargs)
        _sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = by_name.setdefault(e.get("name", ""), [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e3
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "kernels": sum(c for c, _ in by_name.values()),
        "device_ms": sum(ms for _, ms in by_name.values()),
        "top": [(name, c, ms) for name, (c, ms) in heavy],
        "host_ops": sum(1 for e in events if e.get("cat") == "cpu_op"),
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }


# the counters, kept only while the profiler records (autograd runs CUDA
# backward on a thread of its own, hence the lock)
_counts: dict = {}
_counts_lock = threading.Lock()
_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range in the profiler's trace (a `record_function` range,
    which the chrome trace holds as a `user_annotation` event on the
    kernels' clock) while torch's profiler records; otherwise a context that
    does nothing.  It reads no device value."""
    if not _profiling():
        return _OFF
    return record_function(name)


profile_range = span


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds the host int `n` to counter `name` while torch's profiler
    records.  A tensor is refused: reading it would wait for the device."""
    if not _profiling():
        return
    if not isinstance(n, int):
        raise TypeError(f"count({name!r}) takes a host int, got {type(n).__name__}")
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def drain() -> dict:
    """The counters added since the last drain, which it clears."""
    with _counts_lock:
        out = dict(_counts)
        _counts.clear()
    return out


@contextlib.contextmanager
def trace(path: str):
    """Profile the enclosed code and write its Chrome trace to `path`."""
    with profile(activities=_activities()) as prof:
        yield prof
        _sync()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


def benchmark(fn, *args, warmup: int = 1, iters: int = 5):
    """Seconds per call of `fn(*args)` over `iters` calls after `warmup`
    untimed ones, the device synchronized before and after the timed loop;
    returns (seconds, the last output)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters, out
