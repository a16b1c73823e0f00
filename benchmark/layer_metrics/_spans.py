"""Shared arithmetic of the readers of the port's own spans and counters
(`mitsuba3_experiments_tpu_torch.utils.profile`): the `m3t.*` ranges, which
the profiler's trace holds as `user_annotation` events on the kernels' clock,
and the counters that the port keeps while the profiler records and that
`drain()` returns.

A program without them (a commit before they existed) leaves every such
reader empty: no `m3t.*` span in the trace, no `drain` to call.

The idle readers read inside the profiler window, where every aten operator
is recorded: host-bound idle reads higher there than in an untraced step, as
`device_idle_share` does.  Parent and change are traced alike, so a
comparison of the two holds."""
import importlib

from benchmark.layer_metrics import _device

PREFIX = "m3t."
WAIT = "m3t.wait"


def _drain(ctx):
    """The port's `utils.profile.drain`, or None where it has none."""
    try:
        mod = importlib.import_module(ctx["loop"].port.PKG + ".utils.profile")
    except ImportError:
        return None
    return getattr(mod, "drain", None)


def _traversals(counters: dict) -> int:
    """Traversal launches in the port's own counters (`Port.counters()`):
    K1's on the card, the plain traversal's elsewhere."""
    return counters["k1"] + counters["plain_traversals"]


def collect(ctx, out):
    """Once a traced step: drains the port's counters and adds them up in
    ctx["collected"]["m3t.counts"], and adds the step's traversal launches
    (the change in the port's launch counters since the window's, or the
    last traced step's, reading) to ctx["collected"]["k1_launches"].  Every
    counter reader's `collect` is this one: the harness calls each after
    every traced step, and the first call after a step does the work."""
    col = ctx["collected"]
    step = ctx["loop"].steps_taken
    if col.get("m3t.drained_at") == step:
        return
    col["m3t.drained_at"] = step
    now = _traversals(ctx["loop"].port.counters())
    col["k1_launches"] = (col.get("k1_launches", 0) + now
                          - col.get("k1_seen", _traversals(ctx["counters"])))
    col["k1_seen"] = now
    drain = _drain(ctx)
    if drain is None:
        return
    counts = col.setdefault("m3t.counts", {})
    for k, v in drain().items():
        counts[k] = counts.get(k, 0) + v


def _in_steps(tr, span) -> bool:
    return any(a <= span["ts"] < b for a, b in tr.steps)


def _spans_traced(ctx, metric: str):
    """The trace of a run whose loop reports `metric`, if the port put its
    spans there; else None."""
    tr = _device.traced(ctx, metric)
    if tr is None or not any(s["name"].startswith(PREFIX) for s in tr.spans):
        return None
    return tr


def span_count(metric: str, name: str):
    """read(ctx): the spans `name` a traced step, in runs whose loop reports
    `metric`."""
    def read(ctx):
        tr = _spans_traced(ctx, metric)
        if tr is None:
            return None
        return sum(1 for s in tr.spans if s["name"] == name and _in_steps(tr, s)) / tr.n_steps
    return read


def idle_ms_by_span(ctx, tr) -> dict:
    """{span name: device-idle milliseconds}: every idle gap of the traced
    steps (`Trace.idle_gaps` over all of them), named by the innermost span
    open at its start, as the breakdown names its ten longest; worked out
    once a run."""
    col = ctx["collected"]
    if "m3t.idle_ms" not in col:
        by = {}
        for name, s in tr.idle_gaps(len(tr.device) + len(tr.steps)):
            by[name] = by.get(name, 0.0) + 1e3 * s
        col["m3t.idle_ms"] = by
    return col["m3t.idle_ms"]


def idle_ms(metric: str, names):
    """read(ctx): device-idle milliseconds a traced step in gaps that open
    inside one of the spans `names`, in runs whose loop reports `metric`."""
    def read(ctx):
        tr = _spans_traced(ctx, metric)
        if tr is None or tr.busy_s() <= 0:
            return None
        by = idle_ms_by_span(ctx, tr)
        return sum(by.get(n, 0.0) for n in names) / tr.n_steps
    return read


def rays_per_launch(metric: str):
    """read(ctx): the port's counter `m3t.k1.rays` over the traversal
    launches, summed over the traced steps, in runs whose loop reports
    `metric`."""
    def read(ctx):
        col = ctx["collected"]
        rays = col.get("m3t.counts", {}).get("m3t.k1.rays")
        if ctx["loop"].metric != metric or rays is None or not col.get("k1_launches"):
            return None
        return rays / col["k1_launches"]
    return read
