"""Shared arithmetic of the device-trace readers: which kernels are K1 and
K5, and the readers whose files differ only in the loop metric they are
for (`<reader>.fwd_bwd.py` and `<reader>.render.py` each bind one)."""

K1_NAMES = ("bvh8_traverse_kernel",)
K5_NAMES = ("replay_forward_kernel", "replay_adjoint_kernel")


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_NAMES)


def is_k5(name: str) -> bool:
    return any(k in name for k in K5_NAMES)


def traced(ctx, metric: str):
    """The trace of a run whose loop reports `metric`, else None."""
    if ctx["trace"] is None or ctx["loop"].metric != metric:
        return None
    return ctx["trace"]


def kernel_ms(metric: str, match):
    """read(ctx): device milliseconds a traced step of the kernels that
    `match(name)` accepts, in runs whose loop reports `metric`."""
    def read(ctx):
        tr = traced(ctx, metric)
        if tr is None:
            return None
        s = tr.kernel_s(match)
        return 1e3 * s / tr.n_steps if s > 0 else None
    return read


def eager(name: str) -> bool:
    return not is_k1(name) and not is_k5(name)


def idle_share(metric: str):
    """read(ctx): the share (%) of the traced steps' wall time in which no
    operation ran on the device, in runs whose loop reports `metric`."""
    def read(ctx):
        tr = traced(ctx, metric)
        if tr is None or tr.window_s <= 0 or tr.busy_s() <= 0:
            return None
        return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
    return read
