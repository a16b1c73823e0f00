"""Shared arithmetic of the `shade_kernel_share.*` readers: the port's
counters `m3t.shade.lanes` (the lanes that the wavefront's bounces shaded,
counted in `persistent.trace_rays`) and `m3t.shade.kernel_lanes` (those that
K6, the shading kernel, shaded, counted in its wrapper), drained once a
traced step by `_spans.collect`.  A program without the first counter (a
commit before K6) leaves the readers empty."""


def kernel_share(metric: str):
    """read(ctx): 100 x kernel lanes / lanes over the traced steps, in runs
    whose loop reports `metric`."""
    def read(ctx):
        counts = ctx["collected"].get("m3t.counts", {})
        lanes = counts.get("m3t.shade.lanes")
        if ctx["loop"].metric != metric or not lanes:
            return None
        return 100.0 * counts.get("m3t.shade.kernel_lanes", 0) / lanes
    return read
