"""fwd_bwd_rays_per_s.d65: camera rays of all steps of the timed window over
the window's time, the end-to-end `fwd_bwd_rays_per_s` as it is taken, read
in the `--trace 1` run of a cell whose rate spreads too widely from run to
run for a bound (depth 65: a host-bound record on a shared host).  Moves
peak_mem_gb, that cell's one end-to-end metric besides setup_s."""
from benchmark import harness


def read(ctx):
    loop = ctx["loop"]
    if loop.metric != "fwd_bwd_rays_per_s" or not ctx["n_steps"] or ctx["window_s"] <= 0:
        return None
    return harness.rate(loop.n_rays, ctx["n_steps"], ctx["window_s"])
