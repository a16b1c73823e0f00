"""dp_allreduce_bytes: the bytes rank 0's all-reduces carried a traced step
(the port's counter `m3t.dp.allreduce_bytes`, counted in
`parallel.mesh._all_reduce`): the film's (H, W, 4) float32 and the
gradients'.  A program without the counter leaves it empty.  Moves
fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _spans

collect = _spans.collect


def read(ctx):
    n = ctx["collected"].get("m3t.counts", {}).get("m3t.dp.allreduce_bytes")
    if n is None or ctx["trace"] is None:
        return None
    return n / ctx["trace"].n_steps
