"""replay_step_share.fwd_bwd: the share (%) of the rows that K5's forward
launches replayed over the traced steps that the replay's step-level loop
on the card replayed (the port's counters `m3t.replay.step_rows`, counted
in `replay._CardReplay`, over `m3t.k5.rows`, counted in
`replay_cuda.replay_forward`), drained once a traced step by
`_spans.collect`: 100 where every chunk takes the step-level loop (one
scene pack and one backward pass a step), less where chunks go through the
per-chunk autograd round.  A program without the first counter leaves it
empty.  Moves fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _spans

collect = _spans.collect


def read(ctx):
    counts = ctx["collected"].get("m3t.counts", {})
    step = counts.get("m3t.replay.step_rows")
    rows = counts.get("m3t.k5.rows")
    if ctx["loop"].metric != "fwd_bwd_rays_per_s" or step is None or not rows:
        return None
    return 100.0 * step / rows
