"""record_ms: mean milliseconds a step of the harness's `record` span around the
port's `record_full_pipelined` in the timed window of a
`--trace 1` run, on the host clock between synchronizations.  Moves
fwd_bwd_rays_per_s."""


def read(ctx):
    d = ctx["spans"].get("record")
    return 1e3 * sum(d) / len(d) if d else None
