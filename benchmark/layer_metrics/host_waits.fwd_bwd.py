"""host_waits.fwd_bwd: the port's `m3t.wait` spans a traced step, each one
statement that makes the host wait for the device (the K1 overflow check,
the compaction's `nonzero` and boolean-mask reads, copies from the host, a
`.tolist()` of the replay).  Moves fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _spans

read = _spans.span_count("fwd_bwd_rays_per_s", _spans.WAIT)
