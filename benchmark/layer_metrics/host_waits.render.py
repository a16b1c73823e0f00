"""host_waits.render: the port's `m3t.wait` spans a traced step, each one
statement that makes the host wait for the device.  Moves fwd_rays_per_s."""
from benchmark.layer_metrics import _spans

read = _spans.span_count("fwd_rays_per_s", _spans.WAIT)
