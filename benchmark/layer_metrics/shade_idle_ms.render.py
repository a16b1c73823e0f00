"""shade_idle_ms.render: device-idle milliseconds a traced step in gaps that
open while the host is in `m3t.shade` (the eager shading) and in no span
inside it.  Read inside the profiler window, where host-bound idle reads
higher than untraced (see _spans).  Moves fwd_rays_per_s."""
from benchmark.layer_metrics import _spans

read = _spans.idle_ms("fwd_rays_per_s", ("m3t.shade",))
