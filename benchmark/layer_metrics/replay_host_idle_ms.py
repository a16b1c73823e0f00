"""replay_host_idle_ms: device-idle milliseconds a traced step in gaps that
open while the host works around K5 in the replay: in `m3t.replay.chunk`,
`m3t.k5.pack` (the packing of K5's arguments) or `m3t.replay.loss` (a chunk's
splat, develop and MSE), in no span inside them.  Read inside the profiler
window, where host-bound idle reads higher than untraced (see _spans).
Moves fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _spans

read = _spans.idle_ms("fwd_bwd_rays_per_s",
                      ("m3t.replay.chunk", "m3t.k5.pack", "m3t.replay.loss"))
