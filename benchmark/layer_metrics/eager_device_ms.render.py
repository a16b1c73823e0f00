"""eager_device_ms.render: device milliseconds a step of every kernel other than
K1 and K5 (the eager torch shading, compaction, splat and tables around
them), from the profiler trace of the traced steps.  Moves fwd_rays_per_s."""
from benchmark.layer_metrics import _device

read = _device.kernel_ms("fwd_rays_per_s", _device.eager)
