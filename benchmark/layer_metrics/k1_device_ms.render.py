"""k1_device_ms.render: device milliseconds of K1 (`bvh8_traverse_kernel`, the
BVH traversal) a step, from the profiler trace of the traced steps.  Moves
fwd_rays_per_s."""
from benchmark.layer_metrics import _device

read = _device.kernel_ms("fwd_rays_per_s", _device.is_k1)
