"""device_idle_share.render: the share (%) of the traced steps' wall time in
which no operation ran on the device: 100 (1 - the union of the device
operations' intervals / the window).  Moves fwd_rays_per_s."""
from benchmark.layer_metrics import _device

read = _device.idle_share("fwd_rays_per_s")
