"""shade_kernel_share.fwd_bwd: the share (%) of the lanes shaded over the
traced steps that K6 shaded in one launch a bounce (the port's counters
`m3t.shade.kernel_lanes` over `m3t.shade.lanes`): 100 where the record's
wavefront shades with the kernel, 0 where it runs the eager `_shade`.
Moves fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _shade, _spans

collect = _spans.collect
read = _shade.kernel_share("fwd_bwd_rays_per_s")
