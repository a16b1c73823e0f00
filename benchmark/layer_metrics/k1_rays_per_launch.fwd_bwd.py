"""k1_rays_per_launch.fwd_bwd: rays a traversal launch over the traced steps,
closest and any hit (the port's counter `m3t.k1.rays` over its launch
counters, `bvh_cuda.launches` and `bvh_torch.calls`): the wavefront's fill.
Moves fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _spans

collect = _spans.collect
read = _spans.rays_per_launch("fwd_bwd_rays_per_s")
