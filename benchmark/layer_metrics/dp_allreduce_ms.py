"""dp_allreduce_ms: device milliseconds a traced step of the NCCL all-reduce
kernels in rank 0's trace: the film's and the gradients' all-reduces of
`parallel.sharded_replay_grad`, with rank 0's wait in them for the slowest
rank, which is what the step pays.  Moves fwd_bwd_rays_per_s."""
from benchmark.layer_metrics import _device


def is_allreduce(name: str) -> bool:
    low = name.lower()
    return "nccl" in low and "allreduce" in low


read = _device.kernel_ms("fwd_bwd_rays_per_s", is_allreduce)
