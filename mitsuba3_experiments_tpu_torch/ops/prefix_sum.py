"""Parallel prefix sum.

Counterpart of ``mitsuba3_experiments_tpu.ops.prefix_sum``.  `prefix_sum`
is the plain scan, as the JAX package's is ``jnp.cumsum``.
`prefix_sum_blocked` is the counterpart of the TPU kernel
``prefix_sum_pallas`` (``ops/prefix_sum.py:26``): on a CUDA tensor it
launches the hand-written single-pass look-back scan
(ops/prefix_sum_cuda.py), on a CPU tensor it runs the plain scan, and any
other device raises.
"""
from __future__ import annotations

import torch

from . import prefix_sum_cuda


def prefix_sum(x, exclusive: bool = False):
    """Inclusive (default) or exclusive prefix sum along axis 0, in x's
    dtype (int32 stays int32, wrapping, as in JAX)."""
    s = torch.cumsum(x, dim=0, dtype=x.dtype)
    if exclusive:
        s = torch.cat([torch.zeros_like(s[:1]), s[:-1]], dim=0)
    return s


def prefix_sum_blocked(x):
    """Inclusive scan of a 1-D float32 or int32 tensor (the TPU kernel
    scans blocks of 2048 elements in order; the CUDA kernel, tiles of 16384
    in one pass with a look-back)."""
    if x.device.type == "cuda":
        return prefix_sum_cuda.scan_cuda(x)
    if x.device.type == "cpu":
        if x.dim() != 1 or x.dtype not in prefix_sum_cuda.DTYPES:
            raise ValueError(f"prefix_sum_blocked takes 1-D float32/int32, got {x.dtype} "
                             f"{tuple(x.shape)}")
        prefix_sum_cuda.plain_calls += 1
        return prefix_sum(x)
    raise ValueError(f"no prefix_sum_blocked for device {x.device}")
