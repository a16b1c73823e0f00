"""Stream compaction and ray reordering: fixed-shape, sort-based.

Counterpart of ``mitsuba3_experiments_tpu.ops.compaction``.  Compaction
keeps the wavefront size and partitions: active lanes move to the front in
order, and the count comes back as a 0-d tensor.  Sorts are stable, as
``jnp.argsort`` is.
"""
from __future__ import annotations

import torch


def compress_indices(mask):
    """Indices of True lanes, packed to the front (stable), then the False
    lanes; returns (indices int32, count 0-d int32)."""
    perm = torch.argsort((~mask).to(torch.int8), stable=True)
    count = mask.to(torch.int32).sum(dtype=torch.int32)
    return perm.to(torch.int32), count


def partition_by_key(key):
    """Stable sort permutation by integer key: key[perm] is sorted."""
    return torch.argsort(key, stable=True).to(torch.int32)


def invert_permutation(perm):
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv
