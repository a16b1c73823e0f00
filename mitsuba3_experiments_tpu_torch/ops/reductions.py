"""Scatter reductions with arbitrary combiners.

Counterpart of ``mitsuba3_experiments_tpu.ops.reductions``:

  * add/min/max/mul  -> ``Tensor.scatter_reduce`` along axis 0 (on a CUDA
    tensor, float "add" goes through atomics, so its summation order may
    change from run to run);
  * an arbitrary associative combiner -> stable sort by index, then a
    segmented inclusive scan of the sorted values (log-step, each step one
    vectorised `combine`), then a scatter of each run's last element.
"""
from __future__ import annotations

import torch

_REDUCE = {"add": "sum", "mul": "prod", "min": "amin", "max": "amax"}


def _tmap(fn, *trees):
    """Apply fn leaf-wise over a tensor, or a tuple / list / dict of them."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _bcast(mask, leaf):
    return mask.reshape(mask.shape + (1,) * (leaf.dim() - mask.dim()))


def scatter_reduce(op: str, target, value, index):
    """target.at[index].op(value) along axis 0, op in {'add','min','max','mul'}."""
    if op not in _REDUCE:
        raise ValueError(f"scatter_reduce: op {op!r} not in {sorted(_REDUCE)}")
    idx = index.long()
    value = torch.as_tensor(value, dtype=target.dtype, device=target.device)
    value = value.expand(idx.shape + target.shape[1:])
    idx = _bcast(idx, value).expand_as(value)
    return target.scatter_reduce(0, idx, value, reduce=_REDUCE[op], include_self=True)


def scatter_reduce_with(combine, target, value, index):
    """Generic scatter-reduce with an associative, elementwise
    `combine(a, b)` (a the earlier element); target and value may be trees
    (tuple / list / dict) of tensors with the same structure."""
    n = index.shape[0]
    order = torch.argsort(index, stable=True)
    si = index[order]
    vals = _tmap(lambda v: v[order], value)
    pos = torch.arange(n, device=index.device)
    head = torch.ones(n, dtype=torch.bool, device=index.device)
    head[1:] = si[1:] != si[:-1]

    # segmented Hillis-Steele scan: (a, fa) + (b, fb) = (b if fb else a.b, fa|fb)
    off = 1
    while off < n:
        live = pos >= off
        src = torch.clamp(pos - off, min=0)
        take = live & ~head
        merged = combine(_tmap(lambda v: v[src], vals), vals)
        vals = _tmap(lambda mv, v: torch.where(_bcast(take, v), mv, v), merged, vals)
        head = head | (live & head[src])
        off *= 2

    is_last = torch.ones(n, dtype=torch.bool, device=index.device)
    is_last[:-1] = si[:-1] != si[1:]
    dst = si[is_last].long()

    def put(t, r):
        out = t.clone()
        out[dst] = r[is_last].to(t.dtype)
        return out

    return _tmap(put, target, vals)


def segment_sum(value, segment_ids, num_segments: int):
    """jax.ops.segment_sum: sums of `value` rows per segment id; ids outside
    [0, num_segments) are dropped."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(value.shape[1:]), dtype=value.dtype,
                      device=value.device)
    return out.index_add_(0, ids[keep], value[keep])


def block_sum(x, block: int):
    """dr.block_sum: sum over contiguous blocks of `block` rows along axis 0."""
    n = x.shape[0]
    if n % block:
        raise ValueError(f"block_sum: block {block} does not divide length {n}")
    return x.reshape((n // block, block) + tuple(x.shape[1:])).sum(dim=1)
