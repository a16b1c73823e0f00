"""Whole-record operations on frozen dataclasses of tensors.

Counterpart of ``mitsuba3_experiments_tpu.core.struct``: Dr.Jit's
whole-struct gather / scatter / select / zeros / tile / repeat.  A record is a dataclass whose fields are tensors or records; the
operations map over its tensor leaves and rebuild it with the same type.
Fields that are not tensors (ints, None) are carried from the first record.
"""
from __future__ import annotations

import dataclasses

import torch


def replace(obj, **kwargs):
    return dataclasses.replace(obj, **kwargs)


def tmap(fn, tree, *rest):
    """fn over the tensor leaves of records (or tuples of them) of one
    structure (JAX's tree_map)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tmap(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, tuple):
        return tuple(tmap(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def twhere(mask, a, b):
    """Record select: field-wise torch.where with the (N,) mask broadcast
    over trailing dims (dr.select on structs)."""
    def sel(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y)
    return tmap(sel, a, b)


def tzeros_like(tree):
    return tmap(torch.zeros_like, tree)


def tgather(tree, idx, axis: int = 0):
    """Gather records by index along `axis` (dr.gather on structs); an int
    index drops the axis, as ``jnp.take`` with a scalar does."""
    if isinstance(idx, int):
        return tmap(lambda x: x.select(axis, idx), tree)
    idx = torch.as_tensor(idx).long()
    return tmap(lambda x: torch.index_select(x, axis, idx.to(x.device)), tree)


def trepeat(record, count: int):
    """dr.repeat on a record: [a b c] -> [a a b b c c] along the wavefront
    axis (torch.repeat_interleave, not Tensor.repeat, which would tile
    [a b c a b c])."""
    return tmap(lambda x: torch.repeat_interleave(x, count, dim=0), record)


def tscatter_set(buf, value, idx):
    """Functional scatter-write of records (dr.scatter on structs): new
    tensors with buf's rows at `idx` set to value's; `buf` is unchanged,
    as with JAX's ``.at[idx].set``."""
    def put(b, v):
        return b.index_put((torch.as_tensor(idx, device=b.device).long(),), v.to(b.dtype))
    return tmap(put, buf, value)


def tscatter_add(buf, value, idx):
    """Functional scatter-add of records (``.at[idx].add``): repeated indices
    accumulate; `buf` is unchanged."""
    def add(b, v):
        return b.index_put((torch.as_tensor(idx, device=b.device).long(),), v.to(b.dtype),
                           accumulate=True)
    return tmap(add, buf, value)


def ttile(record, count: int):
    """dr.tile: [a b c] -> [a b c a b c] along axis 0."""
    return tmap(lambda x: x.repeat((count,) + (1,) * (x.dim() - 1)), record)


def tslice(record, sl):
    return tmap(lambda x: x[sl], record)


def tconcat(records, axis: int = 0):
    return tmap(lambda *xs: torch.cat(xs, dim=axis), *records)
