"""Polymorphic dispatch over per-lane type ids (the vcall replacement).

Counterpart of ``mitsuba3_experiments_tpu.ops.dispatch``:

  * `dispatch_masked` evaluates every callee on all lanes and selects by
    type id;
  * `dispatch_sorted` sorts lanes by type id first (stable), runs the
    masked dispatch on the sorted lanes, and scatters the results back.

Both take (fn_table, type_id, *args); results may be a tensor or a tuple
/ list / dict of tensors with the lane axis first.
"""
from __future__ import annotations

import torch

from .compaction import invert_permutation, partition_by_key
from .reductions import _bcast, _tmap


def dispatch_masked(fn_table, type_id, *args):
    out = None
    for tid, fn in enumerate(fn_table):
        res = fn(*args)
        mask = type_id == tid
        if out is None:
            out = _tmap(torch.zeros_like, res)
        out = _tmap(lambda o, r: torch.where(_bcast(mask, r), r, o), out, res)
    return out


def dispatch_sorted(fn_table, type_id, *args):
    perm = partition_by_key(type_id).long()
    inv = invert_permutation(perm)
    sorted_args = _tmap(lambda x: x[perm], args)
    out = dispatch_masked(fn_table, type_id[perm], *sorted_args)
    return _tmap(lambda x: x[inv], out)


def reorder_threads(key, trees):
    """dr.reorder_threads analog: returns (permuted trees, inverse perm)."""
    perm = partition_by_key(key).long()
    inv = invert_permutation(perm)
    return _tmap(lambda x: x[perm], trees), inv
