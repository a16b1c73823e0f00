"""Dependent row-gather probe: the access pattern that floors BVH traversal.

Counterpart of the JAX package's ``scripts/pallas_gather_probe.py``.  A
traversal step cannot fetch its next BVH row before the current row says
which one it is; this probe measures that chain without the traversal
math, over a table shaped like the stand-in's unified BVH table (431,104
rows of 88 float32, column 0 holding the next row index as an exact float
below 2^24):

  * `dep_chain` — `iters` steps of ``row = table[idx]; acc += row[1];
    idx = int(row[0])`` per lane, returning (idx, acc).  On a CUDA tensor it
    launches K4 (ops/gather_probe_cuda.py) or raises; on a CPU tensor it
    runs `dep_chain_plain`, the loop of ``index_select`` (the probe's
    ``xla_dep``).
  * `ind_gather_plain` — the same number of row fetches with independent,
    precomputed indices (the probe's ``xla_ind``): gather throughput
    without the chain's latency;
  * `chain_bytes` — the least bytes a chain must move (each distinct row
    it reaches read once), from which the smoke test and the probe script
    take K4's bound.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gather_probe_cuda

ROW_FLOATS = gather_probe_cuda.ROW_FLOATS
TABLE_ROWS = 431_104   # the stand-in's unified BVH table, ~151.8 MB

# plain chains that dep_chain ran in the kernel's place on a CPU tensor (a
# plain int, read by tests and the smoke test)
plain_calls = 0


def build_table(seed: int, rows: int = TABLE_ROWS, row_floats: int = ROW_FLOATS):
    """(rows, row_floats) float32 numpy table: column 0 uniform row indices
    as exact floats, the other columns uniform in [0, 1)."""
    if rows >= 1 << 24:
        raise ValueError("row indices must stay exact in float32 (rows < 2^24)")
    rng = np.random.default_rng(seed)
    table = rng.random((rows, row_floats), dtype=np.float32)
    table[:, 0] = rng.integers(0, rows, rows).astype(np.float32)
    return table


def dep_chain_plain(table, idx0, iters: int):
    """The chain as a Python loop of index_select; (idx int32, acc float32)."""
    idx = idx0
    acc = torch.zeros(idx0.shape, dtype=torch.float32, device=idx0.device)
    for _ in range(iters):
        row = table.index_select(0, idx)
        idx = row[:, 0].to(torch.int32)
        acc = acc + row[:, 1]
    return idx, acc


def dep_chain(table, idx0, iters: int, block: int = 256):
    """(final idx, acc) of `iters` dependent row fetches per lane: K4 on a
    CUDA tensor, the plain loop on a CPU tensor."""
    global plain_calls
    if idx0.device.type == "cuda":
        return gather_probe_cuda.dep_chain_cuda(table, idx0, iters, block)
    if idx0.device.type == "cpu":
        plain_calls += 1
        return dep_chain_plain(table, idx0, iters)
    raise ValueError(f"no dep_chain for device {idx0.device}")


def ind_gather_plain(table, idxs):
    """Sum of column 1 over rows fetched with independent indices idxs
    (iters, n): one index_select per step, no step waiting for another."""
    acc = torch.zeros(idxs.shape[1:], dtype=torch.float32, device=idxs.device)
    for idx in idxs:
        acc = acc + table.index_select(0, idx)[:, 1]
    return acc


def chain_bytes(table, idx0, iters: int):
    """(distinct rows, bytes) of the chain from idx0 over iters steps: the
    rows it reaches, each read once, plus the start indices read and the
    final indices and accumulators written (int32, int32, float32)."""
    seen = torch.zeros((table.shape[0],), dtype=torch.bool, device=table.device)
    idx = idx0.long()
    for _ in range(iters):
        seen[idx] = True
        idx = table[idx, 0].long()
    distinct = int(seen.sum())
    return distinct, distinct * table.shape[1] * table.element_size() + idx0.numel() * 12
