"""Wrapper of the CUDA dependent-gather chain (csrc/gather_chain.cu), K4.

Replaces the TPU kernel ``pallas_dep`` (``scripts/pallas_gather_probe.py:79``):
per lane (a chain), `iters` steps of ``row = table[idx]; acc += row[1];
idx = int(row[0])``, the whole 352-byte row fetched each step.  A group of
threads shares a chain and fetches its row with one coalesced warp load;
the group's first thread broadcasts the next index and row[1] by shuffle,
and each group interleaves a few chains to keep rows in flight.  It is
bound by the latency of the chain (one row fetch per step) and by the
bytes of the distinct rows it reaches (`gather_probe.chain_bytes`).
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of

# kernel launches made (a plain int, read by tests and the smoke test)
launches = 0

ROW_FLOATS = 88


def _bind(lib):
    fn = lib.m3t_gather_chain
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, ll, vp, ci, ci, ci, vp, vp, vp, vp]
    fn.restype = ci
    lib.m3t_gather_chain_row_floats.argtypes = []
    lib.m3t_gather_chain_row_floats.restype = ci
    if lib.m3t_gather_chain_row_floats() != ROW_FLOATS:
        raise RuntimeError("kernel library and wrapper disagree on the row width")


LIBRARY = CudaLibrary("gather_chain", (), _bind)


def dep_chain_cuda(table, idx0, iters: int, block: int = 256, check: bool = True):
    """Kernel launch: (final idx (n,) int32, acc (n,) float32) of the chain
    from idx0.  table (R, 88) float32 and idx0 (n,) int32, contiguous CUDA
    tensors on one device, the table 16-byte aligned; column 0 of the table
    holds the next row index as an exact float.  block: chains per CUDA
    block (1..1024; 1 runs one chain per block).  With `check` the call
    waits for the kernel and raises if a chain left [0, R) (its lane
    returns idx -1 instead of reading out of bounds)."""
    global launches
    device = idx0.device
    if device.type != "cuda":
        raise ValueError(f"dep_chain_cuda needs CUDA tensors, got {device}")
    n, rows = idx0.shape[0], table.shape[0]
    check_tensor("table", table, torch.float32, (rows, ROW_FLOATS), device, 16)
    check_tensor("idx0", idx0, torch.int32, (n,), device)
    if not 1 <= block <= 1024:
        raise ValueError(f"block {block} outside 1..1024 chains")
    if iters < 0 or n >= 2**31:
        raise ValueError(f"iters {iters} / n {n} outside what the kernel takes")
    out_idx = torch.empty((n,), dtype=torch.int32, device=device)
    out_acc = torch.empty((n,), dtype=torch.float32, device=device)
    # xor of every word fetched: written so that no load of the row can be
    # dropped, and discarded
    fold = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return out_idx, out_acc
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        rc = lib.m3t_gather_chain(table.data_ptr(), int(rows), idx0.data_ptr(), int(n),
                                  int(iters), int(block), out_idx.data_ptr(),
                                  out_acc.data_ptr(), fold.data_ptr(), stream_of(device))
    if rc != 0:
        raise RuntimeError(f"gather chain kernel launch failed: CUDA error {rc}")
    launches += 1
    if check and bool((out_idx < 0).any()):
        raise RuntimeError("a gather chain left the table (an index outside [0, rows))")
    return out_idx, out_acc
