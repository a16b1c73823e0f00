"""Wrapper of the CUDA blocked scan (csrc/prefix_sum.cu).

Replaces the TPU kernel ``prefix_sum_pallas`` (``ops/prefix_sum.py:26``).
That kernel carries the running total across a grid that runs its blocks
in order; CUDA blocks run in no order, so this one is reduce-then-scan in
three launches: the total of each 2048-element tile, an exclusive scan of
the totals in one block, then each tile's own scan plus its offset.  It is
bound by device memory (the input is read twice and the output written
once); int32 adds wrap, so the result equals
``torch.cumsum(x, 0, dtype=torch.int32)`` exactly.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of

# kernel launches made (one per scan), and plain scans that
# ops.prefix_sum_blocked ran in the kernel's place on a CPU tensor (plain
# ints, read by tests and the smoke test)
launches = 0
plain_calls = 0

TILE = 2048
DTYPES = {torch.float32: 0, torch.int32: 1}


def _bind(lib):
    fn = lib.m3t_prefix_sum
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, ll, ci, vp]
    fn.restype = ci
    lib.m3t_prefix_sum_tile.argtypes = []
    lib.m3t_prefix_sum_tile.restype = ci
    if lib.m3t_prefix_sum_tile() != TILE:
        raise RuntimeError("kernel library and wrapper disagree on the tile size")


LIBRARY = CudaLibrary("prefix_sum", (), _bind)


def scan_cuda(x):
    """Inclusive scan of a 1-D float32 or int32 CUDA tensor."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"scan_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"scan_cuda takes float32 or int32, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"scan_cuda takes a 1-D tensor, got shape {tuple(x.shape)}")
    n = x.shape[0]
    x = x.contiguous()
    check_tensor("x", x, x.dtype, (n,), x.device)
    out = torch.empty_like(x)
    if n == 0:
        return out
    n_tiles = (n + TILE - 1) // TILE
    totals = torch.empty((n_tiles,), dtype=x.dtype, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        rc = lib.m3t_prefix_sum(x.data_ptr(), out.data_ptr(), totals.data_ptr(), int(n),
                                DTYPES[x.dtype], stream_of(x.device))
    if rc != 0:
        raise RuntimeError(f"prefix sum kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
