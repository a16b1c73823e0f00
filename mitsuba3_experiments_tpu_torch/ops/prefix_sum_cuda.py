"""Wrapper of the CUDA single-pass scan (csrc/prefix_sum.cu).

Replaces the TPU kernel ``prefix_sum_pallas`` (``ops/prefix_sum.py:26``).
That kernel carries the running total across a grid that runs its blocks
in order; CUDA blocks run in no order, so this one is a single-pass scan
with decoupled look-back in one launch: each 16384-element tile takes its
place from an atomic ticket, publishes its total, and adds up the totals of
the tiles before it from their status words.  Each element is read once and
written once, so it is bound by device memory.  int32 adds wrap, so the
result equals ``torch.cumsum(x, 0, dtype=torch.int32)`` exactly; float32
adds the earlier tiles' totals in an order that depends on timing, so its
last bits may differ from run to run.

The status words and the ticket counter live on the device from call to
call, one set per (device, stream), and are never zeroed between calls:
each call passes a new epoch, which the status words carry, and the
ticket count the counter held before it.  A call allocates only its
output (the status words grow, zeroed, when a longer input first needs
more of them).
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of, stream_scratch

# kernel launches made (one per scan), and plain scans that
# ops.prefix_sum_blocked ran in the kernel's place on a CPU tensor (plain
# ints, read by tests and the smoke test)
launches = 0
plain_calls = 0

TILE = 16384
DTYPES = {torch.float32: 0, torch.int32: 1}
_EPOCH_END = 1 << 31   # epochs run 1 .. 2^31 - 1


def _bind(lib):
    fn = lib.m3t_prefix_sum
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_ulonglong, ctypes.c_uint, ll, ci, vp]
    fn.restype = ci
    lib.m3t_prefix_sum_tile.argtypes = []
    lib.m3t_prefix_sum_tile.restype = ci
    if lib.m3t_prefix_sum_tile() != TILE:
        raise RuntimeError("kernel library and wrapper disagree on the tile size")


LIBRARY = CudaLibrary("prefix_sum", (), _bind)


class _StreamState:
    """The look-back's device memory on one (device, stream): the status
    words, the ticket counter, and the host's copy of the counter and of
    the last epoch."""

    def __init__(self, device):
        self.status = torch.zeros((0,), dtype=torch.int64, device=device)
        self.ticket = torch.zeros((1,), dtype=torch.int64, device=device)
        self.ticket_base = 0
        self.epoch = 0

    def next_call(self, n_tiles: int) -> None:
        if self.status.numel() < n_tiles:
            size = 1 << (n_tiles - 1).bit_length()
            self.status = torch.zeros((size,), dtype=torch.int64, device=self.ticket.device)
        self.epoch += 1
        if self.epoch == _EPOCH_END:
            # every epoch was used once: old words could match again
            self.status.zero_()
            self.epoch = 1


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
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = stream_of(x.device)
        state = stream_scratch("prefix_sum", x.device, stream, _StreamState)
        state.next_call(n_tiles)
        rc = lib.m3t_prefix_sum(x.data_ptr(), out.data_ptr(), state.status.data_ptr(),
                                state.ticket.data_ptr(), state.ticket_base, state.epoch,
                                int(n), DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"prefix sum kernel launch failed: CUDA error {rc}")
    state.ticket_base += n_tiles
    launches += 1
    return out
