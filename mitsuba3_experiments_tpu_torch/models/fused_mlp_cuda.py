"""Wrapper of the CUDA fused MLP forward (csrc/fused_mlp.cu).

Replaces the TPU kernel ``fused_mlp_forward``
(``mitsuba3_experiments_tpu/models/pallas_mlp.py:28``).  Every layer runs
on the bf16 tensor cores (mma.sync m16n8k16, float32 sums); a warp owns 16
rows at a time and keeps their activations in registers from the input to
the output, so only the (n, sizes[-1]) result is written.  All layers'
weights, rounded to bf16, are staged once per block in shared memory; the
grid holds only the blocks resident on the card, each taking `tile`-row
steps, and each warp loads its next 16 input rows while it computes the
current ones.  The kernel is bound by the bytes of its input.  See the
source for the layout.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of

# kernel launches made (a plain int, read by tests and the smoke test)
launches = 0

ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2}


def _bind(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.m3t_fused_mlp
    fn.argtypes = [vp, vp, vp, ci, ci, vp, vp, ll, ci, vp]
    fn.restype = ci
    lib.m3t_fused_mlp_grid.argtypes = [vp, ci, ll, ci]
    lib.m3t_fused_mlp_grid.restype = ll
    lib.m3t_fused_mlp_check.argtypes = [vp, ci, ci, ctypes.c_char_p, ci]
    lib.m3t_fused_mlp_check.restype = ci


LIBRARY = CudaLibrary("fused_mlp", (), _bind)


def fused_mlp_cuda(params_flat, x, sizes, hidden_act: str = "leaky_relu", tile: int = 512):
    """Kernel launch.  params_flat: (w0, b0, w1, b1, ...) float32 CUDA
    tensors, w_i (sizes[i], sizes[i+1]), b_i (sizes[i+1],); x (n,
    sizes[0]) float32 -> (n, sizes[-1]) float32.  tile: rows per block
    step (the kernel says which it takes)."""
    global launches
    sizes = tuple(int(s) for s in sizes)
    if hidden_act not in ACT_CODES:
        raise ValueError(f"fused MLP: activation {hidden_act!r} not in {sorted(ACT_CODES)}")
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"fused_mlp_cuda needs CUDA tensors, got {device}")
    n_layers = len(sizes) - 1
    if len(params_flat) != 2 * n_layers:
        raise ValueError(f"{len(params_flat)} parameter tensors for {n_layers} layers")
    n = x.shape[0]
    check_tensor("x", x, torch.float32, (n, sizes[0]), device)
    ws, bs = params_flat[0::2], params_flat[1::2]
    for i in range(n_layers):
        check_tensor(f"w{i}", ws[i], torch.float32, (sizes[i], sizes[i + 1]), device)
        check_tensor(f"b{i}", bs[i], torch.float32, (sizes[i + 1],), device)
    lib = LIBRARY.load()
    sizes_c = (ctypes.c_int * (n_layers + 1))(*sizes)
    msg = ctypes.create_string_buffer(256)
    with torch.cuda.device(device):
        if lib.m3t_fused_mlp_check(sizes_c, n_layers, int(tile), msg, len(msg)) != 0:
            raise ValueError(f"fused MLP: {msg.value.decode()}")
    out = torch.empty((n, sizes[-1]), dtype=torch.float32, device=device)
    if n == 0:
        return out
    ptrs = ctypes.c_void_p * n_layers
    with torch.cuda.device(device):
        rc = lib.m3t_fused_mlp(
            ptrs(*[w.data_ptr() for w in ws]), ptrs(*[b.data_ptr() for b in bs]),
            sizes_c, n_layers, ACT_CODES[hidden_act],
            x.data_ptr(), out.data_ptr(), int(n), int(tile), stream_of(device),
        )
    if rc != 0:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def grid_blocks(sizes, n: int, tile: int, device) -> int:
    """Blocks of the persistent grid a launch on `device` takes for n rows:
    the blocks resident on the card at once, or fewer when n has fewer
    tiles."""
    sizes = tuple(int(s) for s in sizes)
    if torch.device(device).type != "cuda":
        raise ValueError(f"grid_blocks needs a CUDA device, got {device}")
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        blocks = lib.m3t_fused_mlp_grid((ctypes.c_int * len(sizes))(*sizes), len(sizes) - 1,
                                        int(n), int(tile))
    if blocks < 1:
        raise ValueError(f"fused MLP: no grid for sizes {sizes}, n {n}, tile {tile}")
    return blocks
