"""Wrapper of the CUDA fused MLP forward (csrc/fused_mlp.cu).

Replaces the TPU kernel ``fused_mlp_forward``
(``mitsuba3_experiments_tpu/models/pallas_mlp.py:28``): one block of
`tile` threads takes `tile` rows, one thread per row; all layers' weights,
rounded to bf16, sit in shared memory and each row's activations stay on
chip from the input to the output, so only the (n, sizes[-1]) result is
written.  The kernel is bound by float32 FMA throughput; tensor cores are
not used yet.  See the source for the layout.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of

# kernel launches made (a plain int, read by tests and the smoke test)
launches = 0

ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2}


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.m3t_fused_mlp
    fn.argtypes = [vp, vp, vp, ci, ci, vp, vp, ci, ci, vp]
    fn.restype = ci
    lib.m3t_fused_mlp_check.argtypes = [vp, ci, ci, ctypes.c_char_p, ci]
    lib.m3t_fused_mlp_check.restype = ci


LIBRARY = CudaLibrary("fused_mlp", (), _bind)


def fused_mlp_cuda(params_flat, x, sizes, hidden_act: str = "leaky_relu", tile: int = 512):
    """Kernel launch.  params_flat: (w0, b0, w1, b1, ...) float32 CUDA
    tensors, w_i (sizes[i], sizes[i+1]), b_i (sizes[i+1],); x (n,
    sizes[0]) float32 -> (n, sizes[-1]) float32."""
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
    if n >= 2**31:
        raise ValueError("too many rows for one launch")
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
