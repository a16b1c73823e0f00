"""The fused MLP forward, with a recomputing backward.

Counterpart of ``mitsuba3_experiments_tpu.models.pallas_mlp``:

  * `fused_mlp_forward` launches the hand-written CUDA kernel
    (models/fused_mlp_cuda.py) on CUDA tensors and runs the plain version,
    `apply_mlp`, on CPU tensors; any other device raises.  Nothing falls
    back from one to the other.
  * `fused_apply_mlp` is the differentiable form (a torch.autograd.Function
    in place of JAX's custom_vjp): the forward is `fused_mlp_forward`, the
    backward recomputes `apply_mlp` from the saved (params, x) under
    autograd and returns its gradients, as ``_fused_bwd`` does.  There is no
    backward kernel, as there is none in the JAX package.

`tile` is the number of rows one CUDA block takes (one thread per row), as
it is the rows per grid step of the TPU kernel; the CPU path ignores it.
"""
from __future__ import annotations

import torch

from . import fused_mlp_cuda
from .mlp import apply_mlp

# backward recomputes of apply_mlp (a plain int): the plain forwards that
# ran on a fused path are mlp.calls minus this
recomputes = 0


def mlp_params_flat(params):
    """models/mlp.py param list -> flat tuple (w0, b0, w1, b1, ...)."""
    flat = []
    for layer in params:
        flat += [layer["w"], layer["b"]]
    return tuple(flat)


def _layers(params_flat):
    return [{"w": w, "b": b} for w, b in zip(params_flat[0::2], params_flat[1::2])]


def fused_mlp_forward(params_flat, x, sizes: tuple, hidden_act: str = "leaky_relu",
                      tile: int = 512):
    """params_flat: (w0, b0, w1, b1, ...); x: (N, sizes[0]) -> (N, sizes[-1])
    float32."""
    if x.device.type == "cuda":
        return fused_mlp_cuda.fused_mlp_cuda(params_flat, x, sizes, hidden_act, tile)
    if x.device.type == "cpu":
        return apply_mlp(_layers(params_flat), x, hidden_act=hidden_act)
    raise ValueError(f"no fused MLP for device {x.device}")


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hidden_act, tile, *params_flat):
        sizes = (params_flat[0].shape[0],) + tuple(w.shape[1] for w in params_flat[0::2])
        ctx.hidden_act = hidden_act
        ctx.save_for_backward(x, *params_flat)
        return fused_mlp_forward(params_flat, x, sizes, hidden_act, tile)

    @staticmethod
    def backward(ctx, g):
        global recomputes
        recomputes += 1
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = apply_mlp(_layers(leaves[1:]), leaves[0], hidden_act=ctx.hidden_act)
        grads = torch.autograd.grad(out, leaves, g)
        return (grads[0], None, None) + tuple(grads[1:])


def fused_apply_mlp(params, x, hidden_act: str = "leaky_relu", tile: int = 512):
    """Differentiable stand-in for apply_mlp(params, x, hidden_act) with
    out_act="none": the fused forward, the recomputing backward."""
    return _FusedMLP.apply(x, hidden_act, tile, *mlp_params_flat(params))
