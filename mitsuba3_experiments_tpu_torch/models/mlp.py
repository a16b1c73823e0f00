"""Plain MLP with bf16 products and float32 accumulation.

Counterpart of ``mitsuba3_experiments_tpu.models.mlp``.  Parameters are a
list of {'w': (in, out), 'b': (out,)} float32 tensors, in JAX's (in, out)
layout.  JAX computes each layer as ``jnp.dot(bf16, bf16,
preferred_element_type=f32)``: exact products of bf16 operands summed in
float32.  Here that is ``h.bfloat16().float() @ w.bfloat16().float()``, a
float32 matrix product of bf16-rounded operands (a bf16 matmul in torch
would round its output to bf16).  `apply_mlp` is also the plain version
of the fused kernel (models/fused_mlp.py).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

ACTS = {
    "relu": torch.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "exp": torch.exp,
    "tanh": torch.tanh,
    "none": lambda x: x,
}

# apply_mlp calls (a plain int, read by tests and the smoke test)
calls = 0


def init_mlp(generator: torch.Generator, sizes: Sequence[int], scale: float | None = None,
             device=None):
    """He-normal init; returns a list of {'w': (in, out), 'b': (out,)}
    float32 tensors, drawn from `generator` (on its own device) and moved
    to `device`."""
    params = []
    for cin, cout in zip(sizes[:-1], sizes[1:]):
        s = scale if scale is not None else math.sqrt(2.0 / cin)
        w = torch.randn((cin, cout), generator=generator, dtype=torch.float32,
                        device=generator.device) * s
        params.append({
            "w": w.to(device),
            "b": torch.zeros((cout,), dtype=torch.float32, device=device),
        })
    return params


def apply_mlp(params, x, hidden_act="leaky_relu", out_act="none",
              compute_dtype=torch.bfloat16):
    """Forward pass: bf16-rounded operands, float32 products and sums."""
    global calls
    calls += 1
    act = ACTS[hidden_act]
    h = x.to(compute_dtype)
    for i, layer in enumerate(params):
        w = layer["w"].to(compute_dtype)
        h = h.float() @ w.float() + layer["b"]
        if i < len(params) - 1:
            h = act(h).to(compute_dtype)
    return ACTS[out_act](h)


def identity_init_mlp(generator: torch.Generator, sizes: Sequence[int], eps: float = 1e-2,
                      device=None):
    """Near-identity init: small random weights plus the identity where a
    layer is square."""
    params = init_mlp(generator, sizes, scale=eps, device=device)
    for layer in params:
        w = layer["w"]
        if w.shape[0] == w.shape[1]:
            layer["w"] = w + torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    return params
