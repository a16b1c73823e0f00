"""Carry the neural-radiosity field's parameters between the JAX package
and the port, as numpy arrays: {"grid": (L, T, F), "mlp": [{"w": (in,
out), "b": (out,)}, ...]}, float32."""
from __future__ import annotations

import numpy as np
import torch

from .nerad import Field


def field_params_from_numpy(tree, device=None) -> Field:
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return Field(t(tree["grid"]), [{"w": t(l["w"]), "b": t(l["b"])} for l in tree["mlp"]])


def field_params_to_numpy(field: Field) -> dict:
    def a(x):
        return x.detach().cpu().numpy()

    return {"grid": a(field.grid), "mlp": [{"w": a(l["w"]), "b": a(l["b"])} for l in field.mlp]}
