"""Carry the models' parameters between the JAX package and the port, as
float32 numpy arrays: the neural-radiosity field ({"grid": (L, T, F), "mlp":
[...]}), a normalizing flow (a list of MLPs) and a reparameterization map
(one MLP), each MLP a list of {"w": (in, out), "b": (out,)}."""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .nerad import Field


def _tensor(x, dev):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)


def _array(x):
    return x.detach().cpu().numpy()


def _mlp_from_numpy(mlp, dev):
    return [{"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)} for l in mlp]


def _mlp_to_numpy(mlp):
    return [{"w": _array(l["w"]), "b": _array(l["b"])} for l in mlp]


def field_params_from_numpy(tree, device=None) -> Field:
    dev = resolve_device(device)
    return Field(_tensor(tree["grid"], dev), _mlp_from_numpy(tree["mlp"], dev))


def field_params_to_numpy(field: Field) -> dict:
    return {"grid": _array(field.grid), "mlp": _mlp_to_numpy(field.mlp)}


def flow_params_from_numpy(nets, device=None) -> list:
    dev = resolve_device(device)
    return [_mlp_from_numpy(net, dev) for net in nets]


def flow_params_to_numpy(params) -> list:
    return [_mlp_to_numpy(net) for net in params]


def map_params_from_numpy(mlp, device=None) -> list:
    return _mlp_from_numpy(mlp, resolve_device(device))


def map_params_to_numpy(params) -> list:
    return _mlp_to_numpy(params)
