"""Scene tables carried across as numpy arrays.

A scene crosses between packages as a flat dict keyed by field path —
``"bvh.unified"``, ``"geometry.face_packed"``, ``"emitters.face_dist.cdf"``,
… — whose values are numpy arrays, plus three plain-Python entries for the
static fields: ``"materials.kinds_present"`` (tuple), ``"camera.resolution"``
(tuple) and ``"bvh.layout"`` (dict of BVHLayout fields, or None).  Any
package whose Scene has the same field names can produce the dict, so both
packages can compute over identical tables.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .. import resolve_device
from . import types as T
from .bvh8 import BVHLayout

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}
_STATIC = {"materials.kinds_present", "camera.resolution", "bvh.layout"}


def _build(cls, arrays, device, prefix):
    """cls(**fields) with nested dataclasses built recursively from the
    dict entries under `prefix`."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        path, sub = prefix + f.name, hints.get(f.name)
        if path in _STATIC:
            kw[f.name] = _static_in(path, arrays[path])
        elif dataclasses.is_dataclass(sub):
            kw[f.name] = _build(sub, arrays, device, path + ".")
        else:
            a = np.array(arrays[path])  # a writable, contiguous copy
            if a.dtype not in _DTYPES:
                raise TypeError(f"{path}: dtype {a.dtype} is not float32/int32/bool")
            kw[f.name] = torch.as_tensor(a, dtype=_DTYPES[a.dtype], device=device)
    return cls(**kw)


def _static_in(path, value):
    if path == "bvh.layout":
        return None if value is None else BVHLayout(**value)
    return tuple(value)


def scene_from_numpy(arrays: dict, device=None) -> T.Scene:
    """The port's Scene, with every table on `device` (None: the card),
    from the flat dict."""
    return _build(T.Scene, arrays, resolve_device(device), "")


def scene_to_numpy(scene) -> dict:
    """The flat dict of `scene` (inverse of scene_from_numpy).

    Walks `dataclasses.fields`, so it takes any Scene with these field
    names and array-like leaves — this package's or the JAX package's."""
    out = {}

    def rec(obj, prefix):
        for f in dataclasses.fields(obj):
            path, val = prefix + f.name, getattr(obj, f.name)
            if path == "bvh.layout":
                out[path] = None if val is None else dataclasses.asdict(val)
            elif path in _STATIC:
                out[path] = tuple(val)
            elif dataclasses.is_dataclass(val):
                rec(val, path + ".")
            elif isinstance(val, torch.Tensor):
                out[path] = val.detach().cpu().numpy()
            else:
                out[path] = np.asarray(val)

    rec(scene, "")
    return out
