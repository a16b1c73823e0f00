"""Scene tables carried across as numpy arrays.

A scene crosses between packages as a flat dict keyed by field path —
``"bvh.unified"``, ``"geometry.face_packed"``, ``"emitters.face_dist.cdf"``,
… — whose values are numpy arrays, plus three plain-Python entries for the
static fields: ``"materials.kinds_present"`` (tuple), ``"camera.resolution"``
(tuple) and ``"bvh.layout"`` (dict of BVHLayout fields, or None).  Any
package whose Scene has the same field names can produce the dict, so both
packages can compute over identical tables.  `write_scene_npz` /
`read_scene_npz` keep it on disk as one .npz (the static entries and the
compiler's meta as a JSON string), for the flagship cache and for processes
that share one compiled scene.
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
import zipfile

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


def write_scene_npz(path: str, scene, meta: dict) -> None:
    """`scene`'s tables and `meta` (JSON-serializable) as one .npz at
    `path`, written under a temporary name and renamed into place."""
    flat = scene_to_numpy(scene)
    arrays = {k: v for k, v in flat.items() if k not in _STATIC}
    head = json.dumps({"static": {k: flat[k] for k in _STATIC}, "meta": meta})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __head__=np.array(head), **arrays)
    os.replace(tmp, path)


def read_scene_npz(path: str, device=None):
    """(Scene on `device` (None: the card), meta) from `write_scene_npz`'s
    file.  A file that does not load raises RuntimeError naming it."""
    try:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        head = json.loads(str(flat.pop("__head__")))
        flat.update(head["static"])
        return scene_from_numpy(flat, device), head["meta"]
    except (OSError, EOFError, ValueError, KeyError, TypeError, zipfile.BadZipFile) as e:
        raise RuntimeError(f"scene file {path} could not be read ({e!r})") from e
