"""Wavefront OBJ loader (host side).

Counterpart of ``mitsuba3_experiments_tpu.scene.obj``: v/vn/vt/f records
with polygon fan triangulation and the v/vt/vn index forms.  `load_obj`
reads through the C++ loader of the port's host library (scene/native.py,
native/objloader.cpp); `_load_obj_py` is its plain Python reference.
"""
from __future__ import annotations

import numpy as np

from .mesh import HostMesh, smooth_vertex_normals
from .native import load_obj_native


def load_obj(path: str, face_normals: bool = False) -> HostMesh:
    """An OBJ file as a HostMesh: smooth vertex normals where the file has
    no vn records, none with `face_normals` (flat shading)."""
    v, n, uv, f = load_obj_native(path)
    if n is None and not face_normals:
        n = smooth_vertex_normals(v, f)
    return HostMesh(
        vertices=v, faces=f, normals=None if face_normals else n, uvs=uv,
        flat=face_normals or n is None,
    )


def _load_obj_py(path: str):
    positions, normals, uvs, faces = [], [], [], []
    # corner key -> output vertex index (splits vertices that disagree on vn/vt)
    corner_cache: dict[tuple, int] = {}
    out_pos, out_n, out_uv = [], [], []
    any_n = False
    any_uv = False

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                corners = line.split()[1:]
                idxs = []
                for c in corners:
                    key = c
                    if key not in corner_cache:
                        parts = (c.split("/") + ["", ""])[:3]
                        vi = int(parts[0])
                        vi = vi - 1 if vi > 0 else len(positions) + vi
                        ti = parts[1]
                        ni = parts[2]
                        out_pos.append(positions[vi])
                        if ti:
                            t = int(ti)
                            out_uv.append(uvs[t - 1 if t > 0 else len(uvs) + t])
                            any_uv = True
                        else:
                            out_uv.append([0.0, 0.0])
                        if ni:
                            nn = int(ni)
                            out_n.append(
                                normals[nn - 1 if nn > 0 else len(normals) + nn]
                            )
                            any_n = True
                        else:
                            out_n.append([0.0, 0.0, 0.0])
                        corner_cache[key] = len(out_pos) - 1
                    idxs.append(corner_cache[key])
                for k in range(1, len(idxs) - 1):  # fan triangulation
                    faces.append([idxs[0], idxs[k], idxs[k + 1]])

    v = np.asarray(out_pos, np.float32)
    f = np.asarray(faces, np.int32)
    n = np.asarray(out_n, np.float32) if any_n else None
    uv = np.asarray(out_uv, np.float32) if any_uv else None
    if n is not None:
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), n)
    return v, n, uv, f
