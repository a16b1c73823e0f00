# Frozen copy of mitsuba3_experiments_tpu_torch/scene/mesh.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Host-side mesh utilities: canonical shape meshes (rectangle, cube, sphere),
transforms, normals, areas.

The same numpy code as ``mitsuba3_experiments_tpu.scene.mesh``, so both
scene compilers see identical triangles.  Scene compilation is host work;
device tensors are produced by scene.build.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostMesh:
    vertices: np.ndarray      # (V, 3) f32
    faces: np.ndarray         # (F, 3) i32
    normals: np.ndarray | None = None   # (V, 3) vertex normals
    uvs: np.ndarray | None = None       # (V, 2)
    flat: bool = True         # True -> shade with geometric normals

    def transformed(self, m4: np.ndarray) -> "HostMesh":
        v = self.vertices @ m4[:3, :3].T + m4[:3, 3]
        n = None
        if self.normals is not None:
            ninv = np.linalg.inv(m4[:3, :3]).T
            n = self.normals @ ninv.T
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            n = n / np.maximum(ln, 1e-20)
        det = np.linalg.det(m4[:3, :3])
        f = self.faces
        if det < 0:  # mirror transform flips winding; restore orientation
            f = f[:, ::-1].copy()
        return HostMesh(v.astype(np.float32), f.astype(np.int32), n, self.uvs, self.flat)


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def face_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return (0.5 * np.linalg.norm(n, axis=-1)).astype(np.float32)


def smooth_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (for OBJ meshes without vn records)."""
    tri = vertices[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])  # area-weighted
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    ln = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(ln, 1e-20)).astype(np.float32)


def rectangle(subdiv: int = 1) -> HostMesh:
    """Mitsuba `rectangle`: [-1,1]^2 in the XY plane, z=0, normal +Z.

    subdiv > 1 grid-subdivides the quad (subdiv^2 cells) — used for huge
    wall/floor rectangles so no single triangle dominates the BVH's bounds.
    """
    s = subdiv
    xs = np.linspace(-1, 1, s + 1, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    v = np.stack([X, Y, np.zeros_like(X)], axis=-1).reshape(-1, 3)
    uv = np.stack([(X + 1) / 2, (Y + 1) / 2], axis=-1).reshape(-1, 2)
    f = []
    for j in range(s):
        for i in range(s):
            a = j * (s + 1) + i
            b = a + 1
            c = a + s + 2
            d = a + s + 1
            f += [[a, b, c], [a, c, d]]
    n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
    return HostMesh(
        v.astype(np.float32), np.asarray(f, np.int32), n,
        uv.astype(np.float32), flat=True,
    )


def cube() -> HostMesh:
    """Mitsuba `cube`: [-1,1]^3, outward normals."""
    verts = []
    faces = []
    uvs = []
    axes = [(0, 1, 2), (0, 2, 1), (1, 2, 0)]  # (u-axis, v-axis, n-axis)
    for ua, va, na in axes:
        for sign in (1.0, -1.0):
            base = len(verts)
            for uu, vv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
                p = np.zeros(3)
                p[ua], p[va], p[na] = uu, vv, sign
                verts.append(p)
                uvs.append([(uu + 1) / 2, (vv + 1) / 2])
            if sign > 0:
                faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
            else:
                faces += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
    m = HostMesh(
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        None,
        np.asarray(uvs, np.float32),
        flat=True,
    )
    # ensure outward orientation: flip faces whose normal opposes the vertex dir
    fn = face_normals(m.vertices, m.faces)
    ctr = m.vertices[m.faces].mean(axis=1)
    flip = np.sum(fn * ctr, axis=-1) < 0
    m.faces[flip] = m.faces[flip][:, ::-1]
    return m


def sphere(center=(0, 0, 0), radius=1.0, n_theta=32, n_phi=64) -> HostMesh:
    """UV-sphere approximation of Mitsuba's analytic `sphere` shape."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(T) * np.cos(P)
    y = np.sin(T) * np.sin(P)
    z = np.cos(T)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack([P / (2 * np.pi), T / np.pi], axis=-1).reshape(-1, 2)

    def vid(i, j):
        return i * n_phi + (j % n_phi)

    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 1:
                faces.append([a, d, c])
    normals = pts.copy()
    verts = (np.asarray(center, np.float32) + radius * pts).astype(np.float32)
    return HostMesh(
        verts, np.asarray(faces, np.int32), normals.astype(np.float32),
        uv.astype(np.float32), flat=False,
    )
