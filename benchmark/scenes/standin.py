# Frozen copy, at commit aa7dcd9, of the stand-in scene generator of
# mitsuba3_experiments_tpu_torch/scene/flagship.py (standin_dict, placeholder_mesh, _room_shell,
# _checker, _MATERIALS and their constants), with the helpers it calls from scene/mesh.py
# (HostMesh, sphere) and core/math.py (look_at, translate, scale_mat, rotate, matmul4).
# Numpy only; never imported from the port.
"""The bedroom-class stand-in: a scene dict made from numpy alone.

`standin_dict(res, spp, tri_budget, seed)` returns the dict that the port's
`scene.build.load_dict` compiles and that the reference's frozen compiler
reads again: the room shell, 72 displaced-sphere blobs (one with 75% of the
triangle budget), two rectangle area lights and one material of every BSDF
type the compiler knows."""
from __future__ import annotations

import copy
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


def look_at(origin, target, up):
    """Camera-to-world matrix with Mitsuba's convention (+Z = view
    direction, +Y = up, +X = left)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    dirv = target - origin
    dirv = dirv / np.linalg.norm(dirv)
    left = np.cross(up / np.linalg.norm(up), dirv)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dirv, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dirv
    m[:3, 3] = origin
    return m.astype(np.float32)


def translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale_mat(v):
    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg):
    """Rotation matrix about `axis` by `angle_deg` degrees."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    m = np.eye(4)
    m[:3, :3] = R
    return m.astype(np.float32)


def matmul4(*ms):
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ m
    return out


# the shell encloses the bedroom camera at (3.456, 1.212, 3.299); blobs stay
# in the inner furniture box
_ROOM_LO = np.array([-3.6, -0.05, -3.6], np.float32)
_ROOM_HI = np.array([4.6, 3.0, 4.6], np.float32)
_BLOB_LO = np.array([-2.5, 0.0, -2.5], np.float32)
_BLOB_HI = np.array([2.3, 2.4, 2.3], np.float32)

CAMERA_ORIGIN = (3.456, 1.212, 3.299)
CAMERA_FOV_DEG = 65.0
N_MESHES = 72
BIG_MESH_SHARE = 0.75


def placeholder_mesh(seed: int, n_tris: int) -> HostMesh:
    """Deterministic displaced-sphere blob with ~n_tris triangles, placed
    inside the room box (the JAX package's placeholder, unchanged)."""
    n_tris = int(np.clip(n_tris, 64, 1_600_000))
    # sphere(n_theta, n_phi) -> ~2 * n_theta * n_phi tris
    n_theta = max(4, int(np.sqrt(n_tris / 4)))
    n_phi = max(8, 2 * n_theta)
    base = sphere(radius=1.0, n_theta=n_theta, n_phi=n_phi)
    rng = np.random.default_rng(seed)
    # radial displacement: few random low-frequency lobes -> blobby furniture
    v = base.vertices
    disp = np.zeros(len(v), np.float32)
    for _ in range(6):
        d = rng.normal(size=3).astype(np.float32)
        d /= np.linalg.norm(d)
        disp += 0.15 * np.cos(3.0 * (v @ d) + rng.uniform(0, 6.28)).astype(
            np.float32
        )
    v = v * (1.0 + disp[:, None] * 0.5)
    # anisotropic scale + placement in the room
    scale = 0.12 + 0.45 * rng.random(3).astype(np.float32)
    pos = _BLOB_LO + (0.1 + 0.8 * rng.random(3).astype(np.float32)) * (
        _BLOB_HI - _BLOB_LO
    )
    v = v * scale + pos
    return HostMesh(
        v.astype(np.float32), base.faces, None, base.uvs, flat=True
    )


def _room_shell() -> dict:
    """Floor, four walls and ceiling, so paths terminate indoors."""
    lo, hi = _ROOM_LO, _ROOM_HI
    cx, cy, cz = (lo + hi) / 2
    sx, sy, sz = (hi - lo) / 2
    T = matmul4
    walls = {
        "floor": T(translate([cx, lo[1], cz]), rotate([1, 0, 0], -90), scale_mat([sx, sz, 1])),
        "ceilwall": T(translate([cx, hi[1], cz]), rotate([1, 0, 0], 90), scale_mat([sx, sz, 1])),
        "wall_zlo": T(translate([cx, cy, lo[2]]), scale_mat([sx, sy, 1])),
        "wall_zhi": T(translate([cx, cy, hi[2]]), rotate([0, 1, 0], 180), scale_mat([sx, sy, 1])),
        "wall_xlo": T(translate([lo[0], cy, cz]), rotate([0, 1, 0], 90), scale_mat([sz, sy, 1])),
        "wall_xhi": T(translate([hi[0], cy, cz]), rotate([0, 1, 0], -90), scale_mat([sz, sy, 1])),
    }
    return {
        f"_shell_{name}": {
            "type": "rectangle",
            "to_world": tw,
            # subdivide: room-sized triangles would blow up BVH node bounds
            "subdiv": 16,
            "bsdf": {"type": "diffuse", "reflectance": [0.65, 0.6, 0.55]},
        }
        for name, tw in walls.items()
    }


def _checker(c0, c1):
    return {"type": "checkerboard", "color0": list(c0), "color1": list(c1)}


# one named BSDF per compiler type; checkerboard textures on three of them
_MATERIALS = {
    "m_diffuse": {"type": "diffuse", "reflectance": _checker((0.6, 0.5, 0.4), (0.3, 0.25, 0.2))},
    "m_conductor": {"type": "conductor", "material": "Au"},
    "m_roughconductor": {"type": "roughconductor", "material": "Cu", "alpha": 0.2},
    "m_dielectric": {"type": "dielectric", "int_ior": "bk7"},
    "m_roughdielectric": {"type": "roughdielectric", "int_ior": 1.5, "alpha": 0.15},
    "m_plastic": {"type": "plastic", "diffuse_reflectance": [0.2, 0.4, 0.6]},
    "m_roughplastic": {
        "type": "roughplastic", "alpha": 0.2,
        "diffuse_reflectance": _checker((0.7, 0.2, 0.2), (0.2, 0.2, 0.7)),
    },
    "m_mask": {"type": "mask", "opacity": 0.6,
               "bsdf": {"type": "diffuse", "reflectance": [0.5, 0.6, 0.3]}},
    "m_twosided": {"type": "twosided",
                   "bsdf": {"type": "diffuse", "reflectance": [0.55, 0.5, 0.45]}},
    "m_null": {"type": "null"},
    "m_principled": {
        "type": "principled", "metallic": 0.5, "roughness": 0.4,
        "base_color": _checker((0.8, 0.7, 0.5), (0.4, 0.3, 0.2)),
    },
}


def standin_dict(res=(1280, 720), spp: int = 4, tri_budget: int = 2_000_000,
                 seed: int = 1234) -> dict:
    """The stand-in scene dict (numpy only).

    Camera: at (3.456, 1.212, 3.299), the bedroom camera's position, looking
    at the centre of the furniture box, with a horizontal fov of 65 degrees.
    The bedroom's own fov was in its scene XML, which is not in the
    repository; 65 degrees is this stand-in's choice.  Tent filter, path
    integrator with max_depth 8.
    """
    w, h = res
    target = (_BLOB_LO + _BLOB_HI) / 2
    d: dict = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "perspective",
            "fov": CAMERA_FOV_DEG,
            "fov_axis": "x",
            "to_world": look_at(CAMERA_ORIGIN, target, [0.0, 1.0, 0.0]),
            "sampler": {"type": "independent", "sample_count": spp},
            "film": {"type": "hdrfilm", "width": w, "height": h, "rfilter": "tent"},
        },
    }
    d.update(copy.deepcopy(_MATERIALS))
    names = list(_MATERIALS)

    big = int(BIG_MESH_SHARE * tri_budget)
    small = (tri_budget - big) // (N_MESHES - 1)
    for i in range(N_MESHES):
        hm = placeholder_mesh(seed + i, big if i == 0 else small)
        # the big mesh stays diffuse; the rest cycle through every type
        mat = "m_diffuse" if i == 0 else names[(i - 1) % len(names)]
        d[f"mesh_{i:02d}"] = {
            "type": "mesh", "vertices": hm.vertices, "faces": hm.faces,
            "uvs": hm.uvs, "bsdf": {"type": "ref", "id": mat},
        }

    # two rectangle area lights just under the ceiling, facing down
    for k, (x, z) in enumerate(((0.5, 0.8), (-1.4, -1.2))):
        d[f"light_{k}"] = {
            "type": "rectangle",
            "to_world": matmul4(
                translate([x, _ROOM_HI[1] - 0.1, z]),
                rotate([1, 0, 0], 90),
                scale_mat([0.4, 0.4, 1.0]),
            ),
            "bsdf": {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
            "emitter": {"type": "area", "radiance": [16.0, 14.0, 11.0]},
        }

    d.update(_room_shell())
    return d
