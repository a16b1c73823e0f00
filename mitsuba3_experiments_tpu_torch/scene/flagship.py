"""Bedroom-class stand-in scene, built from numpy alone.

The JAX package's flagship scene (``mitsuba3_experiments_tpu.scene.flagship``)
reads the bedroom's scene XML, which is not part of the repository, and
replaces its missing OBJ meshes with procedural blobs.  `standin_dict` builds
a scene of the same class without any file: the same room shell, 72 blob
meshes with the bedroom's triangle share (one mesh holds ~75% of the budget,
as the carpet OBJ does), two area lights under the ceiling, and every BSDF
type the compiler knows.  It returns a plain dict that both packages'
``load_dict`` accept, so it serves as data for cross-checks and GPU runs.
"""
from __future__ import annotations

import copy

import numpy as np

from ..core import math as cm
from .mesh import HostMesh, sphere

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
            "to_world": cm.look_at(CAMERA_ORIGIN, target, [0.0, 1.0, 0.0]),
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
            "to_world": cm.matmul4(
                cm.translate([x, _ROOM_HI[1] - 0.1, z]),
                cm.rotate([1, 0, 0], 90),
                cm.scale_mat([0.4, 0.4, 1.0]),
            ),
            "bsdf": {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
            "emitter": {"type": "area", "radiance": [16.0, 14.0, 11.0]},
        }

    # room shell (floor + 4 walls + ceiling) so paths terminate indoors
    lo, hi = _ROOM_LO, _ROOM_HI
    cx, cy, cz = (lo + hi) / 2
    sx, sy, sz = (hi - lo) / 2
    T = cm.matmul4
    walls = {
        "floor": T(cm.translate([cx, lo[1], cz]), cm.rotate([1, 0, 0], -90), cm.scale_mat([sx, sz, 1])),
        "ceilwall": T(cm.translate([cx, hi[1], cz]), cm.rotate([1, 0, 0], 90), cm.scale_mat([sx, sz, 1])),
        "wall_zlo": T(cm.translate([cx, cy, lo[2]]), cm.scale_mat([sx, sy, 1])),
        "wall_zhi": T(cm.translate([cx, cy, hi[2]]), cm.rotate([0, 1, 0], 180), cm.scale_mat([sx, sy, 1])),
        "wall_xlo": T(cm.translate([lo[0], cy, cz]), cm.rotate([0, 1, 0], 90), cm.scale_mat([sz, sy, 1])),
        "wall_xhi": T(cm.translate([hi[0], cy, cz]), cm.rotate([0, 1, 0], -90), cm.scale_mat([sz, sy, 1])),
    }
    for name, tw in walls.items():
        d[f"_shell_{name}"] = {
            "type": "rectangle",
            "to_world": tw,
            # subdivide: room-sized triangles would blow up BVH node bounds
            "subdiv": 16,
            "bsdf": {"type": "diffuse", "reflectance": [0.65, 0.6, 0.55]},
        }
    return d
