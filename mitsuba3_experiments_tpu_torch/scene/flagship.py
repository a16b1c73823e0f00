"""The flagship bedroom scene, and a bedroom-class stand-in built from numpy.

Counterpart of ``mitsuba3_experiments_tpu.scene.flagship``.  `bedroom_dict`
reads the bedroom's scene XML (camera, emitters, BSDFs, the 72 shape records
with their transforms) and replaces each OBJ that is a git-LFS pointer, or
missing, with a procedural blob whose triangle budget follows the pointer's
`size` line; `load_flagship` compiles it and caches the tables on disk.  The
XML is not committed: by default it is read from `data/bedroom/scene.xml`
inside the repository (git ignores `data/`), and `load_flagship` raises
when the file is absent.

`standin_dict` builds a scene of the same class without any file: the same
room shell, 72 blob meshes with the bedroom's triangle share (one mesh holds
~75% of the budget, as the carpet OBJ does), two area lights under the
ceiling, and every BSDF type the compiler knows.  It returns a plain dict
that both packages' ``load_dict`` accept, so it serves as data for
cross-checks and GPU runs.
"""
from __future__ import annotations

import copy
import hashlib
import os
import re

import numpy as np

from .. import resolve_device
from ..core import math as cm
from .mesh import HostMesh, sphere
from .obj import is_lfs_pointer

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# where a user puts the bedroom's scene XML (and the files it names) inside
# the repository; read at call time, so a caller may point it elsewhere
REFERENCE_BEDROOM = os.path.join(_REPO, "data", "bedroom", "scene.xml")
CACHE_DIR = os.path.join(_REPO, ".scene_cache")

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
    T = cm.matmul4
    walls = {
        "floor": T(cm.translate([cx, lo[1], cz]), cm.rotate([1, 0, 0], -90), cm.scale_mat([sx, sz, 1])),
        "ceilwall": T(cm.translate([cx, hi[1], cz]), cm.rotate([1, 0, 0], 90), cm.scale_mat([sx, sz, 1])),
        "wall_zlo": T(cm.translate([cx, cy, lo[2]]), cm.scale_mat([sx, sy, 1])),
        "wall_zhi": T(cm.translate([cx, cy, hi[2]]), cm.rotate([0, 1, 0], 180), cm.scale_mat([sx, sy, 1])),
        "wall_xlo": T(cm.translate([lo[0], cy, cz]), cm.rotate([0, 1, 0], 90), cm.scale_mat([sz, sy, 1])),
        "wall_xhi": T(cm.translate([hi[0], cy, cz]), cm.rotate([0, 1, 0], -90), cm.scale_mat([sz, sy, 1])),
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

    d.update(_room_shell())
    return d


# ---- the bedroom from its scene XML --------------------------------------------

def _lfs_size(path: str) -> int:
    """The `size` line of a git-LFS pointer; 100,000 when the file has none
    or cannot be read."""
    try:
        with open(path, "rb") as f:
            head = f.read(200).decode(errors="replace")
        mch = re.search(r"size (\d+)", head)
        return int(mch.group(1)) if mch else 100_000
    except OSError:
        return 100_000


def bedroom_dict(res=(1280, 720), spp: int = 64, tri_budget: int = 2_000_000,
                 xml_path: str | None = None) -> dict:
    """The flagship scene dict: the XML's skeleton (`xml_path`, None for
    REFERENCE_BEDROOM) with a placeholder blob for each LFS-pointer or
    missing OBJ, checkerboards for LFS-pointer bitmaps, and the room shell."""
    from .xml import load_xml_dict

    d = load_xml_dict(REFERENCE_BEDROOM if xml_path is None else xml_path)
    if res is not None:
        d["sensor"]["film"]["width"] = res[0]
        d["sensor"]["film"]["height"] = res[1]
        d["sensor"].setdefault("sampler", {})["sample_count"] = spp

    # per-mesh triangle budgets from the LFS sizes
    objs = [k for k, v in d.items() if isinstance(v, dict) and v.get("type") == "obj"]
    sizes = {k: _lfs_size(d[k]["filename"]) for k in objs}
    total = sum(sizes.values())
    i = 0
    for key in objs:
        val = d[key]
        if not is_lfs_pointer(val["filename"]):
            continue  # real data present: use it
        n_tris = max(64, int(tri_budget * sizes[key] / max(total, 1)))
        hm = placeholder_mesh(1234 + i, n_tris)
        i += 1
        repl = {"type": "mesh", "vertices": hm.vertices, "faces": hm.faces, "uvs": hm.uvs}
        for k in ("to_world", "bsdf", "emitter"):
            if val.get(k) is not None:
                repl[k] = val[k]
        d[key] = repl

    _strip_missing_textures(d)
    d.update(_room_shell())
    return d


def _strip_missing_textures(d):
    """Replaces every bitmap texture whose file is an LFS pointer (or
    missing) with a checkerboard, in place."""
    for v in list(d.values()):
        if isinstance(v, dict):
            if v.get("type") == "bitmap" and "filename" in v and is_lfs_pointer(v["filename"]):
                v.clear()
                v.update({"type": "checkerboard", "color0": [0.5, 0.45, 0.4],
                          "color1": [0.3, 0.28, 0.25]})
            else:
                _strip_missing_textures(v)


def _files(d):
    """Every `filename` in a scene dict, in dict order."""
    for v in d.values():
        if isinstance(v, dict):
            if "filename" in v:
                yield v["filename"]
            yield from _files(v)


def _build_sources():
    """The files whose code turns a scene dict into the cached tables: this
    package's `scene/*.py` and the host library's C++ sources."""
    from .native import SOURCES

    here = os.path.dirname(os.path.abspath(__file__))
    return sorted(os.path.join(here, f) for f in os.listdir(here) if f.endswith(".py")) + list(
        SOURCES)


def cache_key(res, spp: int, tri_budget: int, xml_path: str) -> str:
    """The cache file's name: the settings, the default BVH layout, and a
    hash of the code that builds the tables (`_build_sources`), of the XML's
    bytes and of the head and size of each file it names (a changed
    pointer's `size` changes the meshes)."""
    from .bvh8 import DEFAULT_LAYOUT as lay
    from .xml import load_xml_dict

    h = hashlib.sha256()
    for src in _build_sources():
        with open(src, "rb") as f:
            h.update(f.read())
    with open(xml_path, "rb") as f:
        h.update(f.read())
    for name in _files(load_xml_dict(xml_path)):
        h.update(name.encode())
        try:
            with open(name, "rb") as f:
                h.update(f"{os.fstat(f.fileno()).st_size}:".encode() + f.read(200))
        except OSError:
            h.update(b"missing")
    sd = "auto" if lay.stack_depth is None else lay.stack_depth
    return (f"torch_flagship_{res[0]}x{res[1]}_spp{spp}_t{tri_budget}_w{lay.width}"
            f"_lc{lay.leaf_cap}_{lay.collapse}_sbvh{int(lay.sbvh)}a{lay.sbvh_alpha:g}_st{sd}"
            f"_{h.hexdigest()[:16]}")


def load_flagship(res=(1280, 720), spp: int = 64, tri_budget: int = 2_000_000,
                  cache_dir: str | None = CACHE_DIR, xml_path: str | None = None,
                  device=None):
    """Compile the flagship scene -> (Scene, meta) on `device` (None: the
    card).  The tables are cached as one .npz in `cache_dir` (None: no
    cache), under `cache_key`; a cache file that exists but does not load
    raises.  An absent XML raises FileNotFoundError; nothing falls back to
    `standin_dict`."""
    from .build import load_dict
    from .convert import read_scene_npz, write_scene_npz

    xml = REFERENCE_BEDROOM if xml_path is None else xml_path
    if not os.path.isfile(xml):
        raise FileNotFoundError(f"the flagship scene XML {xml} does not exist")
    device = resolve_device(device)
    path = None
    if cache_dir:
        path = os.path.join(cache_dir, cache_key(res, spp, tri_budget, xml) + ".npz")
        if os.path.exists(path):
            return read_scene_npz(path, device)
    scene, meta = load_dict(bedroom_dict(res, spp, tri_budget, xml_path=xml), device=device)
    if path is not None:
        write_scene_npz(path, scene, meta)
    return scene, meta


def load_bedroom(kind: str, res=(1280, 720), spp: int = 4, tri_budget: int = 2_000_000,
                 xml_path: str | None = None, cache_dir: str | None = CACHE_DIR, device=None):
    """The drivers' scene: "standin" (`standin_dict`, compiled) or
    "flagship" (`load_flagship` of `xml_path`, which raises when the XML is
    absent).  Returns (Scene, meta)."""
    from .build import load_dict

    if kind == "flagship":
        return load_flagship(res, spp, tri_budget, cache_dir=cache_dir, xml_path=xml_path,
                             device=device)
    if kind == "standin":
        return load_dict(standin_dict(res=res, spp=spp, tri_budget=tri_budget), device=device)
    raise ValueError(f"scene {kind!r}: 'standin' or 'flagship'")
