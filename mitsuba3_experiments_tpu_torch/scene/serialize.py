"""Scene -> dict round trip (counterpart of
``mitsuba3_experiments_tpu.scene.serialize``): a compiled Scene's tables
serialize into "mesh"-typed entries (plus material, emitter and camera
settings) that build.load_dict compiles back into an equivalent scene.
"""
from __future__ import annotations

import numpy as np

from .types import BSDFKind, Scene


def _np(x):
    return x.detach().cpu().numpy()


def scene_to_dict(scene: Scene, meta: dict | None = None) -> dict:
    """Serialize a compiled scene into a loadable dict (one mesh per
    (material, emitter) bucket so bindings survive the round trip)."""
    g = scene.geometry
    v = _np(g.vertices)
    f = _np(g.faces)
    nrm = _np(g.normals)
    uv = _np(g.uvs)
    fm = _np(g.face_mat)
    fe = _np(g.face_emitter)
    flat = _np(g.face_flat)

    cam = scene.camera
    w, h = cam.resolution
    tan = _np(cam.tan_half_fov)
    fov = float(np.rad2deg(2.0 * np.arctan(tan[0])))
    out: dict = {
        "type": "scene",
        "sensor": {
            "type": "perspective",
            "fov": fov,
            "fov_axis": "x",
            "to_world": _np(cam.to_world),
            "film": {"width": w, "height": h},
        },
    }

    mats = scene.materials
    kinds = _np(mats.kind)
    base = _np(mats.base_color)
    params = _np(mats.params)
    twosided = _np(mats.twosided)
    rad = _np(scene.emitters.radiance)

    def mat_dict(mid: int) -> dict:
        k = kinds[mid]
        bc = base[mid].tolist()
        p = params[mid]
        if k == BSDFKind.DIFFUSE:
            d = {"type": "diffuse", "reflectance": bc}
        elif k == BSDFKind.CONDUCTOR:
            d = {"type": "conductor", "eta": p[0:3].tolist(), "k": p[3:6].tolist(),
                 "specular_reflectance": bc}
        elif k == BSDFKind.ROUGH_CONDUCTOR:
            d = {"type": "roughconductor", "eta": p[0:3].tolist(),
                 "k": p[3:6].tolist(), "alpha": float(p[6]),
                 "specular_reflectance": bc}
        elif k == BSDFKind.DIELECTRIC:
            d = {"type": "dielectric", "int_ior": float(p[0]), "ext_ior": 1.0,
                 "specular_reflectance": bc}
        elif k == BSDFKind.ROUGH_DIELECTRIC:
            d = {"type": "roughdielectric", "int_ior": float(p[0]),
                 "ext_ior": 1.0, "alpha": float(p[6])}
        elif k == BSDFKind.PLASTIC:
            d = {"type": "plastic", "int_ior": float(p[0]), "ext_ior": 1.0,
                 "diffuse_reflectance": bc}
        elif k == BSDFKind.ROUGH_PLASTIC:
            d = {"type": "roughplastic", "int_ior": float(p[0]), "ext_ior": 1.0,
                 "alpha": float(p[6]), "diffuse_reflectance": bc}
        elif k == BSDFKind.NULL:
            d = {"type": "null"}
        else:  # MASK
            nested = int(_np(mats.nested_id)[mid])
            d = {"type": "mask", "opacity": bc, "bsdf": mat_dict(nested)}
        if twosided[mid] and d["type"] not in (
            "dielectric", "roughdielectric", "null"
        ):
            d = {"type": "twosided", "bsdf": d}
        return d

    # one mesh per (mat, emitter) bucket
    for mid in np.unique(fm):
        for eid in np.unique(fe[fm == mid]):
            sel = (fm == mid) & (fe == eid)
            faces = f[sel]
            used = np.unique(faces)
            remap = np.full(v.shape[0], -1, np.int64)
            remap[used] = np.arange(len(used))
            entry = {
                "type": "mesh",
                "vertices": v[used],
                "faces": remap[faces].astype(np.int32),
                "uvs": uv[used],
                "bsdf": mat_dict(int(mid)),
            }
            if not flat[sel].all():
                entry["normals"] = nrm[used]
            if eid >= 0:
                entry["emitter"] = {
                    "type": "area", "radiance": rad[int(eid)].tolist()
                }
            out[f"mesh_{mid}_{eid}"] = entry
    return out
