"""Procedural Cornell box — analog of mi.cornell_box(), identical to
``mitsuba3_experiments_tpu.scene.cornell``.

Same layout and radiometry as Mitsuba's: a [-1,1]^3 box viewed from +z, red
left wall, green right wall, white everything else, warm area light slightly
below the ceiling, two rotated boxes.
"""
from __future__ import annotations

from ..core import math as cm


def cornell_box(res: int = 256, spp: int = 64) -> dict:
    T = cm.matmul4

    def rect(to_world, bsdf_ref, emitter=None):
        d = {"type": "rectangle", "to_world": to_world, "bsdf": {"type": "ref", "id": bsdf_ref}}
        if emitter is not None:
            d["emitter"] = emitter
        return d

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "perspective",
            "fov": 39.3077,
            "fov_axis": "smaller",
            "to_world": cm.look_at(
                origin=[0.0, 0.0, 3.90718], target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0]
            ),
            "sampler": {"type": "independent", "sample_count": spp},
            "film": {
                "type": "hdrfilm", "width": res, "height": res, "rfilter": "box",
            },
        },
        "white": {
            "type": "diffuse",
            "reflectance": [0.885809, 0.698859, 0.666422],
        },
        "green": {
            "type": "diffuse",
            "reflectance": [0.105421, 0.37798, 0.076425],
        },
        "red": {
            "type": "diffuse",
            "reflectance": [0.570068, 0.0430135, 0.0443706],
        },
        "light_bsdf": {
            "type": "diffuse",
            "reflectance": [0.0, 0.0, 0.0],
        },
        "floor": rect(
            T(cm.translate([0, -1, 0]), cm.rotate([1, 0, 0], -90)), "white"
        ),
        "ceiling": rect(
            T(cm.translate([0, 1, 0]), cm.rotate([1, 0, 0], 90)), "white"
        ),
        "back": rect(T(cm.translate([0, 0, -1])), "white"),
        "left": rect(
            T(cm.translate([-1, 0, 0]), cm.rotate([0, 1, 0], 90)), "red"
        ),
        "right": rect(
            T(cm.translate([1, 0, 0]), cm.rotate([0, 1, 0], -90)), "green"
        ),
        "light": rect(
            T(
                cm.translate([0.0, 0.99, 0.01]),
                cm.rotate([1, 0, 0], 90),
                cm.scale_mat([0.23, 0.19, 1.0]),
            ),
            "light_bsdf",
            emitter={"type": "area", "radiance": [18.387, 13.9873, 6.75357]},
        ),
        "small_box": {
            "type": "cube",
            "to_world": T(
                cm.translate([0.335, -0.7, 0.38]),
                cm.rotate([0, 1, 0], -17),
                cm.scale_mat([0.25, 0.3, 0.25]),
            ),
            "bsdf": {"type": "ref", "id": "white"},
        },
        "tall_box": {
            "type": "cube",
            "to_world": T(
                cm.translate([-0.33, -0.4, -0.28]),
                cm.rotate([0, 1, 0], 18.25),
                cm.scale_mat([0.25, 0.6, 0.25]),
            ),
            "bsdf": {"type": "ref", "id": "white"},
        },
    }
