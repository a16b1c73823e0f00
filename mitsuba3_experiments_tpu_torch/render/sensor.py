"""Perspective sensor: camera ray generation (counterpart of
``mitsuba3_experiments_tpu.render.sensor.sample_ray``).  Mitsuba camera
convention: local +Z = viewing direction, +Y = up, +X = left."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.records import Ray
from ..scene.types import Camera


def sample_ray(camera: Camera, pos_film) -> Ray:
    """pos_film: (N, 2) continuous pixel coordinates in [0,W)x[0,H).

    Returns world-space rays through those film positions."""
    w, h = camera.resolution
    sx = pos_film[..., 0] / w
    sy = pos_film[..., 1] / h
    # film x to the right => camera-local -x (Mitsuba's +X points left);
    # film y down => camera-local -y.
    d_cam = m.vec3(
        (1.0 - 2.0 * sx) * camera.tan_half_fov[0],
        (1.0 - 2.0 * sy) * camera.tan_half_fov[1],
        torch.ones_like(sx),
    )
    d_world = m.normalize(m.transform_vector(camera.to_world, d_cam))
    o = camera.to_world[:3, 3].expand(d_world.shape)
    return Ray.make(o, d_world)
