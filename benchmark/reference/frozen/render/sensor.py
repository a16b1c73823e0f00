# Frozen copy of mitsuba3_experiments_tpu_torch/render/sensor.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Perspective sensor: camera ray generation and world -> film projection
(counterpart of ``mitsuba3_experiments_tpu.render.sensor``).  Mitsuba
camera convention: local +Z = viewing direction, +Y = up, +X = left."""
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


def perspective_projection(camera: Camera, near: float = 0.01, far: float = 1000.0):
    """World -> clip-space 4x4 matrix (mi.perspective_projection analog):
    maps world points to NDC where x, y in [0, 1] cover the film."""
    dev = camera.to_world.device
    tx, ty = camera.tan_half_fov[0], camera.tan_half_fov[1]
    # camera space -> NDC: x_ndc = 0.5 (1 - x/(z tx)), the same for y
    proj = torch.tensor(
        [
            [-0.5, 0.0, 0.5, 0.0],
            [0.0, -0.5, 0.5, 0.0],
            [0.0, 0.0, far / (far - near), -near * far / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=m.Float, device=dev,
    )
    one = torch.ones((), dtype=m.Float, device=dev)
    scale = torch.diag(torch.stack([1.0 / tx, 1.0 / ty, one, one]).to(m.Float))
    world_to_cam = torch.linalg.inv(camera.to_world)
    return proj @ scale @ world_to_cam


def sample_direction(camera: Camera, p_world):
    """Project world points onto the film.

    Returns (pos_film (N,2), dist (N,), valid (N,)): the reprojection of
    ReSTIR's temporal reuse and the particle tracer's camera splats."""
    tw = camera.to_world
    R = tw[:3, :3]
    t = tw[:3, 3]
    p_cam = (p_world - t) @ R  # R^T p  (R orthonormal)
    z = p_cam[..., 2]
    valid = z > 1e-6
    x = m.safe_div(p_cam[..., 0], z)
    y = m.safe_div(p_cam[..., 1], z)
    w, h = camera.resolution
    sx = 0.5 * (1.0 - x / camera.tan_half_fov[0])
    sy = 0.5 * (1.0 - y / camera.tan_half_fov[1])
    pos = torch.stack([sx * w, sy * h], dim=-1)
    valid = valid & (sx >= 0.0) & (sx < 1.0) & (sy >= 0.0) & (sy < 1.0)
    dist = m.norm(p_world - t)
    return pos, dist, valid
