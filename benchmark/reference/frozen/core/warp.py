# Frozen copy of mitsuba3_experiments_tpu_torch/core/warp.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Warps from the unit square to common domains, and their densities.

Counterpart of ``mitsuba3_experiments_tpu.core.warp``; branch-free tensor
expressions.
"""
from __future__ import annotations

import torch

from . import math as m


def square_to_uniform_sphere(u):
    """u: (..., 2) -> unit sphere (..., 3); pdf = 1/(4 pi)."""
    z = 1.0 - 2.0 * u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    ph = 2.0 * m.PI * u[..., 0]
    return m.vec3(r * torch.cos(ph), r * torch.sin(ph), z)


def square_to_uniform_sphere_pdf(v):
    return torch.full(v.shape[:-1], m.INV_FOUR_PI, dtype=v.dtype, device=v.device)


def square_to_uniform_hemisphere(u):
    """Upper (+z) hemisphere; pdf = 1/(2 pi)."""
    z = u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    ph = 2.0 * m.PI * u[..., 0]
    return m.vec3(r * torch.cos(ph), r * torch.sin(ph), z)


def square_to_uniform_hemisphere_pdf(v):
    return torch.where(v[..., 2] >= 0.0, m.INV_TWO_PI, 0.0)


def square_to_uniform_disk_concentric(u):
    """Concentric (Shirley) disk mapping."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quad_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quad_x, x, y)
    rr = torch.where(quad_x, y, x)
    ph = 0.25 * m.PI * m.safe_div(rr, r)
    ph = torch.where(quad_x, ph, 0.5 * m.PI - ph)
    ph = torch.where(is_zero, 0.0, ph)
    return m.vec2(r * torch.cos(ph), r * torch.sin(ph))


def square_to_cosine_hemisphere(u):
    """Cosine-weighted +z hemisphere; pdf = cos(theta)/pi."""
    d = square_to_uniform_disk_concentric(u)
    z = m.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return m.vec3(d[..., 0], d[..., 1], z)


def square_to_cosine_hemisphere_pdf(v):
    return torch.clamp(v[..., 2], min=0.0) * m.INV_PI


def square_to_std_normal(u):
    """Box-Muller: unit square -> 2-D standard normal."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u[..., 0], min=1e-38)))
    ph = 2.0 * m.PI * u[..., 1]
    return m.vec2(r * torch.cos(ph), r * torch.sin(ph))


def square_to_std_normal_pdf(p):
    return torch.exp(-0.5 * m.squared_norm(p)) * m.INV_TWO_PI


def square_to_uniform_triangle(u):
    """Barycentric warp; returns (b1, b2) with b0 = 1-b1-b2."""
    t = m.safe_sqrt(u[..., 0])
    return m.vec2(1.0 - t, t * u[..., 1])


def interval_to_tent(u):
    """[0,1) -> [-1,1] tent-distributed."""
    u2 = 2.0 * u - 1.0
    return torch.where(
        u2 >= 0.0, 1.0 - torch.sqrt(torch.clamp(1.0 - u2, min=0.0)),
        torch.sqrt(torch.clamp(1.0 + u2, min=0.0)) - 1.0,
    )


def square_to_ggx(u, alpha):
    """Sample the isotropic GGX normal distribution; returns the half-vector
    (..., 3) with pdf = D(m) cos(theta_m)."""
    c2 = (1.0 - u[..., 0]) / (u[..., 0] * (alpha * alpha - 1.0) + 1.0)
    cos_t = torch.sqrt(torch.clamp(c2, 0.0, 1.0))
    sin_t = m.safe_sqrt(1.0 - c2)
    ph = 2.0 * m.PI * u[..., 1]
    return m.vec3(sin_t * torch.cos(ph), sin_t * torch.sin(ph), cos_t)
