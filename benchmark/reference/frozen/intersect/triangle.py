# Frozen copy of mitsuba3_experiments_tpu_torch/intersect/triangle.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Batched Möller–Trumbore ray/triangle intersection (counterpart of
``mitsuba3_experiments_tpu.intersect.triangle``).

The dot and cross products here round like the JAX package's on the CPU,
where XLA contracts them into fused multiply-adds: dot(a, b) =
fma(a2, b2, fma(a1, b1, a0*b0)) and cross_x = fma(a1, b2, -(a2*b1)).  The
fma is emulated with a float64 product, which is exact for float32 operands;
the CUDA traversal kernel issues the same fmaf calls, so the plain version,
the kernel and the JAX reference agree on which triangle a ray hits.
"""
from __future__ import annotations

import torch

from ..core import math as m

DET_EPS = 1e-10


def fma(a, b, c):
    """a*b + c, rounded to float32 once (up to a rare double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def dot_fma(a, b):
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def cross_fma(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return m.vec3(fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)), fma(ax, by, -(ay * bx)))


def intersect_tri(o, d, tri, t_max):
    """o, d: (N, 3); tri: (K, 3, 3) or (N, K, 3, 3); t_max: (N,)

    Returns (t, u, v, hit), each (N, K); missed entries have t = +inf.
    """
    v0 = tri[..., 0, :]
    e1 = tri[..., 1, :] - v0
    e2 = tri[..., 2, :] - v0
    o = o[:, None, :]
    d = d[:, None, :]
    pvec = cross_fma(d, e2)
    det = dot_fma(e1, pvec)
    inv_det = m.safe_div(1.0, det)
    tvec = o - v0
    u = dot_fma(tvec, pvec) * inv_det
    qvec = cross_fma(tvec, e1)
    v = dot_fma(d, qvec) * inv_det
    t = dot_fma(e2, qvec) * inv_det
    hit = (
        (torch.abs(det) > DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < t_max[:, None])
    )
    t = torch.where(hit, t, m.INF)
    return t, u, v, hit
