# Frozen copy of mitsuba3_experiments_tpu_torch/render/microfacet.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""GGX (Trowbridge-Reitz) microfacet distribution with Smith shadowing
(counterpart of ``mitsuba3_experiments_tpu.render.microfacet``)."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core import warp


def ggx_d(mh, alpha):
    """Normal distribution D(m), mh the local half-vector (..., 3)."""
    c2 = m.cos2_theta(mh)
    t = c2 * (alpha * alpha - 1.0) + 1.0
    d = m.safe_div(alpha * alpha, m.PI * t * t)
    return torch.where(mh[..., 2] > 0.0, d, 0.0)


def ggx_lambda(v, alpha):
    t2 = m.tan2_theta(v)
    t2 = torch.where(torch.isfinite(t2), t2, 0.0)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * t2))


def smith_g1(v, mh, alpha):
    g = 1.0 / (1.0 + ggx_lambda(v, alpha))
    # masking: v must be on the same side as the micronormal
    return torch.where(m.dot(v, mh) * v[..., 2] > 0.0, g, 0.0)


def smith_g(wi, wo, mh, alpha):
    return smith_g1(wi, mh, alpha) * smith_g1(wo, mh, alpha)


def sample_ggx(u2, alpha):
    """Sample m ~ D(m) cos(theta_m); returns (m, pdf)."""
    mh = warp.square_to_ggx(u2, alpha)
    return mh, ggx_d(mh, alpha) * m.cos_theta(mh)


def pdf_ggx(mh, alpha):
    return ggx_d(mh, alpha) * torch.clamp(m.cos_theta(mh), min=0.0)
