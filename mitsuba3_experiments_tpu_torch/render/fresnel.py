"""Fresnel terms, dielectric and conductor (counterpart of
``mitsuba3_experiments_tpu.render.fresnel``), branch-free."""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..utils.profile import span


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance at a dielectric interface.

    cos_theta_i: signed cosine (positive = outside).  eta: int/ext ratio > 0.
    Returns (F, cos_theta_t, eta_it, eta_ti) like mi.fresnel().
    """
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)    # ratio for transmission
    eta_ti = 1.0 / eta_it

    cti = torch.abs(cos_theta_i)
    # Snell: sin_t^2 = sin_i^2 / eta_it^2
    sin2_t = (1.0 - cti * cti) * (eta_ti * eta_ti)
    tir = sin2_t >= 1.0
    cos_t = m.safe_sqrt(1.0 - sin2_t)

    a_s = m.safe_div(cti - eta_it * cos_t, cti + eta_it * cos_t)
    a_p = m.safe_div(eta_it * cti - cos_t, eta_it * cti + cos_t)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(tir, 1.0, F)
    # the transmitted cosine is in the opposite hemisphere of the incident dir
    cos_theta_t = torch.where(tir, 0.0, -torch.sign(cos_theta_i) * cos_t)
    return F, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Conductor Fresnel (per-channel eta + k, shapes (..., 3))."""
    c = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k

    t0 = e2 - k2 - s2
    a2b2 = m.safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = m.safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = m.safe_div(t1 - t2, t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * m.safe_div(t3 - t4, t3 + t4)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta, n_quad: int = 32):
    """Cosine-averaged Fresnel reflectance F_dr(eta) = int_0^1 2 c F(c; eta) dc
    by fixed midpoint quadrature."""
    # a copy from the host that waits for the device on the card
    with span("m3t.wait"):
        c = torch.as_tensor((np.arange(n_quad) + 0.5) / n_quad, dtype=m.Float, device=eta.device)
    eta_b = eta[..., None]
    F = fresnel_dielectric(c.expand(eta_b.shape[:-1] + (n_quad,)), eta_b)[0]
    return torch.sum(2.0 * c * F, dim=-1) / n_quad
