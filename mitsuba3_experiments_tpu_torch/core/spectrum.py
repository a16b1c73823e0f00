"""Spectrum hooks of the RGB mode, and the hero-wavelength spectral mode.

Counterpart of ``mitsuba3_experiments_tpu.core.spectrum``.  The RGB-mode
aliases (Spectrum = Color3f, identity Mueller operations) keep call sites
source-compatible with Mitsuba's API.  The spectral mode (used by
``integrators/spectral.py``) samples K hero-rotated wavelengths per lane,
upsamples RGB data to smooth spectra, weights radiance by the CIE 1931
observer fits into XYZ and converts XYZ to linear sRGB.

The module constants are numpy float64, computed at import without torch;
each function turns the ones it needs into float32 tensors on its input's
device.  They hold the values the JAX package computes (its sRGB matrix is
float32, kept here as the float64 of those float32 values), so both
packages round them to the same float32 numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import math as m

is_spectral = False
is_monochromatic = False
is_polarized = False


def spectrum(value, n=None, device=None):
    """mi.Spectrum(x) analog: broadcast a scalar or RGB to (..., 3); a
    tensor keeps its device, anything else goes to `device`."""
    if isinstance(value, torch.Tensor):
        arr = value.to(m.Float)
    else:
        arr = torch.as_tensor(np.asarray(value, np.float32), device=resolve_device(device))
    if arr.dim() == 0:
        arr = arr.expand(3)
    if n is not None and arr.dim() == 1:
        arr = arr.expand(n, 3)
    return arr


def unpolarized_spectrum(s):
    """mi.unpolarized_spectrum: identity in RGB mode."""
    return s


def to_world_mueller(value, wo, wi):
    """si.to_world_mueller: identity in unpolarized RGB mode."""
    return value


def spectrum_list_to_srgb(values, wavelengths=None, active=None):
    """mi.spectrum_list_to_srgb: RGB-mode passthrough."""
    return values


def luminance(rgb):
    return m.luminance(rgb)


# ---------------------------------------------------------------------------
# Hero-wavelength spectral mode: every per-lane quantity is an (N, K) tensor
# over K hero-rotated wavelengths.
# ---------------------------------------------------------------------------

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0

_trapezoid = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2 names it trapz

# (alpha, mu, 1/sigma left, 1/sigma right) of the multi-lobe Gaussian fits
# of the CIE 1931 2-degree observer (Wyman, Sloan, Shirley, JCGT 2013)
_LOBES_X = ((0.362, 442.0, 0.0624, 0.0374), (1.056, 599.8, 0.0264, 0.0323),
            (-0.065, 501.1, 0.0490, 0.0382))
_LOBES_Y = ((0.821, 568.8, 0.0213, 0.0247), (0.286, 530.9, 0.0613, 0.0322))
_LOBES_Z = ((1.217, 437.0, 0.0845, 0.0278), (0.681, 459.0, 0.0385, 0.0725))


def sample_wavelengths(u, k: int = 4):
    """Hero-wavelength sampling (Wilkie et al. 2014): one uniform hero
    wavelength per lane plus k-1 equal-spaced rotations, each with the
    uniform pdf 1/(LAMBDA_MAX-LAMBDA_MIN).  u: (N,) -> (lambdas (N,k),
    pdf (N,k))."""
    span = LAMBDA_MAX - LAMBDA_MIN
    hero = LAMBDA_MIN + u * span
    rot = torch.arange(k, dtype=m.Float, device=u.device) * (span / k)
    lam = LAMBDA_MIN + torch.remainder(hero[:, None] - LAMBDA_MIN + rot[None, :], span)
    pdf = torch.full_like(lam, 1.0 / span)
    return lam, pdf


def _gauss(x, alpha, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) * s
    return alpha * torch.exp(-0.5 * t * t)


def cie_xyz_fit(lam):
    """CIE 1931 2-degree standard-observer fits: lam (...,) nm -> (..., 3)
    xbar ybar zbar."""
    x, y, z = (sum(_gauss(lam, *g) for g in lobes) for lobes in (_LOBES_X, _LOBES_Y, _LOBES_Z))
    return torch.stack([x, y, z], dim=-1)


def _np_fit(lobes, lam):
    """The same fit in numpy float64 (import time)."""
    out = np.zeros_like(lam)
    for alpha, mu, s1, s2 in lobes:
        t = (lam - mu) * np.where(lam < mu, s1, s2)
        out = out + alpha * np.exp(-0.5 * t * t)
    return out


_LAM = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 4701)

# integral of ybar over the visible range (~106.9 nm): normalizes radiance
# per nm to luminance
CMF_Y_INTEGRAL = float(_trapezoid(_np_fit(_LOBES_Y, _LAM), _LAM))

# linear sRGB (D65) <- XYZ, IEC 61966-2-1: the JAX package's float32 matrix
XYZ_TO_SRGB = np.asarray(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875991, 0.041556],
     [0.055648, -0.204043, 1.057311]], np.float32,
).astype(np.float64)

# linear-sRGB coordinates of the equal-energy illuminant E under the fits,
# Y-normalized
EQUAL_ENERGY_WHITE_SRGB = XYZ_TO_SRGB @ (
    np.array([_trapezoid(_np_fit(lobes, _LAM), _LAM) for lobes in (_LOBES_X, _LOBES_Y, _LOBES_Z)])
    / _trapezoid(_np_fit(_LOBES_Y, _LAM), _LAM)
)


def _const(arr, like):
    return torch.as_tensor(arr, dtype=m.Float, device=like.device)


def upsample_rgb(rgb, lam):
    """RGB reflectance -> smooth spectrum at lam: partition-of-unity sigmoid
    bands (transitions at 490/580 nm), so gray (r=g=b=a) upsamples to the
    exact constant spectrum a.  rgb (N,3) or (3,), lam (N,K) -> (N,K)."""
    rgb = torch.as_tensor(rgb, dtype=m.Float, device=lam.device)
    if rgb.dim() == 1:
        rgb = rgb[None, :]
    sig_b = torch.sigmoid((490.0 - lam) * 0.08)        # short band
    sig_r = torch.sigmoid((lam - 580.0) * 0.08)        # long band
    w_g = 1.0 - sig_b - sig_r                          # partition of unity
    return rgb[:, 0:1] * sig_r + rgb[:, 1:2] * w_g + rgb[:, 2:3] * sig_b


def spectrum_to_xyz_weight(lam, pdf, k: int):
    """Monte-Carlo film weight: radiance at lam splats CMF(lam)/(pdf*k) into
    XYZ (the 1/k averages the hero rotations), normalized so an equal-energy
    unit spectrum has Y = 1."""
    cmf = cie_xyz_fit(lam)                              # (N, K, 3)
    return cmf / (pdf[..., None] * k * CMF_Y_INTEGRAL)


def xyz_to_srgb(xyz, white_balance: bool = True):
    """XYZ -> linear sRGB; with equal-energy white balance (a flat spectrum
    maps to gray)."""
    rgb = xyz @ _const(XYZ_TO_SRGB, xyz).T
    if white_balance:
        rgb = rgb / _const(EQUAL_ENERGY_WHITE_SRGB, xyz)
    return rgb
