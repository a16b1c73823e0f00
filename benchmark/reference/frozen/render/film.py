# Frozen copy of mitsuba3_experiments_tpu_torch/render/film.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Film: scatter-add sample splatting with reconstruction filters, and
develop (weight division).  Counterpart of
``mitsuba3_experiments_tpu.render.film``; the block is an (H, W, 4) image
(RGB + filter weight) accumulated in place with ``index_add_``, so the order
of additions into one pixel is not fixed on the GPU."""
from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..core import math as m


def new_film(width: int, height: int, device=None):
    return torch.zeros((height, width, 4), dtype=m.Float, device=resolve_device(device))


def _accum(film, xi, yi, w, value, active):
    """Adds w * (value, 1) at integer pixels (xi, yi), in place."""
    h, wdt, _ = film.shape
    inb = (xi >= 0) & (xi < wdt) & (yi >= 0) & (yi < h) & active
    w = torch.where(inb, w, 0.0)
    flat = torch.where(inb, yi * wdt + xi, 0)
    contrib = torch.cat([value * w[:, None], w[:, None]], dim=-1)
    contrib = torch.where(inb[:, None], contrib, 0.0)
    film.view(-1, 4).index_add_(0, flat.long(), contrib)
    return film


def _accum_taps(film, taps, value, active):
    """All filter taps as one scatter-add."""
    k = len(taps)
    xi = torch.cat([t[0] for t in taps])
    yi = torch.cat([t[1] for t in taps])
    w = torch.cat([t[2] for t in taps])
    return _accum(film, xi, yi, w, value.repeat(k, 1), active.repeat(k))


def put(film, pos, value, active=None, rfilter: str = "box"):
    """Splat values at continuous film positions, in place; returns film.

    rfilter: 'box' (1 tap), 'tent' (2x2 taps, radius-1 triangle) or
    'gaussian' (sigma 0.5, radius 2: 4x4 taps, truncated)."""
    n = pos.shape[0]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=pos.device)
    if rfilter == "box":
        xi = torch.floor(pos[..., 0]).to(torch.int32)
        yi = torch.floor(pos[..., 1]).to(torch.int32)
        ones = torch.ones((n,), dtype=m.Float, device=pos.device)
        return _accum(film, xi, yi, ones, value, active)
    if rfilter == "gaussian":
        sigma = 0.5
        radius = 2.0
        alpha = -1.0 / (2.0 * sigma * sigma)
        offset = math.exp(alpha * radius * radius)
        px = pos[..., 0] - 0.5
        py = pos[..., 1] - 0.5
        x0 = torch.floor(px - radius + 1).to(torch.int32)
        y0 = torch.floor(py - radius + 1).to(torch.int32)
        taps = []
        for dx in range(4):
            for dy in range(4):
                xi = x0 + dx
                yi = y0 + dy
                ddx = xi.to(m.Float) - px
                ddy = yi.to(m.Float) - py
                wx = torch.clamp(torch.exp(alpha * ddx * ddx) - offset, min=0.0)
                wy = torch.clamp(torch.exp(alpha * ddy * ddy) - offset, min=0.0)
                taps.append((xi, yi, wx * wy))
        return _accum_taps(film, taps, value, active)
    if rfilter == "tent":
        # sample position relative to pixel centers at (i+0.5)
        px = pos[..., 0] - 0.5
        py = pos[..., 1] - 0.5
        x0 = torch.floor(px).to(torch.int32)
        y0 = torch.floor(py).to(torch.int32)
        fx = px - x0
        fy = py - y0
        taps = []
        for dx in (0, 1):
            for dy in (0, 1):
                wx = 1.0 - fx if dx == 0 else fx
                wy = 1.0 - fy if dy == 0 else fy
                taps.append((x0 + dx, y0 + dy, wx * wy))
        return _accum_taps(film, taps, value, active)
    raise ValueError(f"unknown rfilter {rfilter}")


def develop(film):
    """RGB / accumulated filter weight."""
    w = film[..., 3:4]
    return m.safe_div(film[..., :3], torch.clamp(w, min=0.0) + (w <= 0.0).to(m.Float))
