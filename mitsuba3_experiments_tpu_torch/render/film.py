"""Film: scatter-add sample splatting with reconstruction filters, and
develop (weight division).  Counterpart of
``mitsuba3_experiments_tpu.render.film``; the block is an (H, W, 4) image
(RGB + filter weight) accumulated in place with ``index_add_``, so the order
of additions into one pixel is not fixed on the GPU."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import math as m


def new_film(width: int, height: int, device=None):
    return torch.zeros((height, width, 4), dtype=m.Float, device=resolve_device(device))


class Taps(NamedTuple):
    """The filter taps of n samples on an (H, W) film, tap by tap (k n
    entries each): flat pixel index (int64), weight and whether the tap
    lies on the film and its sample is active (off it the pixel and weight
    are 0)."""

    flat: torch.Tensor
    w: torch.Tensor
    inb: torch.Tensor
    k: int


def _tap_coords(pos, rfilter: str):
    """(xi, yi, w), each (k n,): the k filter taps of each of n film
    positions, tap by tap.  rfilter: 'box' (1 tap), 'tent' (2x2 taps,
    radius-1 triangle) or 'gaussian' (sigma 0.5, radius 2: 4x4 taps,
    truncated)."""
    if rfilter == "box":
        xi = torch.floor(pos[..., 0]).to(torch.int32)
        yi = torch.floor(pos[..., 1]).to(torch.int32)
        return xi, yi, torch.ones((pos.shape[0],), dtype=m.Float, device=pos.device)
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
    elif rfilter == "tent":
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
    else:
        raise ValueError(f"unknown rfilter {rfilter}")
    return tuple(torch.cat([t[j] for t in taps]) for j in range(3))


def _repeat(x, k: int):
    return x if k == 1 else x.repeat((k,) + (1,) * (x.dim() - 1))


def taps(pos, active, rfilter: str, height: int, width: int) -> Taps:
    """The filter taps of samples at continuous film positions `pos` (n, 2)
    on a film of `height` x `width`; `active` (n,) bool, or None for all."""
    n = pos.shape[0]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=pos.device)
    xi, yi, w = _tap_coords(pos, rfilter)
    k = xi.shape[0] // max(n, 1)
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height) & _repeat(active, k)
    w = torch.where(inb, w, 0.0)
    flat = torch.where(inb, yi * width + xi, 0)
    return Taps(flat.long(), w, inb, k)


def put_taps(film, t: Taps, value):
    """Adds each tap's weight times (value, 1) at its pixel, in place (all
    taps as one scatter-add); returns film."""
    w = t.w[:, None]
    contrib = torch.cat([_repeat(value, t.k) * w, w], dim=-1)
    contrib = torch.where(t.inb[:, None], contrib, 0.0)
    film.view(-1, 4).index_add_(0, t.flat, contrib)
    return film


def gather_taps(adj, t: Taps):
    """The transpose of `put_taps` in its values: (n, C), for an (H, W, C)
    film adjoint `adj`, the derivative of sum(adj * put_taps(film, t,
    value)[..., :C]) with respect to `value` — per sample, the sum over its
    taps of the tap's weight times `adj` at the tap's pixel, 0 for taps off
    the film and for inactive samples.  A gather: no autograd, no host
    wait."""
    c = adj.shape[-1]
    g = torch.where(t.inb[:, None], adj.reshape(-1, c).index_select(0, t.flat), 0.0)
    g = g * t.w[:, None]
    return g if t.k == 1 else g.view(t.k, -1, c).sum(0)


def put(film, pos, value, active=None, rfilter: str = "box"):
    """Splat values at continuous film positions, in place; returns film.

    rfilter: 'box' (1 tap), 'tent' (2x2 taps, radius-1 triangle) or
    'gaussian' (sigma 0.5, radius 2: 4x4 taps, truncated)."""
    return put_taps(film, taps(pos, active, rfilter, film.shape[0], film.shape[1]), value)


def put_adjoint(adj, pos, active=None, rfilter: str = "box"):
    """`gather_taps` of the samples at `pos`: the derivative of sum(adj *
    put(film, pos, value, active, rfilter)[..., :C]) with respect to
    `value`."""
    return gather_taps(adj, taps(pos, active, rfilter, adj.shape[0], adj.shape[1]))


def develop(film):
    """RGB / accumulated filter weight."""
    w = film[..., 3:4]
    return m.safe_div(film[..., :3], torch.clamp(w, min=0.0) + (w <= 0.0).to(m.Float))
