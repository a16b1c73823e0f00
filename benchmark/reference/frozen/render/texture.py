# Frozen copy of mitsuba3_experiments_tpu_torch/render/texture.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Bitmap texture fetch with bilinear filtering (counterpart of
``mitsuba3_experiments_tpu.render.texture``)."""
from __future__ import annotations

import torch

from ..core import math as m
from ..scene.types import TextureAtlas


def eval_texture(atlas: TextureAtlas, tex_id, uv):
    """Bilinear fetch; tex_id (N,) (-1 lanes get 1.0), uv (N, 2) with repeat
    wrap.  The v axis follows the image convention (v=0 -> last row)."""
    tid = torch.clamp(tex_id, min=0).long()
    size = atlas.size[tid]                              # (N, 2) = (h, w)
    h = size[:, 0].to(m.Float)
    w = size[:, 1].to(m.Float)

    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    flat_data = atlas.data.reshape(-1, 3)
    hmax, wmax = atlas.data.shape[1], atlas.data.shape[2]

    def fetch(xi, yi):
        # floor-mod, like jnp.mod
        xi = torch.remainder(xi.to(torch.int32), size[:, 1])
        yi = torch.remainder(yi.to(torch.int32), size[:, 0])
        # index_select: its backward is an index_add_ (see bsdf/dispatch.py)
        return flat_data.index_select(0, ((tid * hmax + yi) * wmax + xi).long())

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where((tex_id >= 0)[:, None], out, 1.0)
