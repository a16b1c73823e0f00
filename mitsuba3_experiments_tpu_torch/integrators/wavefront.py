"""Per-ray counter-based draws of the wavefront integrators.

Counterpart of ``mitsuba3_experiments_tpu.integrators.wavefront`` — only
its `_rand` so far: the draw keyed by (seed, camera-ray index, dimension)
that the persistent and pipelined renderers and the path replay share.
"""
from __future__ import annotations

import torch

from ..core.rng import MASK32, pcg_hash, tea32, uint_to_float01


def _rand(seed, idx, dim, n_draw: int):
    """Uniforms with a per-lane dimension counter: draw k of lane `idx` is
    keyed by dimension `dim + k`, the same construction as
    core.rng.Sampler._draw_bits, so a ray at surface depth d draws the bits
    the lockstep sampler draws for it.  `seed`, `idx` and `dim` are Python
    ints or int64 tensors of uint32 values.  Returns (N,) for one draw,
    else (N, n_draw)."""
    seed = seed & MASK32
    idx = idx & MASK32
    outs = []
    for k in range(n_draw):
        k0, k1 = tea32(seed, dim + k)
        outs.append(uint_to_float01(pcg_hash(pcg_hash(idx ^ k0) + k1)))
    return outs[0] if n_draw == 1 else torch.stack(outs, dim=-1)
