"""Per-ray counter-based draws of the wavefront integrators, and the
wavefront render.

Counterpart of ``mitsuba3_experiments_tpu.integrators.wavefront``: `_rand`,
the draw keyed by (seed, camera-ray index, dimension) that the persistent
and pipelined renderers and the path replay share, and `render_wavefront`.

The JAX module renders with a resident, regenerating lane state built for
the TPU (``WavefrontState``, refill, coherence sort, fused rounds, cursor
polls).  Here `render_wavefront` is the port's own wavefront,
``persistent.render_persistent``: the same per-ray estimates (a ray's draws
depend only on its key), scheduled for the card.
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


def render_wavefront(scene, seed: int = 0, spp: int = 16, max_depth: int = 16,
                     rr_depth: int = 4, rfilter: str = "box"):
    """Full-frame render -> (H, W, 3) image on the scene's device, equal per
    ray to `render()` with ``PathIntegrator(max_depth, rr_depth)`` in one
    pass (camera ray i: pixel i // spp)."""
    from .persistent import render_persistent

    return render_persistent(scene, seed=seed, spp=spp, max_depth=max_depth,
                             rr_depth=rr_depth, rfilter=rfilter)
