"""Multiresolution hash-grid feature encoding (instant-NGP).

Counterpart of ``mitsuba3_experiments_tpu.models.hashgrid_enc``: per level,
the 8 hashed corners of the point's cell are gathered from an (L, T, F)
table and blended trilinearly.  The table's gradient is autograd's
transpose of the gather (an index_add, in float32).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.rng import MASK32

_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 8
    n_features: int = 2
    log2_table_size: int = 15
    base_resolution: int = 16
    finest_resolution: int = 512

    @property
    def out_dim(self):
        return self.n_levels * self.n_features

    def level_resolutions(self):
        if self.n_levels == 1:
            return [self.base_resolution]
        b = math.exp(
            (math.log(self.finest_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )
        return [
            int(math.floor(self.base_resolution * (b**l)))
            for l in range(self.n_levels)
        ]


def init_hashgrid(generator: torch.Generator, cfg: HashGridConfig, device=None):
    """(L, T, F) float32 table, U(-1e-4, 1e-4) like instant-NGP."""
    t = 1 << cfg.log2_table_size
    u = torch.rand((cfg.n_levels, t, cfg.n_features), generator=generator,
                   dtype=torch.float32, device=generator.device)
    return (u * 2e-4 - 1e-4).to(device)


def _hash(q, table_size: int):
    """uint32 spatial hash of (..., 3) integer corners, in int64 masked to
    32 bits (the low 32 bits of a wrapped product depend only on the low
    32 bits of its operands)."""
    q = q.to(torch.int64) & MASK32
    h = (
        ((q[..., 0] * _PRIMES[0]) & MASK32)
        ^ ((q[..., 1] * _PRIMES[1]) & MASK32)
        ^ ((q[..., 2] * _PRIMES[2]) & MASK32)
    )
    return h & (table_size - 1)


def hashgrid_encode(table, p, cfg: HashGridConfig):
    """p: (N, 3) in [0,1]^3 -> (N, L*F) features, trilinear per level."""
    t = 1 << cfg.log2_table_size
    outs = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        x = p * res
        x0 = torch.floor(x)
        f = x - x0
        x0 = x0.to(torch.int32)
        feat = None
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    corner = x0 + torch.tensor([cx, cy, cz], dtype=torch.int32, device=p.device)
                    idx = _hash(corner, t)
                    w = (
                        (f[..., 0] if cx else 1 - f[..., 0])
                        * (f[..., 1] if cy else 1 - f[..., 1])
                        * (f[..., 2] if cz else 1 - f[..., 2])
                    )
                    term = w[..., None] * table[lvl][idx]
                    feat = term if feat is None else feat + term
        outs.append(feat)
    return torch.cat(outs, dim=-1)
