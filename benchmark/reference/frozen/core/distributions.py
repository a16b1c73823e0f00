# Frozen copy of mitsuba3_experiments_tpu_torch/core/distributions.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Discrete distributions: CDF + binary-search sampling.

Counterpart of ``mitsuba3_experiments_tpu.core.distributions``.  The CDFs
are built on the host (scene compile) by a sequential float32 cumsum in
numpy; sampling is ``torch.searchsorted`` on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from . import math as m


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class DiscreteDistribution:
    pmf: torch.Tensor    # (K,) nonnegative weights (unnormalized)
    cdf: torch.Tensor    # (K,) inclusive cumsum, cdf[-1] == total
    total: torch.Tensor  # () sum of weights

    @staticmethod
    def create(weights, device=None):
        """weights: host array-like of K nonnegative floats."""
        w = np.asarray(weights, np.float32)
        cdf = np.cumsum(w, dtype=np.float32)
        return DiscreteDistribution(
            pmf=_f32(w, device), cdf=_f32(cdf, device), total=_f32(cdf[-1], device)
        )

    def prob(self, idx):
        return self.pmf[idx] / self.total

    def sample(self, u):
        """u in [0,1) -> index, via binary search on the CDF."""
        x = u * self.total
        idx = torch.searchsorted(self.cdf, x, right=True)
        return torch.clamp(idx, 0, self.pmf.shape[0] - 1).to(torch.int32)

    def sample_reuse(self, u):
        """Sample an index and rescale u to a fresh uniform within the bin."""
        idx = self.sample(u).long()
        lo = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)], 0.0)
        hi = self.cdf[idx]
        u2 = m.safe_div(u * self.total - lo, hi - lo)
        return idx.to(torch.int32), torch.clamp(u2, 0.0, 1.0 - 1e-7)


@dataclasses.dataclass(frozen=True)
class DiscreteDistribution2D:
    """Row-major 2-D discrete distribution over an (H, W) weight image."""

    weights: torch.Tensor   # (H, W)
    row_cdf: torch.Tensor   # (H,)
    col_cdf: torch.Tensor   # (H, W)
    total: torch.Tensor     # ()

    @staticmethod
    def create(image, device=None):
        img = np.asarray(image, np.float32)
        row_sum = np.sum(img, axis=1, dtype=np.float32)
        row_cdf = np.cumsum(row_sum, dtype=np.float32)
        col_cdf = np.cumsum(img, axis=1, dtype=np.float32)
        return DiscreteDistribution2D(
            weights=_f32(img, device), row_cdf=_f32(row_cdf, device),
            col_cdf=_f32(col_cdf, device), total=_f32(row_cdf[-1], device),
        )

    def sample(self, u2):
        """u2: (..., 2) -> (x, y) integer coords + pmf value."""
        h, w = self.weights.shape
        y = torch.clamp(torch.searchsorted(self.row_cdf, u2[..., 1] * self.total, right=True),
                        0, h - 1)
        row = self.col_cdf[y]                                  # (..., W)
        x = torch.clamp(torch.sum(row <= (u2[..., 0] * row[..., -1]).unsqueeze(-1), dim=-1),
                        0, w - 1)
        pmf = self.weights.reshape(-1)[y * w + x] / self.total
        return x.to(torch.int32), y.to(torch.int32), pmf

    def sample_reuse(self, u2):
        """Sample (x, y) and rescale both uniforms to fresh uniforms within
        the chosen texel."""
        h, w = self.weights.shape
        ty = u2[..., 1] * self.total
        y = torch.clamp(torch.searchsorted(self.row_cdf, ty, right=True), 0, h - 1)
        row_lo = torch.where(y > 0, self.row_cdf[torch.clamp(y - 1, min=0)], 0.0)
        row_hi = self.row_cdf[y]
        uy = torch.clamp(m.safe_div(ty - row_lo, row_hi - row_lo), 0.0, 1.0 - 1e-7)

        row = self.col_cdf[y]                                  # (..., W)
        tx = u2[..., 0] * row[..., -1]
        x = torch.clamp(torch.sum(row <= tx.unsqueeze(-1), dim=-1), 0, w - 1)
        flat_cdf = self.col_cdf.reshape(-1)
        col_lo = torch.where(x > 0, flat_cdf[y * w + torch.clamp(x - 1, min=0)], 0.0)
        col_hi = flat_cdf[y * w + x]
        ux = torch.clamp(m.safe_div(tx - col_lo, col_hi - col_lo), 0.0, 1.0 - 1e-7)
        pmf = self.weights.reshape(-1)[y * w + x] / self.total
        return x.to(torch.int32), y.to(torch.int32), ux, uy, pmf
