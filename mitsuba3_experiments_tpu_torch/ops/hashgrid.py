"""Point-bucketing hash grid (SPPM's visible-point grid).

Counterpart of ``mitsuba3_experiments_tpu.ops.hashgrid``: one stable sort
by cell id buckets the points (no atomics, deterministic), and
``torch.searchsorted`` delimits each cell's span.  `order` lists point
indices sorted by cell; `cell_start[c]` / `cell_end[c]` delimit cell c's
span; queries walk a fixed-size window of it.

The hash is uint32 arithmetic with wraparound, emulated in int64 masked to
32 bits as core/rng.py does; cell coordinates are int32, negative ones taken
as their uint32 two's complement.  Float -> int32 conversion saturates (NaN
-> 0, core.math.to_int32), as XLA's does, so far-away parked points land in
the same cells in both packages.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.rng import MASK32


def _cell_coords(x):
    """floor(x) -> int32 cell coordinates (held in int64), saturating."""
    return m.to_int32(torch.floor(x))


def hash_cell(q, n_cells: int):
    """pbrt-v3 style hash of integer cell coordinates (..., 3) -> int32
    cell id in [0, n_cells)."""
    h = (((q[..., 0] & MASK32) * 73856093) & MASK32) \
        ^ (((q[..., 1] & MASK32) * 19349663) & MASK32) \
        ^ (((q[..., 2] & MASK32) * 83492791) & MASK32)
    return (h % n_cells).to(torch.int32)


def _spans(sorted_cell, n_cells: int):
    cells = torch.arange(n_cells, dtype=sorted_cell.dtype, device=sorted_cell.device)
    start = torch.searchsorted(sorted_cell, cells, side="left").to(torch.int32)
    end = torch.searchsorted(sorted_cell, cells, side="right").to(torch.int32)
    return start, end


@dataclasses.dataclass(frozen=True)
class HashGrid:
    order: torch.Tensor       # (N,) point indices sorted by cell
    point_cell: torch.Tensor  # (N,) cell id per (unsorted) point
    cell_start: torch.Tensor  # (C,) start offset into order
    cell_end: torch.Tensor    # (C,)
    bbox_lo: torch.Tensor     # (3,)
    inv_cell: torch.Tensor    # () 1/cell_size
    n_cells: int = 1

    @staticmethod
    def build(points, cell_size, n_cells: int, bbox_lo=None):
        if bbox_lo is None:
            bbox_lo = torch.amin(points, dim=0)
        inv = 1.0 / cell_size
        cell = hash_cell(_cell_coords((points - bbox_lo) * inv), n_cells)
        order = torch.argsort(cell, stable=True)
        start, end = _spans(cell[order], n_cells)
        return HashGrid(
            order=order.to(torch.int32), point_cell=cell, cell_start=start, cell_end=end,
            bbox_lo=bbox_lo, inv_cell=torch.as_tensor(inv, dtype=m.Float, device=points.device),
            n_cells=n_cells,
        )

    @staticmethod
    def build_expanded(points, radius, cell_size, n_cells: int, bbox_lo=None):
        """Insert each point into every cell its radius-ball overlaps: the 8
        corner cells of the ball's AABB, duplicates masked out so that
        queries never count a point twice.  Queries then only need the
        query point's own cell.

        Requires cell_size >= 2*max(radius): then the AABB spans at most two
        cells per axis and the 8 corners cover every overlapped cell."""
        n = points.shape[0]
        dev = points.device
        if bbox_lo is None:
            bbox_lo = torch.amin(points, dim=0) - cell_size
        inv = 1.0 / cell_size
        r = torch.as_tensor(radius, dtype=m.Float, device=dev).expand(n)[:, None]

        corners = []
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    off = torch.tensor([sx, sy, sz], dtype=m.Float, device=dev)
                    corners.append(_cell_coords((points + off * r - bbox_lo) * inv))
        qs = torch.stack(corners, dim=1)            # (N, 8, 3)
        # mask duplicate cells (keep the first occurrence)
        keep = [torch.ones((n,), dtype=torch.bool, device=dev)]
        for i in range(1, 8):
            dup = torch.zeros((n,), dtype=torch.bool, device=dev)
            for j in range(i):
                dup = dup | (torch.all(qs[:, i] == qs[:, j], dim=-1) & keep[j])
            keep.append(~dup)
        keep = torch.stack(keep, dim=1)

        cell = hash_cell(qs.reshape(-1, 3), n_cells)
        cell = torch.where(keep.reshape(-1), cell, n_cells)   # park duplicates past the end
        point_idx = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=dev), 8)
        order_e = torch.argsort(cell, stable=True)
        start, end = _spans(cell[order_e], n_cells)
        return HashGrid(
            order=point_idx[order_e],
            point_cell=hash_cell(_cell_coords((points - bbox_lo) * inv), n_cells),
            cell_start=start, cell_end=end, bbox_lo=bbox_lo,
            inv_cell=torch.as_tensor(inv, dtype=m.Float, device=dev), n_cells=n_cells,
        )

    def cell_of(self, p):
        return hash_cell(_cell_coords((p - self.bbox_lo) * self.inv_cell), self.n_cells)

    def gather_neighbors(self, p, max_per_cell: int):
        """For query points p (M, 3): indices of up to `max_per_cell` points
        in the query's cell (padded with -1)."""
        c = self.cell_of(p).long()
        start = self.cell_start[c]
        end = self.cell_end[c]
        k = torch.arange(max_per_cell, dtype=torch.int32, device=p.device)
        slots = start[:, None] + k[None, :]
        idx = self.order[torch.clamp(slots, max=self.order.shape[0] - 1).long()]
        return torch.where(slots < end[:, None], idx, -1)
