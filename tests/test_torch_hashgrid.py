"""SPPM's hash grid (ops/hashgrid.py) against the JAX package's: the hash
of cell coordinates, build, build_expanded, cell_of and gather_neighbors.
The grid moves integers, so it must equal JAX's exactly, negative and
saturated cell coordinates included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.ops import hashgrid as jhashgrid
from mitsuba3_experiments_tpu_torch.ops import hashgrid

torch.set_num_threads(2)


def _grid_equal(t, j):
    for f in ("order", "point_cell", "cell_start", "cell_end"):
        np.testing.assert_array_equal(getattr(t, f).numpy().astype(np.int64),
                                      np.asarray(getattr(j, f)).astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(t.bbox_lo.numpy(), np.asarray(j.bbox_lo))
    assert float(t.inv_cell) == float(j.inv_cell) and t.n_cells == j.n_cells


def test_hash_cell_matches_jax_on_negative_and_far_coordinates():
    """uint32 products with wraparound, negative int32 coordinates as their
    two's complement, and float -> int32 saturating (NaN -> 0) as XLA's."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-3e3, 3e3, (4096, 3)).astype(np.float32)
    x[:64] = [1e10, -1e10, 3e9]
    x[64:96] = np.nan
    x[96:128] = [-np.inf, np.inf, -2147483648.0]
    for cells in (1 << 16, 777):
        jq = jnp.floor(jnp.asarray(x)).astype(jnp.int32)
        ref = np.asarray(jhashgrid.hash_cell(jq, cells))
        q = hashgrid._cell_coords(torch.as_tensor(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq).astype(np.int64))
        np.testing.assert_array_equal(hashgrid.hash_cell(q, cells).numpy(), ref)


@pytest.mark.parametrize("bbox", ["default", "above"])
def test_hashgrid_build_matches_jax(bbox):
    """build and gather_neighbors; with bbox_lo above some points their
    cell coordinates are negative."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    lo = None if bbox == "default" else np.float32([0.2, -0.3, 0.0])
    j = jhashgrid.HashGrid.build(jnp.asarray(pts), 0.125, 512,
                                 None if lo is None else jnp.asarray(lo))
    t = hashgrid.HashGrid.build(torch.as_tensor(pts), 0.125, 512,
                                None if lo is None else torch.as_tensor(lo))
    _grid_equal(t, j)
    q = rng.uniform(-1.2, 1.2, (700, 3)).astype(np.float32)
    np.testing.assert_array_equal(t.cell_of(torch.as_tensor(q)).numpy(),
                                  np.asarray(j.cell_of(jnp.asarray(q))))
    np.testing.assert_array_equal(t.gather_neighbors(torch.as_tensor(q), 24).numpy(),
                                  np.asarray(j.gather_neighbors(jnp.asarray(q), 24)))
    assert sorted(t.order.tolist()) == list(range(3000))


def test_hashgrid_build_expanded_matches_jax():
    """build_expanded (8 corner cells per point, duplicates parked past the
    last cell) with per-point radii and a tensor cell size, as SPPM calls
    it, some points parked far away; every point within a query's radius
    is found."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    pts[::97] = 1e10                                   # SPPM's parked invalid points
    r = rng.uniform(0.01, 0.06, 2000).astype(np.float32)
    cell = np.float32(0.12)
    j = jhashgrid.HashGrid.build_expanded(jnp.asarray(pts), jnp.asarray(r), jnp.asarray(cell), 4096)
    t = hashgrid.HashGrid.build_expanded(torch.as_tensor(pts), torch.as_tensor(r),
                                         torch.as_tensor(cell), 4096)
    _grid_equal(t, j)
    q = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    got = t.gather_neighbors(torch.as_tensor(q), 64).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.gather_neighbors(jnp.asarray(q), 64)))
    for i in range(0, 800, 7):
        d = np.linalg.norm(pts - q[i], axis=1)
        assert set(np.nonzero(d <= r)[0].tolist()) <= set(got[i][got[i] >= 0].tolist())
