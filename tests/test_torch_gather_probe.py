"""The dependent row-gather probe (ops/gather_probe.py) against the JAX
package's probe script, on the CPU.

`dep_chain` on CPU tensors runs the plain chain, which must give the final
indices of `xla_dep` (scripts/pallas_gather_probe.py) exactly and its
accumulators within rtol 1e-6, on a seeded 4,096 x 88 table, 1,024 lanes
and 16 steps.  The script is loaded by path (it is not a package module);
it sets two `jax.config` values at import, which are restored so that
nothing else in the process writes a compilation cache.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, LANES, ITERS = 4096, 1024, 16
_CONFIG = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def probe():
    saved = {k: getattr(jax.config, k) for k in _CONFIG}
    try:
        spec = importlib.util.spec_from_file_location(
            "pallas_gather_probe", os.path.join(REPO, "scripts", "pallas_gather_probe.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def case():
    table = gather_probe.build_table(5, rows=ROWS)
    idx0 = np.random.default_rng(6).integers(0, ROWS, LANES).astype(np.int32)
    return table, idx0


def test_probe_import_leaves_jax_config(probe):
    assert probe.ROW == gather_probe.ROW_FLOATS and probe.R == gather_probe.TABLE_ROWS
    assert jax.config.jax_compilation_cache_dir is None


def test_build_table(case):
    table, _ = case
    assert table.shape == (ROWS, 88) and table.dtype == np.float32
    col0 = table[:, 0]
    assert (col0 == np.floor(col0)).all() and col0.min() >= 0 and col0.max() < ROWS
    assert (table[:, 1:] >= 0).all() and (table[:, 1:] < 1).all()
    np.testing.assert_array_equal(gather_probe.build_table(5, rows=ROWS), table)
    with pytest.raises(ValueError):
        gather_probe.build_table(0, rows=1 << 24)


def test_dep_chain_matches_xla_dep(probe, case):
    table, idx0 = case
    ref_idx, ref_acc = probe.xla_dep(jnp.asarray(table), jnp.asarray(idx0), iters=ITERS)
    calls = gather_probe.plain_calls
    idx, acc = gather_probe.dep_chain(torch.as_tensor(table), torch.as_tensor(idx0), ITERS)
    assert gather_probe.plain_calls == calls + 1
    assert idx.dtype == torch.int32 and acc.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), rtol=1e-6)
    # the chain really walked: the final rows are those of a numpy walk
    walk = idx0.copy()
    for _ in range(ITERS):
        walk = table[walk, 0].astype(np.int32)
    np.testing.assert_array_equal(idx.numpy(), walk)


def test_ind_gather_matches_xla_ind(probe, case):
    table, _ = case
    idxs = np.random.default_rng(7).integers(0, ROWS, (ITERS, LANES)).astype(np.int32)
    ref = probe.xla_ind(jnp.asarray(table), jnp.asarray(idxs), iters=ITERS)
    got = gather_probe.ind_gather_plain(torch.as_tensor(table), torch.as_tensor(idxs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_chain_bytes_counts_distinct_rows(case):
    table, idx0 = case
    walk, seen = idx0.astype(np.int64), set()
    for _ in range(ITERS):
        seen.update(walk.tolist())
        walk = table[walk, 0].astype(np.int64)
    distinct, nbytes = gather_probe.chain_bytes(torch.as_tensor(table), torch.as_tensor(idx0),
                                                ITERS)
    assert distinct == len(seen)
    assert nbytes == len(seen) * 88 * 4 + LANES * 12


def test_dispatch_takes_no_other_device(case):
    table, idx0 = case
    launches = gather_probe_cuda.launches
    with pytest.raises(ValueError):
        gather_probe.dep_chain(torch.as_tensor(table).to("meta"), torch.as_tensor(idx0).to("meta"),
                               ITERS)
    with pytest.raises(ValueError):   # the kernel's wrapper takes only CUDA tensors
        gather_probe_cuda.dep_chain_cuda(torch.as_tensor(table), torch.as_tensor(idx0), ITERS)
    assert gather_probe_cuda.launches == launches and gather_probe_cuda.LIBRARY.handle is None
