"""bench_torch.py's timed forward against the JAX package, on the CPU.

On standin_dict(res=(32, 18), spp=2, tri_budget=2_000), compiled by each
package's load_dict, the bench's `forward` (render_pipelined, tent, seed 1:
the image the bench times and then takes as its fwd+bwd target) equals the
JAX package's render_pipelined at the same settings within rtol 1e-4 /
atol 1e-5, at depth 4 and at depth 16.  The fwd+bwd is held in
test_torch_bench_depth4.py and test_torch_bench_depth16.py.
"""
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.integrators.pipelined import render_pipelined as jax_render_pipelined
from torch_bench_pair import IMG_TOL, RES, SPP, cfg, load_bench, standin_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return standin_pair()


@pytest.mark.parametrize("depth", [4, 16])
def test_bench_forward_matches_jax_render_pipelined(pair, depth):
    js, ts = pair
    bench = load_bench()
    got = bench.forward(ts, cfg(depth), 1).numpy()
    ref = np.asarray(jax_render_pipelined(js, seed=1, spp=SPP, max_depth=depth, rr_depth=4,
                                          rfilter="tent"))
    assert got.shape == (RES[1], RES[0], 3) and np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_allclose(got, ref, **IMG_TOL)
