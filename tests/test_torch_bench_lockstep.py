"""bench_torch.py's small lockstep rung against the JAX package, on the CPU.

On standin_dict(res=(32, 18), spp=2, tri_budget=2_000), compiled by each
package's load_dict, at depth 4, spp 4 (two gradient passes) and chunks of
256 lanes (the last one partly past the 576 pixels): the bench's
`lockstep_forward` (one pass of render_pass, tent, seed 1) equals bench.py's
lockstep forward through the JAX package within rtol 1e-4 / atol 1e-5, and
`lockstep_grads` (the masked MSE of each chunk, box, against that image,
through PathIntegrator(differentiable=True), summed over the passes' chunks)
equals `jax.grad` of the same losses within rtol 1e-3 / atol 1e-4 max|g|.
"""
import numpy as np
import torch

from torch_bench_pair import (IMG_TOL, assert_grads_close, cfg, jax_lockstep, load_bench,
                              standin_pair)

torch.set_num_threads(2)

DEPTH, SPP, CHUNK = 4, 4, 256


def test_bench_lockstep_rung_matches_jax():
    js, ts = standin_pair()
    bench = load_bench()
    c = cfg(DEPTH, mode="lockstep")
    c.update(spp=SPP, chunk=CHUNK)
    assert bench.lockstep_passes(c) == 2
    img = bench.lockstep_forward(ts, c, 1)
    got = bench.lockstep_grads(ts, c, img, 1)
    ref_img, ref = jax_lockstep(js, DEPTH, SPP, CHUNK)
    assert np.isfinite(img.numpy()).all() and float(img.mean()) > 0
    np.testing.assert_allclose(img.numpy(), ref_img, **IMG_TOL)
    assert_grads_close(got, ref)
