"""Shared by the test_torch_bench_*.py files: bench_torch.py loaded by
path, the stand-in compiled by each package's load_dict (the JAX package's
host-library bridge pointed at the port's build of the same native/*.cpp,
so both hold the same spatial-split tables), and the JAX package's side of
bench.py's worker (bench.py:197-344) at the same settings."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba3_experiments_tpu.integrators import PathIntegrator as JPath
from mitsuba3_experiments_tpu.integrators import render_pass as jax_render_pass
from mitsuba3_experiments_tpu.integrators.pipelined import (record_full_pipelined as
                                                             jax_record_full_pipelined)
from mitsuba3_experiments_tpu.integrators.replay import replay_grads as jax_replay_grads
from mitsuba3_experiments_tpu.render import film as jfilm
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import native as jax_native
from mitsuba3_experiments_tpu.scene import params as jparams
from mitsuba3_experiments_tpu_torch.scene import load_dict, native, standin_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, SPP, TRIS = (32, 18), 2, 2_000
IMG_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4   # atol relative to max|g|: tests/test_replay.py's


def load_bench():
    spec = importlib.util.spec_from_file_location("bench_torch",
                                                  os.path.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def standin_pair():
    """(JAX scene, port scene) of standin_dict(res=(32, 18), spp=2,
    tri_budget=2_000), each compiled by its own package's load_dict."""
    d = standin_dict(res=RES, spp=SPP, tri_budget=TRIS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_find_lib", native.LIBRARY.load)
        js = jax_load_dict(d)[0]
    return js, load_dict(d, device="cpu")[0]


def cfg(depth, **kw):
    return dict(res=f"{RES[0]}x{RES[1]}", spp=SPP, depth=depth, tris=TRIS, chunk=768,
                replay="auto", **kw)


def jax_fwd_bwd(js, depth, target, seed, chunk):
    """bench.py's production fwd+bwd (sched pipelined, BENCH_REPLAY auto):
    the pipelined record, with the forward film where the sorted mode is
    active (depth >= 16), then replay_grads; gradients as numpy."""
    w, h = RES
    n_rays = w * h * SPP
    pad = ((n_rays + chunk - 1) // chunk) * chunk
    diff = {k: jparams.traverse(js)[k] for k in ("materials.base_color", "emitters.radiance")}
    kw = dict(spp=SPP, max_depth=depth, rr_depth=4)
    if depth >= 16:
        rec, film = jax_record_full_pipelined(js, seed, n_rays, pad_to=pad, return_film=True,
                                              rfilter="box", **kw)
    else:
        rec, film = jax_record_full_pipelined(js, seed, n_rays, pad_to=pad, **kw), None
    g = jax_replay_grads(js, diff, jparams.update, jnp.asarray(target), seed, rec, n_rays,
                         chunk=chunk, rfilter="box", mode="auto", film=film, **kw)
    return {k: np.asarray(v) for k, v in g.items()}


def jax_lockstep(js, depth, spp, chunk):
    """bench.py's small rung (bench.py:197-217, 246-284): the seed-1 image of
    one pass of render_pass in chunks, tent; then the gradients of the
    chunks' masked MSE (box) against it, summed over max(1, max(spp, 2) //
    2) passes at seed 1 (bench.py also adds its untimed warm-up chunk's
    gradient into the sum; the port's bench sums the timed passes only)."""
    w, h = RES
    n = w * h
    integ = JPath(max_depth=depth, rr_depth=4)
    film = jfilm.new_film(w, h)
    for off in range(0, n, chunk):
        film = jax_render_pass(js, integ, jnp.uint32(1), jnp.uint32(0), film, spp_per_pass=1,
                               rfilter="tent", chunk=chunk, lane_offset=jnp.uint32(off))
    target = jfilm.develop(film)
    integ_d = JPath(max_depth=depth, rr_depth=4, differentiable=True)
    diff = {k: jparams.traverse(js)[k] for k in ("materials.base_color", "emitters.radiance")}

    @jax.jit
    def grad_chunk(p, pass_idx, off):
        def loss(p):
            f0 = jax_render_pass(jparams.update(js, p), integ_d, jnp.uint32(1), pass_idx,
                                 jfilm.new_film(w, h), spp_per_pass=1, rfilter="box",
                                 chunk=chunk, lane_offset=off)
            img = jfilm.develop(f0)
            msk = (f0[..., 3] > 0.0)[..., None]
            return jnp.sum(jnp.where(msk, (img - target) ** 2, 0.0))

        return jax.grad(loss)(p)

    acc = None
    for i in range(max(1, max(spp, 2) // 2)):
        for off in range(0, n, chunk):
            g = grad_chunk(diff, jnp.uint32(i), jnp.uint32(off))
            acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
    return np.asarray(target), {k: np.asarray(v) for k, v in acc.items()}


def assert_grads_close(got, ref):
    for k, a in ref.items():
        b = got[k].numpy()
        assert np.abs(a).max() > 0 and np.isfinite(b).all(), k
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(a).max(),
                                   err_msg=k)
