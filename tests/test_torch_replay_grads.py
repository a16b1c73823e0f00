"""The port's record+replay gradients against the JAX package, on the CPU.

On JAX's record of the 32x24 sphere / floor / light frame (spp 2, depth 4),
carried across as numpy, `replay_grads_full` and `replay_grads_sorted` (box
filter) give the gradients of JAX's within rtol 1e-3 / atol 1e-4 max|g|, the
JAX package's own tolerance (tests/test_replay.py:192-195): the two
packages sum the same terms in another order.  The port's own entry points
(`replay_render_grad`, the `replay_grads` dispatcher, the sorted mode fed
the recorder's film) agree with its full replay; the dispatcher refuses an
unknown mode.  The truncated replay is held in test_torch_replay_trunc.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.integrators import replay as jrep
from mitsuba3_experiments_tpu.scene import params as jparams
from mitsuba3_experiments_tpu_torch.integrators import (
    record_full_pipelined,
    replay_grads,
    replay_grads_full,
    replay_grads_sorted,
    replay_render_grad,
)
from mitsuba3_experiments_tpu_torch.scene import params
from test_torch_replay import DEPTH, SEED, SPP, _jax_record, _port_record, bvh, frame  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_replay_grads_on_jax_record(mode, bvh, frame):
    js, ts = bvh
    keys = ("materials.base_color", "emitters.radiance")
    jp = {k: jparams.traverse(js)[k] for k in keys}
    tp = {k: params.traverse(ts)[k] for k in keys}
    kw = dict(spp=SPP, max_depth=DEPTH, rr_depth=4, rfilter="box")
    chunk = frame.pad // 2 if mode == "full" else frame.pad // 4
    jfn = {"full": jrep.replay_grads_full, "sorted": jrep.replay_grads_sorted}[mode]
    ref = jfn(js, jp, jparams.update, jnp.asarray(frame.target), SEED, _jax_record(frame.jrec),
              frame.n, chunk=chunk, **kw)
    got = replay_grads(ts, tp, params.update, torch.as_tensor(frame.target), SEED,
                       _port_record(frame.jrec), frame.n, chunk=chunk, mode=mode, **kw)
    for k in keys:
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert np.abs(a).max() > 0 and np.isfinite(b).all(), k
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4 * np.abs(a).max(), err_msg=k)
    if mode == "sorted":
        # the same gradients from the recorder's forward film
        _, film = record_full_pipelined(ts, SEED, frame.n, pad_to=frame.pad, return_film=True,
                                        spp=SPP, max_depth=DEPTH, rr_depth=4)
        with_film = replay_grads_sorted(ts, tp, params.update, torch.as_tensor(frame.target),
                                        SEED, frame.trec, frame.n, chunk=chunk, film=film, **kw)
        plain = replay_grads_full(ts, tp, params.update, torch.as_tensor(frame.target), SEED,
                                  frame.trec, frame.n, chunk=frame.pad // 2, **kw)
        for k in keys:
            np.testing.assert_allclose(with_film[k].numpy(), plain[k].numpy(), rtol=1e-3,
                                       atol=1e-4 * float(plain[k].abs().max()), err_msg=k)


def test_replay_render_grad_and_dispatch(bvh, frame):
    _, ts = bvh
    keys = ("materials.base_color", "emitters.radiance")
    tp = {k: params.traverse(ts)[k] for k in keys}
    target = torch.as_tensor(frame.target)
    kw = dict(spp=SPP, max_depth=DEPTH, rr_depth=4, rfilter="box")
    # one chunk of the whole frame: record + replay equals full replay over
    # the recorded frame in one chunk
    g1 = replay_render_grad(ts, tp, params.update, target, SEED, 0, frame.n, **kw)
    rec = frame.trec.rows(slice(0, frame.n))
    g2 = replay_grads_full(ts, tp, params.update, target, SEED, rec, frame.n, chunk=frame.n, **kw)
    for k in keys:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-6, atol=1e-9)
        assert float(g1[k].abs().max()) > 0
    auto = replay_grads(ts, tp, params.update, target, SEED, rec, frame.n, chunk=frame.n, **kw)
    for k in keys:
        assert torch.equal(auto[k], g2[k])
    with pytest.raises(ValueError):
        replay_grads(ts, tp, params.update, target, SEED, rec, frame.n, chunk=frame.n,
                     mode="no_such_mode", **kw)
    with pytest.raises(ValueError):
        replay_grads_full(ts, tp, params.update, target, SEED, rec, frame.n, chunk=1000, **kw)
