"""The port's sharded gradients (parallel/) against the JAX package, on the
CPU.

Worlds of 4, 3 and 2 gloo ranks (tests/torch_parallel_ranks.py) run the
gradient suite once each on cornell_box(res=16), spp 2, depth 3, rr_depth 2,
against a seeded target, while this process computes the references with
the JAX package:

  * sharded_replay_grad, with a lane per ray and with fewer lanes than rays
    and chunks of replay rows, against JAX's single-device
    `replay_render_grad` (as tests/test_parallel.py does for JAX's own
    sharded replay); its loss, the masked sum of squared errors of the
    recorded forward image, against the same sum over JAX's `render` at
    the recorder's key (one pass of spp 2);
  * sharded_grad_step against JAX's `sharded_grad_step` on a 4-device mesh:
    loss and gradient.

Gradients within rtol 2e-3 / atol 2e-4 max|g|, losses within rtol 1e-4; the
gradients of every world equal the first's within the same bounds, and
every rank returns the same values.  The world of 3 splits unevenly: 512
rays give its last rank a short slice, and `sharded_grad_step`'s 256 lanes
leave its last rank short as well, so the port's gate of padded lanes is
held on the gradient entry points against JAX's 4-device references.  Last,
sharded_grad_step on the 2x2 Cornell box (4 lanes, so the last rank of
the world of 3 has none) against JAX's sharded_grad_step on a mesh of one
device.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba3_experiments_tpu.integrators import PathIntegrator as JPathIntegrator
from mitsuba3_experiments_tpu.integrators import render as jax_render
from mitsuba3_experiments_tpu.integrators.replay import replay_render_grad as jax_replay_grad
from mitsuba3_experiments_tpu.parallel import make_mesh as jax_make_mesh
from mitsuba3_experiments_tpu.parallel import sharded_grad_step as jax_grad_step
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import update as jax_update

import torch_parallel_ranks as ranks

WORLDS = (4, 3, 2)
RES, SPP, SEED = ranks.GRAD_RES, ranks.GRAD_SPP, 4


def assert_grads_close(got, ref, what):
    atol = 2e-4 * max(1e-9, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world size -> every rank's results; both worlds start at once."""
    started = {}
    for w in WORLDS:
        out = str(tmp_path_factory.mktemp(f"grads_world{w}"))
        started[w] = (ranks.start("grads", w, out), out)
    got = {}

    def results(w):
        if w not in got:
            got[w] = ranks.collect(*started[w])
        return got[w]

    yield results
    for procs, _ in started.values():
        ranks.stop(procs)


@pytest.fixture(scope="module")
def jax_refs():
    box = jax_load_dict(ranks.box_dict(RES))[0]
    target = jnp.asarray(ranks.grad_target())
    params = {"materials.base_color": box.materials.base_color,
              "emitters.radiance": box.emitters.radiance}
    n = RES * RES * SPP
    replay = jax_replay_grad(box, params, jax_update, target, SEED, 0, n, spp=SPP,
                             max_depth=ranks.DEPTH, rr_depth=ranks.RR, rfilter="box", steps=8,
                             rounds_per_launch=4)
    fwd = np.asarray(jax_render(box, JPathIntegrator(max_depth=ranks.DEPTH, rr_depth=ranks.RR),
                                seed=SEED, spp=SPP, spp_per_pass=SPP, rfilter="box"))
    loss, step = jax_grad_step(box, params, target, jnp.uint32(0), jax_make_mesh(4),
                               JPathIntegrator(max_depth=ranks.DEPTH, rr_depth=ranks.RR,
                                               differentiable=True), spp_per_pass=1)
    tiny = jax_load_dict(ranks.box_dict(ranks.TINY_RES))[0]
    tiny_loss, tiny_step = jax_grad_step(
        tiny, {"materials.base_color": tiny.materials.base_color,
               "emitters.radiance": tiny.emitters.radiance},
        jnp.asarray(ranks.grad_target(ranks.TINY_RES)), jnp.uint32(0), jax_make_mesh(1),
        JPathIntegrator(max_depth=ranks.DEPTH, rr_depth=ranks.RR, differentiable=True),
        spp_per_pass=1)
    return {
        "tiny_step": {k: np.asarray(v) for k, v in tiny_step.items()},
        "tiny_step_loss": float(tiny_loss),
        "replay": {k: np.asarray(v) for k, v in replay.items()},
        "replay_loss": float(((fwd - ranks.grad_target()) ** 2).sum()),
        "step": {k: np.asarray(v) for k, v in step.items()},
        "step_loss": float(loss),
    }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", ["replay", "replay_chunked"])
def test_sharded_replay_grad_equals_jax_replay_render_grad(worlds, jax_refs, world, variant):
    res = worlds(world)[0]
    np.testing.assert_allclose(float(res[f"{variant}_loss"]), jax_refs["replay_loss"], rtol=1e-4)
    for k in ranks.DIFF_KEYS:
        ref = jax_refs["replay"][k]
        assert np.abs(ref).max() > 0
        assert_grads_close(res[f"{variant}:{k}"], ref, k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grad_step_equals_jax(worlds, jax_refs, world):
    res = worlds(world)[0]
    np.testing.assert_allclose(float(res["step_loss"]), jax_refs["step_loss"], rtol=1e-4)
    for k in ranks.DIFF_KEYS:
        ref = jax_refs["step"][k]
        assert np.abs(ref).max() > 0
        assert_grads_close(res[f"step:{k}"], ref, k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grad_step_with_an_idle_rank_equals_jax(worlds, jax_refs, world):
    res = worlds(world)[0]
    np.testing.assert_allclose(float(res["tiny_step_loss"]), jax_refs["tiny_step_loss"],
                               rtol=1e-4)
    for k in ranks.DIFF_KEYS:
        ref = jax_refs["tiny_step"][k]
        assert np.abs(ref).max() > 0
        assert_grads_close(res[f"tiny_step:{k}"], ref, k)


def test_gradients_do_not_depend_on_the_world_size(worlds):
    a = worlds(WORLDS[0])[0]
    for w in WORLDS[1:]:
        b = worlds(w)[0]
        for name in ("replay", "replay_chunked", "step", "tiny_step"):
            for k in ranks.DIFF_KEYS:
                assert_grads_close(b[f"{name}:{k}"], a[f"{name}:{k}"], f"world {w} {name}:{k}")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_loss_and_grads(worlds, world):
    res = worlds(world)
    for other in res[1:]:
        for k, v in res[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
