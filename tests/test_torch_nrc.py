"""The port's neural radiance caching (integrators/nrc.py) against the JAX
package, on the CPU.

On the 16x16 Cornell box, with the JAX cache's parameters carried across
(`field_params_from_numpy`): `NRCIntegrator` images without and with the
cache equal JAX's within rtol 1e-4 / atol 1e-5; one `NRCTrainer` step's
loss equals JAX's within rtol 1e-4 and its gradients JAX's `jax.grad` of
the same loss within rtol 2e-2 / atol 1e-3 max|g| (the hash grid's
scatter-adds sum in another order).  Then the port's counterpart of
tests/test_misc.py's NRC truncation test, on the port alone; the two that
train a cache are in test_torch_nrc_cache.py and test_torch_nrc_train.py
(each file runs on one test worker, and each trains for a minute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core.rng import Sampler as JSampler
from mitsuba3_experiments_tpu.integrators import render as jax_render
from mitsuba3_experiments_tpu.integrators.nrc import NRCIntegrator as JNRC
from mitsuba3_experiments_tpu.integrators.nrc import NRCTrainer as JNRCTrainer
from mitsuba3_experiments_tpu.models import FieldConfig as JFieldConfig
from mitsuba3_experiments_tpu.models import HashGridConfig as JHashGridConfig
from mitsuba3_experiments_tpu.scene import cornell_box as jax_cornell_box
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.integrators import (
    NRCIntegrator,
    NRCTrainer,
    PathIntegrator,
    make_integrator,
    render,
)
from mitsuba3_experiments_tpu_torch.models import FieldConfig, HashGridConfig
from mitsuba3_experiments_tpu_torch.models.convert import field_params_from_numpy
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    load_dict,
    scene_from_numpy,
    scene_to_numpy,
)

torch.set_num_threads(2)

GRID = dict(n_levels=4, log2_table_size=12, base_resolution=4, finest_resolution=64)
TRAINER = dict(batch_size=256, lr=2e-3, spread_c=1e-6, max_depth=3, train_depth=8,
               train_spread_mult=1e5)


def _field_cfg():
    return FieldConfig(grid=HashGridConfig(**GRID), width=32, depth=3)


@pytest.fixture(scope="module")
def pair():
    """(JAX scene, port scene, JAX trainer, port trainer, JAX field
    parameters as numpy) on the 16x16 Cornell box."""
    js = jax_load_dict(jax_cornell_box(res=16))[0]
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    jt = JNRCTrainer(field_cfg=JFieldConfig(grid=JHashGridConfig(**GRID), width=32, depth=3),
                     **TRAINER)
    tt = NRCTrainer(field_cfg=_field_cfg(), **TRAINER)
    init, _ = jt.make_train_step(js)
    jfield, _ = init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jfield)
    return js, ts, jt, tt, tree


@pytest.mark.parametrize("cached", [False, True], ids=["truncated", "cached"])
def test_nrc_render_matches_jax(pair, cached):
    js, ts, jt, tt, tree = pair
    jcache = (jax.tree_util.tree_map(jnp.asarray, tree), jt) if cached else None
    tcache = (field_params_from_numpy(tree, device="cpu"), tt) if cached else None
    ref = np.asarray(jax_render(js, JNRC(max_depth=3, spread_c=1e-6, cache=jcache), spp=4,
                                seed=2))
    got = render(ts, NRCIntegrator(max_depth=3, spread_c=1e-6, cache=tcache), spp=4,
                 seed=2).numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_nrc_train_step_matches_jax(pair):
    js, ts, jt, tt, tree = pair
    _, jstep = jt.make_train_step(js)
    # the JAX step's own loss function, from its closure
    fn = jstep.__wrapped__
    loss_fn = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[
        "loss_fn"]
    seed = 7
    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, tree), JSampler.create(jnp.uint32(seed),
                                                                  n=tt.batch_size))
    _, step = tt.make_train_step(ts)
    field = field_params_from_numpy(tree, device="cpu")
    opt = torch.optim.Adam(field.parameters(), lr=tt.lr)
    loss = float(step(field, opt, seed))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    pairs = [(field.grid.grad, jgrad["grid"])]
    pairs += [(l[k].grad, jl[k]) for l, jl in zip(field.mlp, jgrad["mlp"]) for k in ("w", "b")]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=1e-3 * np.abs(ref).max())


def test_make_integrator_nrc():
    integ = make_integrator({"type": "nrc", "max_depth": 4})
    assert isinstance(integ, NRCIntegrator) and integ.max_depth == 4 and integ.cache is None


@pytest.fixture(scope="module")
def cornell24():
    scene = load_dict(cornell_box(res=24, spp=1), device="cpu")[0]
    with torch.no_grad():
        ref = render(scene, PathIntegrator(max_depth=8, rr_depth=9), spp=32, seed=2).numpy()
        trunc = render(scene, NRCIntegrator(max_depth=3, spread_c=1e-6), spp=32, seed=2).numpy()
    return scene, ref, trunc


def test_port_nrc_truncation_darker_than_path(cornell24):
    scene, ref, _ = cornell24
    img = render(scene, NRCIntegrator(max_depth=8), spp=32, seed=2).numpy()
    assert np.isfinite(img).all() and img.max() > 0
    # truncated segments lose energy, but the first segment carries most
    assert img.mean() <= ref.mean() * 1.05
    assert img.mean() > 0.4 * ref.mean()
