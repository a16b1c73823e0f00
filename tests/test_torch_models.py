"""The port's neural-radiosity slice against the JAX package, on the CPU.

Inputs are made from seeded numpy and handed to both packages; the field's
parameters are carried across with models.convert.  Tolerances, each with
its reason:

  * sh_eval, trepeat, wi_world, hashgrid_encode: the same float32
    expressions; sh/wi_world/encoding allclose at rtol 1e-5 / atol 1e-6,
    trepeat equal; the table gradient (a scatter-add in another order) at
    rtol 1e-5 / atol 1e-9.
  * MLP values: JAX and torch sum the float32 products in other orders, so
    a hidden activation may round to the neighbouring bf16 value (a
    relative 2^-8): values at rtol 2e-2 / atol 2e-2 (the bound
    tests/test_models.py holds the TPU kernel to), and, for most lanes,
    much tighter (stated in each test).  Gradients pass the cotangent
    through the same bf16 casts: rtol 2e-2, atol 1e-3 of the largest
    gradient of the tensor.
  * The nerad step: loss at rtol 1e-3; every gradient as for the MLP;
    parameters after one Adam step at atol 2e-3 * lr (Adam's first step
    moves each parameter by ~lr * sign(g), so a flipped sign on a
    near-zero gradient moves it by up to 2 lr: such parameters are
    counted and bounded to 1%).
  * NeradIntegrator per lane: L at rtol 1e-3 / atol 1e-4 on >= 99% of
    lanes, and valid equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mitsuba3_experiments_tpu.core import struct as jstruct
from mitsuba3_experiments_tpu.core.records import SurfaceInteraction as JSI
from mitsuba3_experiments_tpu.core.rng import Sampler as JSampler
from mitsuba3_experiments_tpu.core.sh import sh_eval as j_sh_eval
from mitsuba3_experiments_tpu.models import hashgrid_enc as jhg
from mitsuba3_experiments_tpu.models import mlp as jmlp
from mitsuba3_experiments_tpu.models import nerad as jnerad
from mitsuba3_experiments_tpu.models import pallas_mlp as jpallas
from mitsuba3_experiments_tpu.render import sensor as jsensor
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core.records import SurfaceInteraction, trepeat
from mitsuba3_experiments_tpu_torch.core.rng import Sampler
from mitsuba3_experiments_tpu_torch.core.sh import sh_eval
from mitsuba3_experiments_tpu_torch.integrators import make_integrator, render
from mitsuba3_experiments_tpu_torch.models import (
    FieldConfig,
    HashGridConfig,
    NeradIntegrator,
    NeradTrainer,
    apply_mlp,
    field_eval,
    fused_mlp,
    hashgrid_encode,
    identity_init_mlp,
    init_field,
    mlp,
)
from mitsuba3_experiments_tpu_torch.models.convert import (
    field_params_from_numpy,
    field_params_to_numpy,
)
from mitsuba3_experiments_tpu_torch.render import sensor
from mitsuba3_experiments_tpu_torch.scene import cornell_box, scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)

SMALL_GRID = HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                            finest_resolution=64)
J_SMALL_GRID = jhg.HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                  finest_resolution=64)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mlp_pair(sizes, seed):
    params = jmlp.init_mlp(jax.random.PRNGKey(seed), list(sizes))
    tparams = [{"w": torch.as_tensor(np.array(l["w"])), "b": torch.as_tensor(np.array(l["b"]))}
               for l in params]
    return params, tparams


def _grad_close(got, ref, rtol=2e-2, rel_atol=1e-3):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rel_atol * float(np.abs(ref).max()))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_sh_eval(order):
    d = _unit(np.random.default_rng(1), 500)
    ref = np.asarray(j_sh_eval(jnp.asarray(d), order))
    got = sh_eval(torch.as_tensor(d), order).numpy()
    assert got.shape == ref.shape == (500, (order + 1) ** 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _si_arrays(n, seed):
    rng = np.random.default_rng(seed)
    n3 = _unit(rng, n)
    s = _unit(rng, n)
    s = s - (s * n3).sum(-1, keepdims=True) * n3
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    t = np.cross(n3, s).astype(np.float32)
    return dict(t=rng.uniform(0.1, 5, n).astype(np.float32),
                p=rng.normal(size=(n, 3)).astype(np.float32), n=n3, sh_n=n3, sh_s=s, sh_t=t,
                uv=rng.random((n, 2), dtype=np.float32), wi=_unit(rng, n),
                prim_idx=np.arange(n, dtype=np.int32), mat_id=rng.integers(0, 4, n).astype(np.int32),
                emitter_id=rng.integers(-1, 2, n).astype(np.int32))


def test_trepeat_and_wi_world():
    a = _si_arrays(37, 2)
    jsi = JSI(**{k: jnp.asarray(v) for k, v in a.items()})
    tsi = SurfaceInteraction(**{k: torch.as_tensor(v) for k, v in a.items()})
    np.testing.assert_allclose(tsi.wi_world.numpy(), np.asarray(jsi.wi_world), rtol=1e-5, atol=1e-6)
    jr = jstruct.trepeat(jsi, 5)
    tr = trepeat(tsi, 5)
    for f in dataclasses.fields(tr):
        np.testing.assert_array_equal(getattr(tr, f.name).numpy(), np.asarray(getattr(jr, f.name)))
    # [a a b b ...]: rows [k*5, (k+1)*5) repeat record k
    assert torch.equal(tr.prim_idx[:10], torch.tensor([0] * 5 + [1] * 5, dtype=torch.int32))


@pytest.mark.parametrize("cfg_name", ["default", "small"])
def test_hashgrid_encode_and_table_grad(cfg_name):
    jcfg = jhg.HashGridConfig() if cfg_name == "default" else J_SMALL_GRID
    tcfg = HashGridConfig() if cfg_name == "default" else SMALL_GRID
    rng = np.random.default_rng(3)
    table = rng.uniform(-1e-2, 1e-2, (jcfg.n_levels, 1 << jcfg.log2_table_size,
                                      jcfg.n_features)).astype(np.float32)
    p = rng.random((400, 3), dtype=np.float32)
    p[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0], [1e-7, 0.999999, 0.25]]
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(p), jcfg))
    tt = torch.as_tensor(table).requires_grad_(True)
    got = hashgrid_encode(tt, torch.as_tensor(p), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    jg = jax.grad(lambda t: jnp.sum(jhg.hashgrid_encode(t, jnp.asarray(p), jcfg) ** 2))(
        jnp.asarray(table))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)
    assert float(tt.grad.abs().max()) > 0


def test_apply_mlp():
    sizes = (32, 64, 64, 64, 3)
    jp, tp = _mlp_pair(sizes, 4)
    x = np.random.default_rng(5).normal(size=(1000, 32)).astype(np.float32)
    ref = np.asarray(jmlp.apply_mlp(jp, jnp.asarray(x)))
    calls = mlp.calls
    got = apply_mlp(tp, torch.as_tensor(x)).numpy()
    assert mlp.calls == calls + 1 and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    # most lanes see no bf16 rounding flip at all
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-5).all(axis=1).mean()
    assert close >= 0.9, close


def test_init_shapes_and_identity():
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        field = init_field(g, FieldConfig())
    assert tuple(field.grid.shape) == (8, 1 << 15, 2)
    assert [tuple(l["w"].shape) for l in field.mlp] == [(32, 64), (64, 64), (64, 64), (64, 3)]
    assert float(field.grid.detach().abs().max()) <= 1e-4
    w0 = field.mlp[0]["w"].detach()
    assert abs(float(w0.std()) - (2.0 / 32) ** 0.5) < 0.03
    ident = identity_init_mlp(torch.Generator().manual_seed(1), [8, 8, 4])
    assert float((ident[0]["w"] - torch.eye(8)).abs().max()) < 0.1
    again = init_field(torch.Generator().manual_seed(0), FieldConfig())
    assert torch.equal(again.grid, field.grid)
    tree = field_params_to_numpy(field)
    back = field_params_from_numpy(tree)
    for a, b in zip(back.parameters(), field.parameters()):
        assert torch.equal(a, b)


def test_fused_apply_mlp_value_and_grad_match_jax():
    """K2's CPU path and its recomputing backward against JAX's
    fused_apply_mlp (Pallas in interpret mode), as tests/test_models.py
    runs it."""
    sizes = [16, 64, 64, 3]
    jp, tp = _mlp_pair(sizes, 4)
    x = np.random.default_rng(6).normal(size=(257, 16)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jpallas.fused_apply_mlp(p, xx, "leaky_relu", 128, True)))

    v_ref, (g_ref, gx_ref) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [{k: t.clone().requires_grad_(True) for k, t in l.items()} for l in tp]
    xt = torch.as_tensor(x).requires_grad_(True)
    rec = fused_mlp.recomputes
    v = torch.sin(fused_mlp.fused_apply_mlp(leaves, xt, "leaky_relu", 128)).sum()
    v.backward()
    assert fused_mlp.recomputes == rec + 1
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-3)
    for lt, lj in zip(leaves, g_ref):
        _grad_close(lt["w"].grad.numpy(), lj["w"])
        _grad_close(lt["b"].grad.numpy(), lj["b"])
    _grad_close(xt.grad.numpy(), gx_ref)


def test_fused_mlp_forward_rejects_other_devices():
    sizes = (4, 8, 3)
    _, tp = _mlp_pair(sizes, 7)
    flat = fused_mlp.mlp_params_flat(tp)
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_forward(flat, torch.zeros((5, 4), device="meta"), sizes)


@pytest.mark.parametrize("fused", [False, True])
def test_field_eval(fused):
    """field_eval at FieldConfig's defaults (fused: tile 128, as
    tests/test_models.py runs the Pallas path) against JAX's."""
    jcfg = dataclasses.replace(jnerad.FieldConfig(), fused=fused, fused_tile=128)
    tcfg = dataclasses.replace(FieldConfig(), fused=fused, fused_tile=128)
    params = jnerad.init_field(jax.random.PRNGKey(6), jcfg)
    field = field_params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(7)
    p = rng.random((333, 3), dtype=np.float32)
    wi = _unit(rng, 333)
    ref = np.asarray(jnerad.field_eval(params, jcfg, jnp.asarray(p), jnp.asarray(wi)))
    calls, rec = mlp.calls, fused_mlp.recomputes
    got = field_eval(field, tcfg, torch.as_tensor(p), torch.as_tensor(wi)).detach().numpy()
    assert mlp.calls == calls + 1 and fused_mlp.recomputes == rec
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-6).all(axis=1).mean()
    assert close >= 0.9, close


# ----------------------------- the nerad slice -----------------------------

def _tiny_cfgs(fused):
    j = jnerad.FieldConfig(grid=J_SMALL_GRID, width=32, depth=3, fused=fused, fused_tile=128)
    t = FieldConfig(grid=SMALL_GRID, width=32, depth=3, fused=fused, fused_tile=128)
    return j, t


@pytest.fixture(scope="module")
def cornell_pair():
    js = jax_load_dict(cornell_box(res=16, spp=1))[0]
    return js, scene_from_numpy(scene_to_numpy(js))


BATCH, M_RHS, LR, SEED = 256, 4, 2e-3, 3


def test_make_area_dist_matches_jax(cornell_pair):
    """The surface sampler's face-area distribution: pmf equal, CDF and
    total allclose at rtol 1e-6 (jnp.cumsum sums in another order than the
    port's numpy), as tests/test_torch_scene.py holds the emitter CDFs."""
    js, ts = cornell_pair
    jd = jnerad.NeradTrainer.make_area_dist(js)
    td = NeradTrainer.make_area_dist(ts)
    np.testing.assert_array_equal(td.pmf.numpy(), np.asarray(jd.pmf))
    np.testing.assert_allclose(td.cdf.numpy(), np.asarray(jd.cdf), rtol=1e-6)
    np.testing.assert_allclose(float(td.total), float(jd.total), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_nerad_step_matches_jax(cornell_pair, fused, capsys):
    js, ts = cornell_pair
    jcfg, tcfg = _tiny_cfgs(fused)
    jtr = jnerad.NeradTrainer(field_cfg=jcfg, batch_size=BATCH, m_rhs=M_RHS, lr=LR)
    ttr = NeradTrainer(field_cfg=tcfg, batch_size=BATCH, m_rhs=M_RHS, lr=LR)

    params0 = jnerad.init_field(jax.random.PRNGKey(0), jcfg)
    # the step's loss and gradients, written out from the trainer's public
    # methods exactly as make_train_step's loss_fn composes them
    area = jtr.make_area_dist(js)
    lo, ext = jtr.scene_bounds(js)

    def jloss(params):
        sampler = JSampler.create(jnp.uint32(SEED), lane=jnp.arange(BATCH, dtype=jnp.uint32))
        si, sampler = jtr.sample_surface(js, area, sampler)
        p_norm = jnp.clip((si.p - lo) / ext, 0.0, 1.0)
        lhs = jnerad.field_eval(params, jcfg, p_norm, si.wi_world)
        rhs = jtr.sample_rhs(js, params, sampler, si, lo, ext)
        return jnp.mean((lhs - rhs) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params0)

    _, tstep = ttr.make_train_step(ts)
    field = field_params_from_numpy(jax.tree_util.tree_map(np.asarray, params0))
    opt = torch.optim.Adam(field.parameters(), lr=LR)
    tl = tstep(field, opt, SEED)
    assert np.isfinite(float(tl)) and float(tl) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)

    _grad_close(field.grid.grad.numpy(), jg["grid"])
    for i, lj in enumerate(jg["mlp"]):
        _grad_close(field.weights[i].grad.numpy(), lj["w"])
        _grad_close(field.biases[i].grad.numpy(), lj["b"])

    # parameters after one Adam step (optax from JAX's gradients, torch from
    # the port's)
    after = field_params_to_numpy(field)
    adam = optax.adam(LR)
    ref_after = optax.apply_updates(params0, adam.update(jg, adam.init(params0), params0)[0])
    pairs = [(after["grid"], ref_after["grid"])]
    pairs += [(a[k], r[k]) for a, r in zip(after["mlp"], ref_after["mlp"]) for k in ("w", "b")]
    moved = 0
    total = 0
    for a, r in pairs:
        diff = np.abs(a - np.asarray(r))
        moved += int((diff > 2e-3 * LR).sum())
        total += diff.size
        assert float(diff.max()) <= 2.0 * LR * 1.001
    with capsys.disabled():
        print(f"\n[nerad step fused={fused}] loss port {float(tl):.7f} jax {float(jl):.7f}; "
              f"parameters off by more than 2e-3 lr after Adam: {moved} of {total}")
    assert moved <= 0.01 * total, (moved, total)


def _camera(scene, sampler_cls, sample_ray, stack, arange, spp=1):
    w, h = scene.camera.resolution
    n = w * h * spp
    lane = arange(n)
    pix = lane // spp
    sampler = sampler_cls.create(5, lane=lane)
    sampler, jitter = sampler.next_2d()
    pos = stack([(pix % w), (pix // w)]) + jitter
    return sampler, sample_ray(scene.camera, pos)


def test_nerad_integrator_per_lane(cornell_pair, capsys):
    js, ts = cornell_pair
    jcfg, tcfg = _tiny_cfgs(False)
    params = jnerad.init_field(jax.random.PRNGKey(2), jcfg)
    # a field with some structure: larger grid features than at init
    params["grid"] = params["grid"] * 500.0
    field = field_params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    jint = jnerad.NeradIntegrator(trainer=jnerad.NeradTrainer(field_cfg=jcfg), params=params)
    tint = make_integrator({"type": "nerad", "trainer": NeradTrainer(field_cfg=tcfg),
                            "params": field, "unused": 1})
    assert isinstance(tint, NeradIntegrator)
    j_sampler, j_ray = _camera(js, JSampler, jsensor.sample_ray,
                               lambda c: jnp.stack(c, -1).astype(jnp.float32),
                               lambda n: jnp.arange(n, dtype=jnp.uint32), spp=2)
    L_j, valid_j, _ = jax.jit(lambda s, r: jint.sample(js, s, r))(j_sampler, j_ray)
    t_sampler, t_ray = _camera(ts, Sampler, sensor.sample_ray,
                               lambda c: torch.stack(c, -1).to(torch.float32),
                               lambda n: torch.arange(n), spp=2)
    L_t, valid_t, _ = tint.sample(ts, t_sampler, t_ray)
    a, b = L_t.numpy(), np.asarray(L_j)
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=1)
    with capsys.disabled():
        print(f"\n[nerad integrator] lanes whose L differs from JAX beyond rtol 1e-3/atol 1e-4: "
              f"{1.0 - close.mean():.6f} of {len(close)}")
    assert close.mean() >= 0.99, close.mean()
    assert np.array_equal(valid_t.numpy(), np.asarray(valid_j))
    img = render(ts, tint, spp=1)
    assert tuple(img.shape) == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0


def test_nerad_train_and_field_module(cornell_pair):
    """NeradTrainer.train's contract (losses every log_every steps, the
    field updated in place) and Field.forward == field_eval."""
    _, ts = cornell_pair
    _, tcfg = _tiny_cfgs(True)
    trainer = NeradTrainer(field_cfg=tcfg, batch_size=128, m_rhs=2, lr=LR)
    field, losses = trainer.train(ts, n_iters=4, seed=1, log_every=2)
    assert len(losses) == 2 and np.isfinite(losses).all()
    with torch.no_grad():
        start = init_field(torch.Generator().manual_seed(1), tcfg)
    assert not torch.equal(start.grid, field.grid.detach())
    rng = np.random.default_rng(9)
    p = torch.as_tensor(rng.random((50, 3), dtype=np.float32))
    wi = torch.as_tensor(_unit(rng, 50))
    assert torch.equal(field(tcfg, p, wi), field_eval(field, tcfg, p, wi))
