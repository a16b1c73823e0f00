"""The port's normalizing flows against the JAX package: the flow maps and
log-densities on parameters carried over from JAX's `init_flow` (and a
perturbed copy, whose couplings are far from the identity), training steps
against JAX's `make_train_step` on the same batches, image sampling on the
same sampler, and a short training run.

The conditioners are bf16 MLPs (apply_mlp), where a product rounded on the
other side of a bf16 boundary moves a value by up to a bf16 step, and the
couplings carry that on; so the maps are held as `test_apply_mlp` holds the
MLP: every value within rtol 2e-2 / atol 2e-2, and at least 90% of the rows
within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core.rng import Sampler as JSampler
from mitsuba3_experiments_tpu.models import normflow as jnf
from mitsuba3_experiments_tpu_torch.core.rng import Sampler
from mitsuba3_experiments_tpu_torch.models import normflow as nf
from mitsuba3_experiments_tpu_torch.models.convert import (
    flow_params_from_numpy,
    flow_params_to_numpy,
)

torch.set_num_threads(2)

CASES = [("affine", 2, 16), ("affine", 4, 32), ("rqs", 2, 16), ("rqs", 4, 32)]


def jax_params(cfg, perturbed, seed=0):
    """JAX's init_flow as numpy; `perturbed` scales the weights up tenfold
    and draws the biases, to about the scale of a flow trained for 400 steps
    on the spiral (weights' std 0.01-0.15, biases' 0.05-0.19), so that every
    coupling moves its input."""
    tree = [[{k: np.array(v) for k, v in layer.items()} for layer in net]
            for net in jnf.init_flow(jax.random.PRNGKey(seed), cfg)]
    if perturbed:
        rng = np.random.default_rng(seed + 1)
        for net in tree:
            for layer in net:
                layer["w"] = (layer["w"] * 10.0).astype(np.float32)
                layer["b"] = rng.normal(0.0, 0.15, layer["b"].shape).astype(np.float32)
    return tree


def to_jax(tree):
    return [[{k: jnp.asarray(v) for k, v in layer.items()} for layer in net] for net in tree]


def assert_bf16_close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    rows = np.isclose(got, ref, rtol=1e-5, atol=1e-5).reshape(got.shape[0], -1).all(-1)
    assert rows.mean() >= 0.9, rows.mean()


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("coupling,n_couplings,hidden", CASES)
def test_flow_maps_match_jax(coupling, n_couplings, hidden, perturbed):
    cfg = nf.FlowConfig(coupling=coupling, n_couplings=n_couplings, hidden=hidden)
    jcfg = jnf.FlowConfig(coupling=coupling, n_couplings=n_couplings, hidden=hidden)
    tree = jax_params(jcfg, perturbed)
    tp, jp = flow_params_from_numpy(tree, device="cpu"), to_jax(tree)
    z = (np.random.default_rng(3).normal(size=(512, 2)) * 1.5).astype(np.float32)
    z[:4] = [[5.0, -6.0], [7.0, 8.0], [-3.5, 0.2], [0.0, 0.0]]   # tails outside [-3, 3]
    with torch.no_grad():
        x, ldj = nf.flow_forward(tp, cfg, torch.from_numpy(z))
        jx, jldj = jnf.flow_forward(jp, jcfg, jnp.asarray(z))
        assert_bf16_close(x, jx)
        assert_bf16_close(ldj, jldj)
        zi, ldi = nf.flow_inverse(tp, cfg, torch.from_numpy(z))
        jzi, jldi = jnf.flow_inverse(jp, jcfg, jnp.asarray(z))
        assert_bf16_close(zi, jzi)
        assert_bf16_close(ldi, jldi)
        assert_bf16_close(nf.flow_log_eval(tp, cfg, torch.from_numpy(z)),
                          jnf.flow_log_eval(jp, jcfg, jnp.asarray(z)))
    assert flow_params_to_numpy(tp)[0][0]["w"].tobytes() == tree[0][0]["w"].tobytes()


@pytest.mark.parametrize("coupling", ["affine", "rqs"])
def test_flow_roundtrip_and_log_det(coupling):
    """Within the port: inverse(forward(z)) == z within 1e-4, the log-dets
    of the two directions cancel, and the forward log-det equals log|det|
    of the autodiff Jacobian (torch.func.jacfwd) within 1e-3."""
    cfg = nf.FlowConfig(coupling=coupling, n_couplings=4, hidden=32)
    tp = flow_params_from_numpy(jax_params(jnf.FlowConfig(coupling=coupling, n_couplings=4,
                                                          hidden=32), True, seed=4),
                                device="cpu")
    z = torch.from_numpy((np.random.default_rng(1).normal(size=(256, 2)) * 1.2).astype(np.float32))
    with torch.no_grad():
        x, ldj_f = nf.flow_forward(tp, cfg, z)
        z2, ldj_i = nf.flow_inverse(tp, cfg, x)
    assert float((x - z).abs().max()) > 0.1   # the flow is far from the identity
    np.testing.assert_allclose(z2.numpy(), z.numpy(), atol=1e-4)
    np.testing.assert_allclose(ldj_f.numpy(), -ldj_i.numpy(), atol=1e-4)
    J = torch.func.vmap(torch.func.jacfwd(lambda zz: nf.flow_forward(tp, cfg, zz[None])[0][0]))(
        z[:16])
    np.testing.assert_allclose(torch.log(torch.abs(torch.linalg.det(J))).detach().numpy(),
                               ldj_f[:16].numpy(), atol=1e-3)
    if coupling == "rqs":
        # near-identity init, and identity tails with zero log-det
        init = nf.init_flow(torch.Generator().manual_seed(0), cfg, device="cpu")
        far = torch.tensor([[5.0, -6.0], [7.0, 8.0]])
        with torch.no_grad():
            assert float((nf.flow_forward(init, cfg, z)[0] - z).abs().max()) < 5e-3
            xf, ldf = nf.flow_forward(init, cfg, far)
        np.testing.assert_allclose(xf.numpy(), far.numpy(), atol=1e-6)
        np.testing.assert_allclose(ldf.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("n_iters", [None, 3])
@pytest.mark.parametrize("coupling", ["affine", "rqs"])
def test_train_steps_match_jax(coupling, n_iters):
    """Three steps from the same parameters on the same batches: losses and
    parameters within rtol 1e-3 of JAX's make_train_step (optax), with
    n_iters (clipping + cosine decay, here over 3 steps so that the rate
    moves every step) and without.  Adam moves every parameter by about lr
    a step whatever its gradient's size, so a parameter near 0 is held to
    1e-3 of its three steps' size (atol 3e-5 at lr 1e-2)."""
    kw = dict(coupling=coupling, n_couplings=2, hidden=16)
    cfg, jcfg = nf.FlowConfig(**kw), jnf.FlowConfig(**kw)
    tree = jax_params(jcfg, True, seed=2)
    tp, jp = flow_params_from_numpy(tree, device="cpu"), to_jax(tree)
    opt, jstep = jnf.make_train_step(jcfg, lr=1e-2, n_iters=n_iters)
    jstate = opt.init(jp)
    _, step = nf.make_train_step(tp, cfg, lr=1e-2, n_iters=n_iters)
    rng = np.random.default_rng(8)
    for _ in range(3):
        batch = (rng.random((512, 2)) * 1.2 - 0.1).astype(np.float32)
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(batch))
        loss = step(torch.from_numpy(batch))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    for net, jnet in zip(flow_params_to_numpy(tp), jp):
        for layer, jlayer in zip(net, jnet):
            for k in ("w", "b"):
                np.testing.assert_allclose(layer[k], np.asarray(jlayer[k]), rtol=1e-3,
                                           atol=1e-3 * 3 * 1e-2)


def test_clip_and_schedule_follow_optax():
    """The clip leaves a gradient below the norm untouched and scales one
    above it to the norm; the schedule's factor is optax's at every count."""
    import optax

    t = [torch.zeros(3, requires_grad=True), torch.zeros(2, requires_grad=True)]
    for scale in (0.5, 10.0):
        t[0].grad = torch.tensor([1.0, -2.0, 2.0]) * scale
        t[1].grad = torch.tensor([0.5, 1.0]) * scale
        before = [g.grad.clone() for g in t]
        ref, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g.numpy()) for g in before],
                                                       None)
        nf.clip_by_global_norm(t, 5.0)
        for g, r in zip(t, ref):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), rtol=1e-6)
        if scale < 1:
            assert all(torch.equal(g.grad, b) for g, b in zip(t, before))
    sched = optax.cosine_decay_schedule(1e-3, 50, alpha=0.02)
    for k in (0, 1, 17, 49, 50, 80):
        np.testing.assert_allclose(1e-3 * nf.cosine_decay(k, 50), float(sched(k)), rtol=1e-6)


def test_image_distr_sample_equals_jax():
    rng = np.random.default_rng(4)
    img = (rng.random((8, 12, 3)) ** 3).astype(np.float32)
    img[2:4, 5:7] += 4.0
    ref = jnf.ImageDistr(img).sample(JSampler.create(3, 1 << 12))[1]
    got = nf.ImageDistr(img, device="cpu").sample(Sampler.create(3, 1 << 12, device="cpu"))[1]
    assert np.array_equal(got.numpy(), np.asarray(ref))
    one = np.zeros((8, 8), np.float32)
    one[2:4, 5:7] = 1.0
    pts = nf.ImageDistr(one, device="cpu").sample(Sampler.create(0, 1 << 12, device="cpu"))[1]
    pts = pts.numpy()
    assert ((pts[:, 0] > 5 / 8) & (pts[:, 0] < 7 / 8)).all()
    assert ((pts[:, 1] > 2 / 8) & (pts[:, 1] < 4 / 8)).all()


def test_short_training_lowers_nll():
    cfg = nf.FlowConfig(n_couplings=4, hidden=32)
    params, losses = nf.train_flow(nf.spiral_sample, cfg, n_iters=200, batch=1 << 10, seed=0,
                                   lr=2e-3, device="cpu")
    g = torch.Generator().manual_seed(5)
    batch = nf.spiral_sample(g, 1 << 12)
    init = nf.init_flow(torch.Generator().manual_seed(0), cfg, device="cpu")
    with torch.no_grad():
        first = -float(nf.flow_log_eval(init, cfg, batch).mean())
        last = -float(nf.flow_log_eval(params, cfg, batch).mean())
        xs, log_p = nf.flow_sample(params, cfg, g, 4096)
    print(f"NLL at init {first:.4f}, recorded {losses}, after 200 steps {last:.4f}")
    assert len(losses) == 2 and losses[-1] < first and last < first - 0.5
    assert torch.isfinite(xs).all() and torch.isfinite(log_p).all()
