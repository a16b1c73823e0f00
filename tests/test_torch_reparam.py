"""The port's reparameterized sampling against the JAX package: the map,
its Jacobian determinant (forward-mode autodiff) against JAX's and against
finite differences, the NLL and its gradients (reverse mode through the
forward-mode Jacobian), and training, which runs exactly `n_iters` steps.

Everything here is float32 (no bf16): values within rtol 1e-5, the NLL and
its gradients within rtol 1e-4 of JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.models import reparam as jrp
from mitsuba3_experiments_tpu_torch.models import reparam as rp
from mitsuba3_experiments_tpu_torch.models.convert import (
    map_params_from_numpy,
    map_params_to_numpy,
)

torch.set_num_threads(2)

SIG = 0.2
CENTER = (0.7, 0.3)


def jax_map(cfg, seed=3, perturbed=False):
    """JAX's init_map as numpy; `perturbed` adds weights and biases of
    std 0.3, so that the map bends (and reverses orientation)."""
    tree = [{k: np.array(v) for k, v in layer.items()}
            for layer in jrp.init_map(jax.random.PRNGKey(seed), cfg)]
    if perturbed:
        rng = np.random.default_rng(seed)
        for layer in tree:
            layer["w"] = (layer["w"] + rng.normal(0, 0.3, layer["w"].shape)).astype(np.float32)
            layer["b"] = rng.normal(0, 0.3, layer["b"].shape).astype(np.float32)
    return tree


def jax_log_p(x):
    return -0.5 * jnp.sum((x - jnp.array(CENTER)) ** 2, -1) / SIG ** 2 - jnp.log(2 * jnp.pi * SIG ** 2)


def log_p(x):
    c = torch.tensor(CENTER, device=x.device)
    return -0.5 * torch.sum((x - c) ** 2, -1) / SIG ** 2 - float(np.log(2 * np.pi * SIG ** 2))


def _z(n, seed):
    return np.random.default_rng(seed).random((n, 2)).astype(np.float32)


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("squash", [False, True])
def test_map_and_det_match_jax(squash, perturbed):
    cfg = jrp.ReparamConfig(dim=2, hidden=16, depth=3)
    tree = jax_map(cfg, perturbed=perturbed)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]
    tp = map_params_from_numpy(tree, device="cpu")
    z = _z(300, 1)
    z[:3] = [[0.0, 1.0], [1e-7, 0.5], [0.5, 0.5]]   # squash's clamp at the edges
    np.testing.assert_allclose(rp.apply_map(tp, torch.from_numpy(z), squash).numpy(),
                               np.asarray(jrp.apply_map(jp, jnp.asarray(z), squash)),
                               rtol=1e-5, atol=1e-6)
    for signed in (False, True):
        got = rp.det_jacobian(tp, torch.from_numpy(z), squash, signed).numpy()
        ref = np.asarray(jrp.det_jacobian(jp, jnp.asarray(z), squash, signed))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        if signed and perturbed:
            assert (got < 0).any()   # orientation reversed: the fold penalty acts
    assert map_params_to_numpy(tp)[1]["w"].tobytes() == tree[1]["w"].tobytes()


def test_det_jacobian_vs_finite_difference():
    """JAX's test_reparam_detjac_vs_finite_difference on the port."""
    tp = map_params_from_numpy(jax_map(jrp.ReparamConfig(dim=2, hidden=16, depth=2)),
                               device="cpu")
    z = torch.tensor([[0.3, 0.7], [0.1, 0.2]])
    det = rp.det_jacobian(tp, z).numpy()
    eps = 1e-3
    for k in range(2):
        J = np.zeros((2, 2))
        for i in range(2):
            dz = torch.zeros((1, 2))
            dz[0, i] = eps
            J[:, i] = ((rp.apply_map(tp, z[k:k + 1] + dz) - rp.apply_map(tp, z[k:k + 1] - dz))[0]
                       / (2 * eps)).numpy()
        np.testing.assert_allclose(det[k], abs(np.linalg.det(J)), rtol=1e-2)


@pytest.mark.parametrize("fold_penalty", [0.0, 2.0])
@pytest.mark.parametrize("squash", [False, True])
def test_nll_and_gradients_match_jax(squash, fold_penalty):
    cfg = jrp.ReparamConfig(dim=2, hidden=16, depth=3)
    tree = jax_map(cfg, seed=5, perturbed=True)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]
    tp = map_params_from_numpy(tree, device="cpu")
    for layer in tp:
        for t in layer.values():
            t.requires_grad_(True)
    z = _z(512, 2)
    jloss, jgrad = jax.value_and_grad(jrp.nll_loss)(jp, jnp.asarray(z), jax_log_p, squash=squash,
                                                    fold_penalty=fold_penalty)
    loss = rp.nll_loss(tp, torch.from_numpy(z), log_p, squash=squash, fold_penalty=fold_penalty)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    scale = max(float(np.abs(np.asarray(g[k])).max()) for g in jgrad for k in ("w", "b"))
    for layer, jlayer in zip(tp, jgrad):
        for k in ("w", "b"):
            np.testing.assert_allclose(layer[k].grad.numpy(), np.asarray(jlayer[k]), rtol=1e-4,
                                       atol=1e-6 * scale)
    assert scale > 0


def test_train_reparam_runs_exactly_n_iters():
    """250 steps, not JAX's 200 (it runs n_iters // 100 chunks of 100): the
    target is evaluated once per step, and a loss is recorded at steps 100,
    200 and 250."""
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return log_p(x)

    params, losses = rp.train_reparam(counted, rp.ReparamConfig(dim=2, hidden=8, depth=2),
                                      n_iters=250, batch=64, lr=3e-3, seed=1, device="cpu")
    assert calls == [64] * 250
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert len(params) == 2 and params[0]["w"].shape == (2, 8)


def test_reparam_training_moves_mass_to_the_bump():
    """JAX's test_reparam_training_concentrates_mass, on the port."""
    params, losses = rp.train_reparam(log_p, rp.ReparamConfig(dim=2, hidden=16, depth=2),
                                      n_iters=600, batch=1 << 10, lr=3e-3, seed=1, device="cpu")
    assert len(losses) == 6 and losses[-1] < 1.0, losses
    z = torch.rand((4096, 2), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        x = rp.apply_map(params, z).numpy()
    d = np.linalg.norm(x - np.array(CENTER), axis=-1)
    d_uniform = np.linalg.norm(z.numpy() - np.array(CENTER), axis=-1)
    assert np.median(d) < 0.8 * np.median(d_uniform), np.median(d)
