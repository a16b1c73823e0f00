"""Reparameterized importance sampling: learn a sampling map T(z) whose
density is shaped by |det J_T|.

Counterpart of ``mitsuba3_experiments_tpu.models.reparam``.  The Jacobian
comes from forward-mode autodiff (``torch.func.vmap(torch.func.jacfwd(...))``,
JAX's ``vmap(jacfwd)``), and the NLL's gradient runs reverse mode through
it.  `train_reparam` makes exactly `n_iters` Adam steps (the JAX version
runs ``n_iters // 100`` chunks of 100 and drops the rest).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from .mlp import identity_init_mlp


def talu(x):
    """TaLU: tanh below 0, linear above (smooth, invertible-friendly)."""
    return torch.where(x < 0, torch.tanh(x), x)


@dataclasses.dataclass(frozen=True)
class ReparamConfig:
    dim: int = 2
    hidden: int = 32
    depth: int = 3
    # squash: T = sigmoid(MLP(logit(z))) maps the unit square to itself
    # (without it long NLL runs inflate |det J| outside the square)
    squash: bool = False
    # fold_penalty: see nll_loss; keeps T orientation-preserving
    fold_penalty: float = 0.0


def init_map(generator: torch.Generator, cfg: ReparamConfig, device=None):
    sizes = [cfg.dim] + [cfg.hidden] * (cfg.depth - 1) + [cfg.dim]
    return identity_init_mlp(generator, sizes, device=device)


def apply_map(params, z, squash: bool = False):
    """T(z), the learned sampling map, in float32 (second-order work wants
    full precision)."""
    eps = 1e-5
    if squash:
        zc = torch.clamp(z, eps, 1 - eps)
        h = torch.log(zc / (1 - zc))
    else:
        h = z
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = talu(h)
    return torch.sigmoid(h) if squash else h


def det_jacobian(params, z, squash: bool = False, signed: bool = False):
    """det J_T(z) per sample by forward mode; abs unless signed=True."""
    J = torch.func.vmap(torch.func.jacfwd(lambda zz: apply_map(params, zz, squash)))(z)
    d = torch.linalg.det(J)
    return d if signed else torch.abs(d)


def nll_loss(params, z, log_p_ref, defensive=0.05, squash: bool = False,
             fold_penalty: float = 0.0):
    """-log(p_ref(T(z)) |det J|) with a defensive mixture.  The objective is
    reverse KL and holds only while T stays bijective; `fold_penalty` *
    relu(-det) (signed det) keeps T orientation-preserving."""
    x = apply_map(params, z, squash)
    det = det_jacobian(params, z, squash, signed=True)
    p = torch.exp(log_p_ref(x)) * torch.abs(det)
    p = (1.0 - defensive) * p + defensive
    loss = -torch.mean(torch.log(torch.clamp(p, min=1e-12)))
    if fold_penalty:
        loss = loss + fold_penalty * torch.mean(torch.relu(-det))
    return loss


def train_reparam(log_p_ref, cfg: ReparamConfig = ReparamConfig(), n_iters=1000,
                  batch=1 << 12, lr=1e-3, seed=0, device=None):
    """Adam on the NLL for exactly `n_iters` steps, on uniform batches drawn
    from a generator seeded with `seed`; returns (params, losses), the loss
    of every 100th step and of the last one."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = init_map(generator, cfg, device=dev)
    tensors = [layer[k] for layer in params for k in ("w", "b")]
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.Adam(tensors, lr=lr)
    losses = []
    for i in range(n_iters):
        z = torch.rand((batch, cfg.dim), generator=generator, device=dev)
        opt.zero_grad(set_to_none=True)
        loss = nll_loss(params, z, log_p_ref, squash=cfg.squash, fold_penalty=cfg.fold_penalty)
        loss.backward()
        opt.step()
        if (i + 1) % 100 == 0 or i == n_iters - 1:
            losses.append(loss.item())
    return params, losses
