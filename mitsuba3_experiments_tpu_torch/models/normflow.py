"""RealNVP and rational-quadratic-spline normalizing flows, trained by NLL
against analytic (double spiral) or image-based 2-D targets.

Counterpart of ``mitsuba3_experiments_tpu.models.normflow``.  Parameters
are a list of MLPs, one conditioner per coupling, in the port's MLP layout
(``[{"w": (in, out), "b": (out,)}, ...]``); the conditioners run through
`apply_mlp` (bf16 products, float32 sums, tanh gelu), as in JAX.

What changes with the framework:

  * JAX's keys become `torch.Generator`s: `spiral_sample(generator, n)`,
    `flow_sample(params, cfg, generator, n)` and `train_flow`'s
    `target_sample_fn(generator, n)` draw from the generator, on its device;
  * optax becomes `torch.optim.Adam`.  With `n_iters`, the gradients are
    clipped at global norm 5 as ``optax.clip_by_global_norm`` does (left
    alone below the norm, scaled by 5/|g| at or above it) and the learning
    rate follows ``optax.cosine_decay_schedule(lr, n_iters, alpha=0.02)``,
    a `LambdaLR` evaluated at the number of updates already made.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device
from ..core import math as m
from ..core.distributions import DiscreteDistribution2D
from .mlp import apply_mlp, init_mlp


# ---------------------------------------------------------------------------
# target distributions
# ---------------------------------------------------------------------------

def spiral_sample(generator: torch.Generator, n: int, noise: float = 0.1):
    """Double spiral in [0,1]^2, drawn on the generator's device."""
    dev = generator.device
    t = torch.sqrt(torch.rand((n,), generator=generator, device=dev)) * 3.0 * math.pi
    branch = torch.rand((n,), generator=generator, device=dev) < 0.5
    sign = torch.where(branch, 1.0, -1.0)
    r = t / (3.0 * math.pi) * 0.45
    x = torch.stack([r * torch.cos(t) * sign, r * torch.sin(t) * sign], dim=-1)
    x = x + torch.randn((n, 2), generator=generator, device=dev) * noise * r[:, None]
    return x * 0.9 + 0.5


class ImageDistr:
    """Sample 2-D points in proportion to an image's luminance."""

    def __init__(self, image, device=None):
        img = torch.as_tensor(np.asarray(image, np.float32))
        if img.ndim == 3:
            img = m.luminance(img)
        self.h, self.w = img.shape
        self.dist = DiscreteDistribution2D.create(img.numpy(), device=device)

    def sample(self, sampler):
        sampler, u = sampler.next_2d()
        x, y, _ = self.dist.sample(u)
        sampler, jitter = sampler.next_2d()
        pts = torch.stack([(x.to(torch.float32) + jitter[..., 0]) / self.w,
                           (y.to(torch.float32) + jitter[..., 1]) / self.h], dim=-1)
        return sampler, pts


# ---------------------------------------------------------------------------
# flow layers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlowConfig:
    dim: int = 2
    n_couplings: int = 6
    hidden: int = 64
    net_depth: int = 2
    # coupling family: "affine" = RealNVP scale/shift; "rqs" = monotone
    # rational-quadratic splines (Durkan et al. 2019, Neural Spline Flows)
    coupling: str = "affine"
    n_bins: int = 32
    tail_bound: float = 3.0  # the spline acts on [-B, B]; identity outside


def _params_per_out(cfg: FlowConfig) -> int:
    if cfg.coupling == "rqs":
        return 3 * cfg.n_bins - 1  # K widths, K heights, K-1 inner derivatives
    return 2  # affine: log-scale + shift


def init_flow(generator: torch.Generator, cfg: FlowConfig, device=None):
    """Alternating-mask couplings, each with a conditioner MLP whose
    near-zero weights start every coupling at the identity map."""
    params = []
    half = cfg.dim - cfg.dim // 2
    for i in range(cfg.n_couplings):
        cin = half if i % 2 == 0 else cfg.dim // 2
        cout = (cfg.dim - cin) * _params_per_out(cfg)
        sizes = [cin] + [cfg.hidden] * cfg.net_depth + [cout]
        params.append(init_mlp(generator, sizes, scale=1e-2, device=device))
    return params


# ---------------------------------------------------------------------------
# monotone rational-quadratic splines (Durkan et al. 2019, eqs. 4-8)
# ---------------------------------------------------------------------------

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
# softplus(x + _SP_SHIFT) == 1 at x == 0 -> identity-slope init
_SP_SHIFT = float(np.log(np.e - 1.0))


def _softplus(x):
    """log(1 + e^x) as JAX's ``logaddexp(x, 0)``, with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rqs_knots(raw, n_bins: int, B: float):
    """raw (..., 3K-1) -> (cum_x, cum_y, derivs): knot positions on [-B,B]
    and K+1 positive knot derivatives (the boundary ones pinned to 1, so the
    spline meets the unit-slope tails C^1-continuously)."""
    w = torch.softmax(raw[..., :n_bins], dim=-1)
    h = torch.softmax(raw[..., n_bins:2 * n_bins], dim=-1)
    w = _MIN_BIN + (1.0 - _MIN_BIN * n_bins) * w
    h = _MIN_BIN + (1.0 - _MIN_BIN * n_bins) * h
    cum_x = torch.cumsum(w, dim=-1) * (2.0 * B) - B
    cum_y = torch.cumsum(h, dim=-1) * (2.0 * B) - B
    pad = torch.full(cum_x.shape[:-1] + (1,), -B, dtype=cum_x.dtype, device=cum_x.device)
    cum_x = torch.cat([pad, cum_x], dim=-1)  # (..., K+1)
    cum_y = torch.cat([pad, cum_y], dim=-1)
    d_in = _MIN_DERIV + _softplus(raw[..., 2 * n_bins:] + _SP_SHIFT)
    one = torch.ones(d_in.shape[:-1] + (1,), dtype=d_in.dtype, device=d_in.device)
    derivs = torch.cat([one, d_in, one], dim=-1)  # (..., K+1)
    return cum_x, cum_y, derivs


def _rqs_bin(cum, v):
    """Index of the bin containing v (clamped to [0, K-1])."""
    return torch.sum(v[..., None] >= cum[..., 1:-1], dim=-1)


def _rqs_apply(raw, x, n_bins: int, B: float, inverse: bool):
    """Elementwise monotone RQS on [-B,B] with identity tails.  Returns (y,
    log|dy/dx|); for inverse=True the log-det of the inverse map."""
    cum_x, cum_y, derivs = _rqs_knots(raw, n_bins, B)
    inside = (x > -B) & (x < B)
    xc = torch.clamp(x, -B, B)
    k = _rqs_bin(cum_y if inverse else cum_x, xc)

    def take(a, i):
        return torch.gather(a, -1, i[..., None])[..., 0]

    x_k, x_k1 = take(cum_x, k), take(cum_x, k + 1)
    y_k, y_k1 = take(cum_y, k), take(cum_y, k + 1)
    d_k, d_k1 = take(derivs, k), take(derivs, k + 1)
    w = x_k1 - x_k
    hgt = y_k1 - y_k
    s = hgt / w
    if not inverse:
        xi = (xc - x_k) / w
        om = 1.0 - xi
        num = hgt * (s * xi * xi + d_k * xi * om)
        den = s + (d_k1 + d_k - 2.0 * s) * xi * om
        y = y_k + num / den
        dydx = s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om) / (den * den)
        ld = torch.log(dydx)
    else:
        yp = xc - y_k
        c2 = d_k1 + d_k - 2.0 * s
        a = hgt * (s - d_k) + yp * c2
        b = hgt * d_k - yp * c2
        c = -s * yp
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        xi = torch.clamp(2.0 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
        om = 1.0 - xi
        y = x_k + xi * w
        den = s + c2 * xi * om
        dydx = s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om) / (den * den)
        ld = -torch.log(dydx)
    return torch.where(inside, y, x), torch.where(inside, ld, 0.0)


def _split(x, parity, dim):
    half = dim - dim // 2
    if parity == 0:
        return x[..., :half], x[..., half:]
    return x[..., half:], x[..., :half]


def _join(a, b, parity, dim):
    if parity == 0:
        return torch.cat([a, b], dim=-1)
    return torch.cat([b, a], dim=-1)


def _scale_shift(net, cond, n_out):
    h = apply_mlp(net, cond, hidden_act="gelu").float()
    log_s, t = h[..., :n_out], h[..., n_out:]
    return torch.tanh(log_s) * 4.0, t  # bounded scales keep the flow invertible


def _rqs_params(net, cond, n_out, cfg: FlowConfig):
    h = apply_mlp(net, cond, hidden_act="gelu").float()
    return h.reshape(h.shape[:-1] + (n_out, 3 * cfg.n_bins - 1))


def _couple(net, cond, rest, cfg: FlowConfig, inverse: bool):
    """One coupling transform of `rest` given `cond`; returns (new_rest,
    per-sample log-det contribution)."""
    n_out = rest.shape[-1]
    if cfg.coupling == "rqs":
        raw = _rqs_params(net, cond, n_out, cfg)
        rest, ld = _rqs_apply(raw, rest, cfg.n_bins, cfg.tail_bound, inverse)
        return rest, torch.sum(ld, dim=-1)
    log_s, t = _scale_shift(net, cond, n_out)
    if inverse:
        return (rest - t) * torch.exp(-log_s), -torch.sum(log_s, dim=-1)
    return rest * torch.exp(log_s) + t, torch.sum(log_s, dim=-1)


def flow_forward(params, cfg: FlowConfig, z):
    """base -> target; returns (x, log_det)."""
    ldj = torch.zeros(z.shape[:-1], dtype=torch.float32, device=z.device)
    x = z
    for i, net in enumerate(params):
        parity = i % 2
        cond, rest = _split(x, parity, cfg.dim)
        rest, ld = _couple(net, cond, rest, cfg, inverse=False)
        ldj = ldj + ld
        x = _join(cond, rest, parity, cfg.dim)
    return x, ldj


def flow_inverse(params, cfg: FlowConfig, x):
    """target -> base; returns (z, log_det of the inverse)."""
    ldj = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in reversed(range(len(params))):
        parity = i % 2
        cond, rest = _split(x, parity, cfg.dim)
        rest, ld = _couple(params[i], cond, rest, cfg, inverse=True)
        ldj = ldj + ld
        x = _join(cond, rest, parity, cfg.dim)
    return x, ldj


def _base_logpdf(z):
    return torch.sum(-0.5 * z * z - 0.5 * math.log(2 * math.pi), dim=-1)


def flow_log_eval(params, cfg: FlowConfig, x):
    """log p(x): pull back to the base density plus the log-det."""
    z, ldj = flow_inverse(params, cfg, x)
    return _base_logpdf(z) + ldj


def flow_sample(params, cfg: FlowConfig, generator: torch.Generator, n: int):
    z = torch.randn((n, cfg.dim), generator=generator, device=generator.device)
    x, ldj = flow_forward(params, cfg, z)
    return x, _base_logpdf(z) - ldj


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def flow_tensors(params):
    """The parameter tensors of a flow, in a fixed order."""
    return [layer[k] for net in params for layer in net for k in ("w", "b")]


def cosine_decay(count: int, n_iters: int, alpha: float = 0.02) -> float:
    """``optax.cosine_decay_schedule``'s factor after `count` updates."""
    count = min(count, n_iters)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / n_iters)) + alpha


def clip_by_global_norm(tensors, max_norm: float):
    """``optax.clip_by_global_norm`` on the tensors' gradients, in place:
    unchanged below `max_norm`, else g / |g| * max_norm.  No host sync."""
    grads = [t.grad for t in tensors]
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))


def make_train_step(params, cfg: FlowConfig, lr=1e-3, n_iters=None, opt_state=None,
                    start: int = 0):
    """NLL training of `params` in place.  Returns (optimizer, step), where
    `step(batch)` makes one Adam update and returns the loss before it.
    With `n_iters`, gradients are clipped at global norm 5 and the learning
    rate follows the cosine decay to lr/50.  `opt_state` (an optimizer
    `state_dict()`) and `start` (the updates already made) resume a run."""
    tensors = flow_tensors(params)
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.Adam(tensors, lr=lr)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    sched = None
    if n_iters is not None:
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: cosine_decay(k, n_iters), last_epoch=start - 1)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = -torch.mean(flow_log_eval(params, cfg, batch))
        loss.backward()
        if sched is not None:
            clip_by_global_norm(tensors, 5.0)
        opt.step()
        if sched is not None:
            sched.step()
        return loss.detach()

    return opt, step


def train_flow(target_sample_fn, cfg: FlowConfig = FlowConfig(), n_iters=2000, batch=1 << 12,
               seed=0, lr=1e-3, device=None):
    """Train a flow from `init_flow` on batches of `target_sample_fn(generator,
    batch)`; returns (params, the loss of every 100th step)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = init_flow(generator, cfg, device=dev)
    _, step = make_train_step(params, cfg, lr, n_iters=n_iters)
    losses = []
    for i in range(n_iters):
        loss = step(target_sample_fn(generator, batch))
        if (i + 1) % 100 == 0:
            losses.append(float(loss))
    return params, losses
