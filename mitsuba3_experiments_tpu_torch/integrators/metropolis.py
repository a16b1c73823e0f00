"""Standalone Metropolis-Hastings sampler over a wavefront of independent
chains, validated against analytic 1-D targets via KL divergence.

Counterpart of ``mitsuba3_experiments_tpu.integrators.metropolis``: a fixed
(N, D) array of primary-sample dimensions per chain, the gaussian +
large-step mixture proposal and the accept/reject select.  The state is a
dataclass advanced by a pure function; the counter-based sampler draws the
same numbers as JAX's for the same (seed, lane, dimension).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.rng import Sampler


@dataclasses.dataclass(frozen=True)
class MetropolisState:
    samples: torch.Tensor    # (N, D) current chain positions (primary space)
    proposed: torch.Tensor   # (N, D) proposal awaiting accept/reject
    f: torch.Tensor          # (N,) target value at `samples`
    sampler: Sampler


def seed_metropolis(seed, n: int, d: int, device=None) -> MetropolisState:
    sampler = Sampler.create(seed, n, device=device)
    sampler, u = _uniform_block(sampler, d)
    return MetropolisState(
        samples=u, proposed=u, f=torch.zeros((n,), dtype=m.Float, device=u.device),
        sampler=sampler,
    )


def _uniform_block(sampler, d):
    us = []
    for _ in range(d):
        sampler, u = sampler.next_1d()
        us.append(u)
    return sampler, torch.stack(us, dim=-1)


def sample_proposal(sampler, x, sigma=0.1, p_large=0.1):
    """Gaussian random walk wrapped to [0,1), mixed with large steps."""
    outs = []
    for k in range(x.shape[-1]):
        sampler, u2 = sampler.next_2d()
        step = warp.square_to_std_normal(u2)[..., 0] * sigma
        y = x[..., k] + step
        y = y - torch.floor(y)
        sampler, ul = sampler.next_1d()
        sampler, unew = sampler.next_1d()
        outs.append(torch.where(ul < p_large, unew, y))
    return sampler, torch.stack(outs, dim=-1)


def advance(state: MetropolisState, f_proposed, sigma=0.1, p_large=0.1):
    """Accept/reject on the target ratio, then draw the next proposal."""
    a = torch.clamp(m.safe_div(f_proposed, state.f, fill=1.0), max=1.0)
    sampler, u = state.sampler.next_1d()
    accept = u <= a
    samples = torch.where(accept[:, None], state.proposed, state.samples)
    f = torch.where(accept, f_proposed, state.f)
    sampler, proposed = sample_proposal(sampler, samples, sigma, p_large)
    return MetropolisState(samples=samples, proposed=proposed, f=f, sampler=sampler)


# ---------------------------------------------------------------------------
# validation harness: 1-D bimodal target, KL tracking
# ---------------------------------------------------------------------------

def gaussian(x, mu, sig):
    return 1.0 / (np.sqrt(2.0 * np.pi) * sig) * np.exp(-0.5 * ((x - mu) / sig) ** 2)


def analytic_target(x):
    """Two gaussians with a hole in (0.5, 0.6)."""
    f = gaussian(x, 0.2, 0.01) + gaussian(x, 0.7, 0.1)
    inside = (x > 0.0) & (x < 1.0) & ((x < 0.5) | (x > 0.6))
    return np.where(inside, f, 0.0)


def kl_divergence(p, q, eps=1e-5):
    p = np.asarray(p) + eps
    q = np.asarray(q) + eps
    return float(np.mean(p * np.log(p / q)))


def _histogram(samples, bins):
    hist, _ = np.histogram(samples[:, 0].cpu().numpy(), bins=bins, range=(0, 1))
    return hist / max(hist.sum(), 1)


def run_chain_1d(n_chains=16384, n_iters=300, seed=0, sigma=0.1, p_large=0.1, bins=64,
                 device=None):
    """Run the chains against the analytic target, evaluated in numpy on the
    host; returns (kl_history, final_histogram, target_histogram)."""
    state = seed_metropolis(seed, n_chains, 1, device=device)
    dev = state.f.device

    def target(x):
        f = analytic_target(x[:, 0].cpu().numpy())
        return torch.as_tensor(f.astype(np.float32), device=dev)

    state = dataclasses.replace(state, f=target(state.proposed))

    centers = (np.arange(bins) + 0.5) / bins
    target_hist = analytic_target(centers)
    target_hist = target_hist / target_hist.sum()

    kls = []
    for i in range(n_iters):
        state = advance(state, target(state.proposed), sigma, p_large)
        if (i + 1) % 50 == 0:
            kls.append(kl_divergence(target_hist, _histogram(state.samples, bins)))
    return kls, _histogram(state.samples, bins), target_hist
