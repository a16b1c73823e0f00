"""Primary-sample-space Metropolis light transport (PSSMLT).

Counterpart of ``mitsuba3_experiments_tpu.integrators.pssmlt``, the Kelemen
et al. 2002 formulation:

  * a chain's state is its primary sample vector: the screen position and
    every uniform the path tracer consumes (per-bounce BSDF, NEE emitter and
    Russian-roulette uniforms), so the path is a deterministic function of
    it;
  * small steps are wrapped gaussians on every component (symmetric on the
    torus [0,1)^d); large steps redraw the whole vector;
  * chains roam the whole image, and the normalization b = E[lum] is the
    mean luminance of the bootstrap rounds' bootstrap_count * n uniform
    samples;
  * each round splats the current and the proposed state with Kelemen's
    expected-value weights, MIS-combined with the large-step estimator.

`step` runs one round over all chains.  Its mutation draws come from
`_uniform_grid`, a counter-based hash of (seed, round, tag, index) whose
bits equal JAX's.  The JAX `lax.fori_loop` over bounces is a Python loop;
every ray query goes through `ray_intersect` / `sample_emitter_direction`
(K1 on the card).  JAX donates the state and the accumulator to its jitted
step; here `step` updates both in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import math as m
from ..core.records import BSDFFlags, SurfaceInteraction, has_flag
from ..core.rng import MASK32, pcg_hash, tea32, uint_to_float01
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter, pdf_emitter_direction, sample_emitter_direction
from .common import mis_weight, register_integrator

_SQRT2 = math.sqrt(2.0)


def _uniform_grid(seed: int, it: int, tag: int, shape, device=None) -> torch.Tensor:
    """Counter-based uniforms of any shape: a pure function of (seed, round,
    tag, flat index).  The uint32 arithmetic runs in int64 masked to 32 bits,
    as in core/rng.py."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = tea32(int(seed), (int(it) * 0x9E3779B9 + int(tag)) & MASK32)
    bits = pcg_hash(pcg_hash(idx ^ k0) + k1)
    return uint_to_float01(bits).reshape(shape)


def _mutate(old, u, large, sigma):
    """Symmetric wrapped-gaussian small step / uniform large step.  The same
    uniform `u` is the fresh value of a large step and, through the inverse
    CDF, the gaussian of a small one.  ``torch.remainder`` takes the sign of
    the divisor, as JAX's ``%``: a small negative value wraps to just below 1
    (or to 1.0 itself where float32 rounds it there)."""
    g = _SQRT2 * m.erfinv(torch.clamp(2.0 * u - 1.0, -0.999999, 0.999999))
    return torch.where(large, u, torch.remainder(old + sigma * g, 1.0))


@dataclasses.dataclass(frozen=True)
class PssmltState:
    """Per-chain Markov state: the primary sample vector + cached value."""

    pos: torch.Tensor      # (N, 2) screen position in [0,1)^2
    u_bsdf: torch.Tensor   # (D, N, 3) per-bounce BSDF uniforms (u1, u2)
    u_em: torch.Tensor     # (D, N, 2) per-bounce NEE emitter uniforms
    u_rr: torch.Tensor     # (D, N) per-bounce RR decisions
    L: torch.Tensor        # (N, 3) radiance of the current chain state
    b_sum: torch.Tensor    # () running sum of bootstrap luminances


@dataclasses.dataclass(frozen=True)
class Pssmlt:
    """mode="path": NEE+MIS chains, registered as "pssmlt"; mode="simple":
    BSDF sampling only."""

    max_depth: int = 8
    rr_depth: int = 4
    mode: str = "path"             # "path" | "simple"
    p_large: float = 0.3           # large-step probability (sampling phase)
    sigma_pos: float = 1.0 / 64.0  # screen small-step stddev (screen fraction)
    sigma_u: float = 1.0 / 32.0    # primary-space small-step stddev
    bootstrap_count: int = 40      # all-large-step rounds estimating b

    def init_state(self, n: int, device=None) -> PssmltState:
        d = self.max_depth

        def half(*shape):
            return torch.full(shape, 0.5, dtype=m.Float, device=device)

        return PssmltState(
            pos=half(n, 2), u_bsdf=half(d, n, 3), u_em=half(d, n, 2), u_rr=half(d, n),
            L=torch.zeros((n, 3), dtype=m.Float, device=device),
            b_sum=torch.zeros((), dtype=m.Float, device=device),
        )

    # -- deterministic path eval from a primary sample vector ---------------
    @torch.no_grad()
    def sample(self, scene, ray, u_bsdf, u_em, u_rr):
        """Trace the path the uniform arrays encode; returns (N, 3) L.  The
        NEE+MIS loop of integrators/path.py, reading every draw from the
        chain's arrays.  Stops early once no lane is active (the remaining
        JAX iterations add nothing)."""
        n = ray.o.shape[0]
        dev = ray.o.device
        L = torch.zeros((n, 3), dtype=m.Float, device=dev)
        f = torch.ones((n, 3), dtype=m.Float, device=dev)
        eta = torch.ones((n,), dtype=m.Float, device=dev)
        depth = torch.zeros((n,), dtype=torch.int32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_si = SurfaceInteraction.invalid(n, device=dev)
        prev_bsdf_pdf = torch.ones((n,), dtype=m.Float, device=dev)
        prev_bsdf_delta = torch.ones((n,), dtype=torch.bool, device=dev)
        mats, tex = scene.materials, scene.textures

        for d in range(self.max_depth):
            if not bool(active.any()):
                break
            si = ray_intersect(scene, ray, active)

            # direct emission, MIS-weighted against the previous bounce's NEE
            if self.mode == "path":
                em_pdf = pdf_emitter_direction(scene, prev_si, si, ~prev_bsdf_delta)
            else:  # simple: BSDF sampling is the only strategy
                em_pdf = torch.zeros((n,), dtype=m.Float, device=dev)
            mis_b = mis_weight(prev_bsdf_pdf, em_pdf)
            L = L + torch.where(
                (active & (prev_bsdf_pdf > 0))[:, None],
                f * eval_emitter(scene, si, active) * mis_b[:, None], 0.0,
            )

            active_next = active & ((depth + 1) < self.max_depth) & si.valid

            bs, bsdf_weight = bsdflib.sample(mats, tex, si, u_bsdf[d, :, 0], u_bsdf[d, :, 1:3],
                                             active_next)
            ray = si.spawn_ray(si.to_world(bs.wo))

            # NEE with the chain's emitter sample (path mode only); at the
            # last bounce no lane is active_next, so its shadow query (a K1
            # launch over no live lane in JAX's loop) is skipped
            if self.mode == "path" and d + 1 < self.max_depth:
                flags = bsdflib.bsdf_flags(mats, si.mat_id)
                active_em = active_next & has_flag(flags, BSDFFlags.Smooth)
                ds, em_weight = sample_emitter_direction(scene, si, u_em[d], True, active_em)
                nee_val, nee_pdf = bsdflib.eval_pdf(mats, tex, si, si.to_local(ds.d), active_em)
                mi_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, nee_pdf))
                L = L + torch.where(active_em[:, None], f * nee_val * em_weight * mi_em[:, None],
                                    0.0)

            f = f * bsdf_weight
            eta = eta * bs.eta
            prev_si = si
            prev_bsdf_pdf = bs.pdf
            prev_bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
            depth = torch.where(active & si.valid, depth + 1, depth)

            fmax = m.max_component(f)
            rr_prob = torch.clamp(fmax * eta * eta, max=0.95)
            rr_active = depth >= self.rr_depth
            f = torch.where(rr_active[:, None], f * m.safe_rcp(rr_prob)[:, None], f)
            active = active_next & (~rr_active | (u_rr[d] < rr_prob)) & (fmax != 0.0)
        return L

    # -- one MCMC round over all chains --------------------------------------
    @torch.no_grad()
    def step(self, scene, state: PssmltState, accum, seed: int, it: int, bootstrap: bool):
        """Mutate, evaluate, Kelemen-splat, accept/reject; updates `state`
        and `accum` ((W*H, 3)) in place and returns them.  Bootstrap rounds
        force large steps, accumulate b and splat nothing."""
        w, h = scene.camera.resolution
        n = state.L.shape[0]
        d = self.max_depth
        dev = state.L.device

        def grid(tag, shape):
            return _uniform_grid(seed, it, tag, shape, device=dev)

        if bootstrap:
            large = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            large = grid(0, (n,)) < self.p_large

        pos_p = _mutate(state.pos, grid(1, (n, 2)), large[:, None], self.sigma_pos)
        u_bsdf_p = _mutate(state.u_bsdf, grid(2, (d, n, 3)), large[None, :, None], self.sigma_u)
        u_em_p = _mutate(state.u_em, grid(3, (d, n, 2)), large[None, :, None], self.sigma_u)
        u_rr_p = _mutate(state.u_rr, grid(4, (d, n)), large[None, :], self.sigma_u)

        res = torch.tensor([w, h], dtype=m.Float, device=dev)
        ray = sensorlib.sample_ray(scene.camera, pos_p * res[None, :])
        L_prop = self.sample(scene, ray, u_bsdf_p, u_em_p, u_rr_p)
        L_prop = torch.where(torch.isfinite(L_prop), L_prop, 0.0)
        lum_prop = m.luminance(L_prop)
        lum_cur = m.luminance(state.L)

        a = torch.clamp(m.safe_div(lum_prop, lum_cur, fill=1.0), 0.0, 1.0)
        accept = grid(5, (n,)) < a

        if not bootstrap:
            # Kelemen expected-value + large-step MIS splatting; b is the
            # global mean luminance of the bootstrap's uniform samples
            b = self.normalization(state)
            b = torch.where(b > 0, b, 1.0)
            w_prop = (a + large.to(m.Float)) / (lum_prop / b + self.p_large)
            w_cur = (1.0 - a) / (lum_cur / b + self.p_large)
            for pos01, val, wgt in ((pos_p, L_prop, w_prop), (state.pos, state.L, w_cur)):
                px = torch.clamp((pos01[:, 0] * w).to(torch.int32), 0, w - 1)
                py = torch.clamp((pos01[:, 1] * h).to(torch.int32), 0, h - 1)
                accum.index_add_(0, (py * w + px).long(), val * wgt[:, None])
        else:
            state.b_sum.add_(lum_prop.sum())

        for cur, prop, mask in ((state.pos, pos_p, accept[:, None]),
                                (state.u_bsdf, u_bsdf_p, accept[None, :, None]),
                                (state.u_em, u_em_p, accept[None, :, None]),
                                (state.u_rr, u_rr_p, accept[None, :]),
                                (state.L, L_prop, accept[:, None])):
            cur.copy_(torch.where(mask, prop, cur))
        return state, accum

    # -- full render ----------------------------------------------------------
    def run_chains(self, scene, seed: int = 0, n_iterations: int = 200):
        """n_iterations rounds over W*H chains, the first bootstrap_count of
        them bootstrap rounds; returns (state, accumulator)."""
        w, h = scene.camera.resolution
        n = w * h
        state = self.init_state(n, device=scene.device)
        accum = torch.zeros((n, 3), dtype=m.Float, device=scene.device)
        for i in range(n_iterations):
            state, accum = self.step(scene, state, accum, seed, i, i < self.bootstrap_count)
        return state, accum

    def normalization(self, state) -> torch.Tensor:
        """b, the mean luminance of the bootstrap rounds' uniform samples:
        an unbiased estimate of the image's mean luminance, whatever the
        chains' start-up."""
        return state.b_sum / (self.bootstrap_count * state.L.shape[0])

    def render(self, scene, seed: int = 0, n_iterations: int = 200):
        """The (H, W, 3) image of `run_chains`: the accumulator over the
        sampling rounds."""
        w, h = scene.camera.resolution
        _, accum = self.run_chains(scene, seed, n_iterations)
        return (accum / max(n_iterations - self.bootstrap_count, 1)).reshape(h, w, 3)


register_integrator("pssmlt", Pssmlt)
