"""Wavefront unidirectional path tracer with NEE + MIS + Russian roulette.

Counterpart of ``mitsuba3_experiments_tpu.integrators.path``: at each
surface interaction the emitter sample and the BSDF bounce are
MIS-combined.  All lanes step together, and the sampler's dimension counter
advances once per bounce for the whole wavefront, exactly as in JAX, so
every lane draws the same numbers as there.

The forward (``differentiable=False``) runs the JAX `lax.while_loop` as a
Python loop while any lane is active, without autograd.  The
differentiable form runs the JAX `lax.scan`'s fixed ``max_depth - 1``
bounces, each under `torch.utils.checkpoint` (JAX's `jax.checkpoint`), so
the backward keeps one bounce's activations at a time and runs each bounce
again, its ray queries included (K1 on the card launches once more per
bounce).  Sampling stays detached as in JAX: gradients stop at the Russian
roulette probability, the MIS weights and the next hit.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..core import math as m
from ..core.records import BSDFFlags, has_flag
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render.emitter import (
    eval_emitter,
    eval_environment,
    pdf_emitter_direction,
    pdf_environment_direction,
    sample_emitter_direction,
)
from .common import mis_weight, register_integrator


def _detach(record):
    return type(record)(**{f.name: getattr(record, f.name).detach()
                           for f in dataclasses.fields(record)})


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    """max_depth / rr_depth with Mitsuba's defaults; `differentiable`
    selects the fixed-length checkpointed loop that autograd can run
    through."""

    max_depth: int = 16
    rr_depth: int = 4
    differentiable: bool = False

    def sample(self, scene, sampler, ray, active=None):
        if not self.differentiable:
            with torch.no_grad():
                return self._sample(scene, sampler, ray, active)
        return self._sample(scene, sampler, ray, active)

    def _sample(self, scene, sampler, ray, active):
        n = ray.o.shape[0]
        dev = ray.o.device
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=dev)

        L = torch.zeros((n, 3), dtype=m.Float, device=dev)
        f = torch.ones((n, 3), dtype=m.Float, device=dev)
        eta = torch.ones((n,), dtype=m.Float, device=dev)
        depth = torch.ones((n,), dtype=torch.int32, device=dev)
        active = active & (depth < self.max_depth + 1)

        # ------------------- primary hit + its emission -------------------
        si = ray_intersect(scene, ray, active)
        L = L + eval_emitter(scene, si, active)
        L = L + eval_environment(scene, active & ~si.valid, ray.d)
        active = active & si.valid & (depth < self.max_depth)

        state = (L, f, eta, depth, active, si, sampler)
        if self.differentiable:
            for _ in range(max(self.max_depth - 1, 0)):
                # the sampler is counter-based, so the recomputed bounce
                # draws the same numbers without saving any RNG state
                state = checkpoint(self._bounce, scene, *state, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            while bool(state[4].any()):
                state = self._bounce(scene, *state)
        L, f, eta, depth, active, si, sampler = state
        return L, depth > 0, sampler

    def _bounce(self, scene, L, f, eta, depth, active, si, sampler):
        """One bounce of every lane: NEE, the BSDF sample, Russian roulette
        and the emission the bounce ray finds."""
        mats, tex = scene.materials, scene.textures

        # ---------------------- emitter sampling ----------------------
        flags = bsdflib.bsdf_flags(mats, si.mat_id)
        active_em = active & has_flag(flags, BSDFFlags.Smooth)

        sampler, u_em = sampler.next_2d()
        ds, em_weight = sample_emitter_direction(scene, si, u_em, True, active_em)
        active_em = active_em & (ds.pdf != 0.0)
        wo = si.to_local(ds.d)

        sampler, u1 = sampler.next_1d()
        sampler, u2 = sampler.next_2d()
        bsdf_val, bsdf_pdf, bs, bsdf_weight = bsdflib.eval_pdf_sample(
            mats, tex, si, wo, u1, u2, active
        )

        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
        L = L + torch.where(
            active_em[:, None], f * bsdf_val * em_weight * mis_em[:, None], 0.0
        )

        # ----------------- next surface interaction -------------------
        f = f * bsdf_weight
        eta = eta * bs.eta

        # --------------------- stopping criterion ---------------------
        fmax = m.max_component(f)
        rr_prob = torch.clamp(fmax * eta * eta, max=0.95)
        rr_active = depth >= self.rr_depth
        sampler, u_rr = sampler.next_1d()
        rr_continue = u_rr < rr_prob
        f = torch.where(rr_active[:, None], f * m.safe_rcp(rr_prob.detach())[:, None], f)
        active = active & (fmax != 0.0)
        active = active & (~rr_active | rr_continue)

        # ---------------------- direct emission -----------------------
        ray2 = si.spawn_ray(si.to_world(bs.wo))
        si2 = ray_intersect(scene, ray2, active)

        bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
        em_pdf = pdf_emitter_direction(scene, si, si2, ~bsdf_delta)
        mis_bsdf = mis_weight(bs.pdf, em_pdf)
        L = L + torch.where(
            (active & (bs.pdf > 0.0))[:, None],
            f * eval_emitter(scene, si2, active) * mis_bsdf[:, None],
            0.0,
        )
        # escaped bounce rays collect the environment, MIS-weighted
        # against env-NEE (pdf 0 for constant/absent envs -> weight 1)
        esc = active & ~si2.valid & (bs.pdf > 0.0)
        env_pdf = pdf_environment_direction(scene, ray2.d, esc & ~bsdf_delta)
        mis_env = mis_weight(bs.pdf, env_pdf)
        L = L + torch.where(
            esc[:, None],
            f * eval_environment(scene, esc, ray2.d) * mis_env[:, None],
            0.0,
        )

        si = _detach(si2)
        depth = torch.where(active, depth + 1, depth)
        active = active & (depth < self.max_depth) & si.valid
        return L, f, eta, depth, active, si, sampler


register_integrator("path", PathIntegrator)
register_integrator("mypath", PathIntegrator)
