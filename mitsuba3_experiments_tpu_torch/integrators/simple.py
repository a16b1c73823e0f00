"""Minimal BSDF-sampling-only path tracer (counterpart of
``mitsuba3_experiments_tpu.integrators.simple``): no NEE, no MIS; hit
emitters accumulate directly.  Converges to the same image as the MIS path
tracer.  The JAX `lax.while_loop` runs as a Python loop while any lane is
active, without autograd, as ``PathIntegrator(differentiable=False)``."""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render.emitter import eval_emitter
from .common import register_integrator


@dataclasses.dataclass(frozen=True)
class SimpleIntegrator:
    max_depth: int = 16
    rr_depth: int = 4

    @torch.no_grad()
    def sample(self, scene, sampler, ray, active=None):
        n = ray.o.shape[0]
        dev = ray.o.device
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=dev)

        L = torch.zeros((n, 3), dtype=m.Float, device=dev)
        f = torch.ones((n, 3), dtype=m.Float, device=dev)
        depth = torch.zeros((n,), dtype=torch.int32, device=dev)
        si = ray_intersect(scene, ray, active)
        L = L + eval_emitter(scene, si, active)
        active = active & si.valid

        while bool(active.any()):
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, weight = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, active)
            f = f * weight

            # Russian roulette
            fmax = m.max_component(f)
            rr_prob = torch.clamp(fmax, max=0.95)
            rr_active = depth >= self.rr_depth
            sampler, u_rr = sampler.next_1d()
            f = torch.where(rr_active[:, None], f * m.safe_rcp(rr_prob.detach())[:, None], f)
            active = active & (fmax > 0.0) & (~rr_active | (u_rr < rr_prob))

            ray2 = si.spawn_ray(si.to_world(bs.wo))
            si2 = ray_intersect(scene, ray2, active)
            L = L + torch.where(active[:, None], f * eval_emitter(scene, si2, active), 0.0)
            si = si2
            depth = torch.where(active, depth + 1, depth)
            active = active & (depth < self.max_depth - 1) & si.valid
        return L, torch.ones((n,), dtype=torch.bool, device=dev), sampler


register_integrator("simple", SimpleIntegrator)
