"""Neural radiance caching: path segments terminated by the area-spread
heuristic into a cached radiance field.

Counterpart of ``mitsuba3_experiments_tpu.integrators.nrc``: the NEE+MIS
segment walk accumulates the spread `sqrt(|p2 - p1|^2 / (pdf |wi2.z|))` and
stops where `spread^2 >= c * a0`; the segment returns its termination
vertex, where a trained radiance field (models.nerad's Field: the cache is
the same hash-grid MLP) closes the estimate.  `NRCTrainer` trains the cache
online from longer unbiased path suffixes.

JAX's `fori_loop` walk becomes a Python loop that runs every one of its
`max_depth` iterations, whatever the mask, so the sampler's dimensions
advance as there; `stop_gradient` becomes `.detach()`, optax's Adam
`torch.optim.Adam`, and the field's PRNG key a `torch.Generator`.  The
cache lookups go through `field_eval`, so with ``FieldConfig(fused=True)``
the MLP runs as K2 on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.records import BSDFFlags, has_flag, twhere
from ..core.rng import Sampler
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter, pdf_emitter_direction, sample_emitter_direction
from .common import mis_weight, register_integrator


def _initial_spread(ray, si):
    """a0, the spread of the camera ray's footprint at its first hit."""
    return m.safe_div(m.squared_norm(ray.o - si.p), 4.0 * m.PI * torch.abs(si.wi[..., 2]))


@dataclasses.dataclass(frozen=True, eq=False)
class NRCIntegrator:
    """max_depth 10 and spread_c 0.01, the reference's defaults.  `cache`:
    (field, trainer) — a models.nerad Field and the NRCTrainer (or
    NeradTrainer) whose `field_cfg` and `scene_bounds` it was trained with;
    None truncates the paths."""

    max_depth: int = 10
    spread_c: float = 0.01
    cache: tuple = None

    def next_segment(self, scene, sampler, si, c, a0, active):
        """Walks the segment from `si`; returns (L, termination si, its
        throughput, terminated mask, sampler).  A lane stops, before any
        sampling there, at the first vertex whose spread reaches c * a0: the
        cache models the full outgoing radiance at that vertex."""
        n = si.p.shape[0]
        dev = si.p.device
        L = torch.zeros((n, 3), dtype=m.Float, device=dev)
        f = torch.ones((n, 3), dtype=m.Float, device=dev)
        eta = torch.ones((n,), dtype=m.Float, device=dev)
        depth = torch.ones((n,), dtype=torch.int32, device=dev)
        spread = torch.zeros((n,), dtype=m.Float, device=dev)
        term_si = si
        term_f = torch.zeros((n, 3), dtype=m.Float, device=dev)
        terminated = torch.zeros((n,), dtype=torch.bool, device=dev)
        mats, tex = scene.materials, scene.textures

        for _ in range(self.max_depth):
            stop_now = active & (spread * spread >= c * a0)
            newly = stop_now & ~terminated
            term_si = twhere(newly, si, term_si)
            term_f = torch.where(newly[:, None], f, term_f)
            terminated = terminated | newly
            active = active & ~stop_now

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
            L = L + torch.where(active_em[:, None], f * bsdf_val * em_weight * mis_em[:, None],
                                0.0)
            f = f * bsdf_weight
            eta = eta * bs.eta

            ray = si.spawn_ray(si.to_world(bs.wo))
            si2 = ray_intersect(scene, ray, active)
            bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
            em_pdf = pdf_emitter_direction(scene, si, si2, ~bsdf_delta)
            mis_b = mis_weight(bs.pdf, em_pdf)
            L = L + torch.where((active & (bs.pdf > 0.0))[:, None],
                                f * eval_emitter(scene, si2, active) * mis_b[:, None], 0.0)

            spread = spread + torch.sqrt(
                m.safe_div(m.squared_norm(si2.p - si.p), bs.pdf * torch.abs(si2.wi[..., 2]))
            )
            si = si2
            depth = torch.where(active, depth + 1, depth)
            active = active & (depth < self.max_depth) & si.valid
        return L, term_si, term_f, terminated, sampler

    @torch.no_grad()
    def sample(self, scene, sampler, ray, active=None):
        n = ray.o.shape[0]
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=ray.o.device)
        si = ray_intersect(scene, ray, active)
        L0 = eval_emitter(scene, si, active)
        active = active & si.valid
        a0 = _initial_spread(ray, si)
        L, term_si, term_f, terminated, sampler = self.next_segment(
            scene, sampler, si, self.spread_c, a0, active
        )
        L = L + L0
        if self.cache is not None:
            from ..models.nerad import field_eval

            field, trainer = self.cache
            lo, extent = trainer.scene_bounds(scene)
            p_norm = torch.clamp((term_si.p - lo) / extent, 0.0, 1.0)
            L_cache = field_eval(field, trainer.field_cfg, p_norm, term_si.wi_world)
            use = terminated & term_si.valid & (term_si.emitter_id < 0)
            L = L + torch.where(use[:, None], term_f * L_cache, 0.0)
        return L, si.valid, sampler


@dataclasses.dataclass(frozen=True, eq=False)
class NRCTrainer:
    """Online self-training of the NRC cache from unbiased path suffixes.

    A batch of camera rays at uniform film positions is walked to the
    render threshold c (the vertex v where `NRCIntegrator.sample` queries
    the cache), then on with a longer unbiased suffix (spread budget
    c * train_spread_mult, depth budget train_depth).  The suffix radiance,
    closed at its own far end by a cache lookup that carries no gradient
    (self-training bootstrap), is the regression target of cache(v), under
    a relative-L2 loss.  Usable as the integrator's cache provider:
    `NRCIntegrator(cache=(field, trainer))`.
    """

    field_cfg: "FieldConfig" = None
    batch_size: int = 1 << 12
    lr: float = 2e-3
    spread_c: float = 0.01           # render-time threshold (cache query set)
    train_spread_mult: float = 32.0  # suffix budget relative to spread_c
    max_depth: int = 6               # render-walk depth budget
    train_depth: int = 10            # suffix-walk depth budget

    def __post_init__(self):
        if self.field_cfg is None:
            from ..models.nerad import FieldConfig

            object.__setattr__(self, "field_cfg", FieldConfig())

    @staticmethod
    def scene_bounds(scene):
        from ..models.nerad import NeradTrainer

        return NeradTrainer.scene_bounds(scene)

    def make_train_step(self, scene):
        """Returns (init, step): init(generator) -> (field, optimizer) on the
        scene's device; step(field, optimizer, seed) runs one step in place
        and returns the step's loss (a detached 0-d tensor)."""
        from ..models.nerad import field_eval, init_field

        lo, extent = self.scene_bounds(scene)
        cfg = self.field_cfg
        dev = scene.device
        render_walk = NRCIntegrator(max_depth=self.max_depth, spread_c=self.spread_c)
        suffix_walk = NRCIntegrator(max_depth=self.train_depth,
                                    spread_c=self.spread_c * self.train_spread_mult)
        w, h = scene.camera.resolution
        film_size = torch.tensor([w, h], dtype=m.Float, device=dev)

        def p_norm(p):
            return torch.clamp((p - lo) / extent, 0.0, 1.0)

        def loss_fn(field, sampler):
            # ---- camera rays at uniform film positions ----
            sampler, u = sampler.next_2d()
            ray = sensorlib.sample_ray(scene.camera, u * film_size)
            si = ray_intersect(scene, ray)
            a0 = _initial_spread(ray, si)
            # ---- render-length walk to the cache-query vertex v ----
            _, v_si, _, v_term, sampler = render_walk.next_segment(
                scene, sampler, si, render_walk.spread_c, a0, si.valid
            )
            v_ok = v_term & v_si.valid & (v_si.emitter_id < 0)
            # ---- unbiased suffix from v (fresh throughput) ----
            L_suf, t_si, t_f, t_term, sampler = suffix_walk.next_segment(
                scene, sampler, v_si, suffix_walk.spread_c, a0, v_ok
            )
            # self-training bootstrap at the far end, without gradient
            L_boot = field_eval(field, cfg, p_norm(t_si.p), t_si.wi_world)
            use_boot = t_term & t_si.valid & (t_si.emitter_id < 0)
            target = (L_suf + torch.where(use_boot[:, None], t_f * L_boot, 0.0)).detach()
            # ---- relative-L2 regression of cache(v) onto the target ----
            pred = field_eval(field, cfg, p_norm(v_si.p), v_si.wi_world)
            denom = torch.sum(pred * pred, dim=-1, keepdim=True).detach() + 1e-2
            err = torch.where(v_ok[:, None], (pred - target) ** 2 / denom, 0.0)
            cnt = torch.clamp(v_ok.to(m.Float).sum(), min=1.0)
            return err.sum() / cnt

        def step(field, opt, seed):
            sampler = Sampler.create(seed, n=self.batch_size, device=dev)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(field, sampler)
            loss.backward()
            opt.step()
            return loss.detach()

        def init(generator):
            field = init_field(generator, cfg, device=dev)
            return field, torch.optim.Adam(field.parameters(), lr=self.lr, betas=(0.9, 0.999),
                                           eps=1e-8)

        return init, step

    def train(self, scene, n_iters=300, seed=0):
        """Returns (field, losses): pass them on as
        NRCIntegrator(cache=(field, self))."""
        init, step = self.make_train_step(scene)
        field, opt = init(torch.Generator().manual_seed(seed))
        losses = [step(field, opt, seed * 65537 + i) for i in range(n_iters)]
        return field, torch.stack(losses).tolist()


register_integrator("nrc", NRCIntegrator)
