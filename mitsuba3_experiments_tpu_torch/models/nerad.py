"""Neural radiosity: a hash-grid + SH-encoded MLP radiance field trained on
a one-bounce residual (LHS = field, RHS = NEE+MIS estimate + field at the
next bounce).

Counterpart of ``mitsuba3_experiments_tpu.models.nerad``.  Every sample is
drawn from the same counter-based sampler dimensions as there, so a step
can be held against the JAX package's lane by lane.  The field is an
`nn.Module` (`Field`); a training step is one autograd backward through
both sides of the residual and one `torch.optim.Adam` step, updating the
field in place (JAX's step is functional).

With ``FieldConfig.fused`` the MLP runs as the hand-written CUDA kernel on
a CUDA tensor (models/fused_mlp.py), or raises; with ``fused=False`` it
is the plain `apply_mlp`, the JAX package's own unfused configuration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core import math as m
from ..core import warp
from ..core.distributions import DiscreteDistribution
from ..core.records import BSDFFlags, SurfaceInteraction, has_flag, trepeat, twhere
from ..core.rng import Sampler
from ..core.sh import sh_eval
from ..integrators.common import mis_weight, register_integrator
from ..intersect import ray_intersect
from ..ops import block_sum
from ..render import bsdf as bsdflib
from ..render.emitter import eval_emitter, pdf_emitter_direction, sample_emitter_direction
from .fused_mlp import fused_apply_mlp
from .hashgrid_enc import HashGridConfig, hashgrid_encode, init_hashgrid
from .mlp import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    grid: HashGridConfig = HashGridConfig()
    sh_order: int = 3
    width: int = 64
    depth: int = 4
    # fused=True evaluates the MLP with the fused CUDA kernel on the card
    # (activations on chip across layers); the backward recomputes the
    # plain path (models/fused_mlp.py).  fused_tile: rows per CUDA block.
    fused: bool = False
    fused_tile: int = 512


class Field(nn.Module):
    """The field's parameters: the (L, T, F) hash-grid table and the MLP's
    weights (in, out) and biases, all float32."""

    def __init__(self, grid, mlp):
        super().__init__()
        self.grid = nn.Parameter(grid)
        self.weights = nn.ParameterList([nn.Parameter(layer["w"]) for layer in mlp])
        self.biases = nn.ParameterList([nn.Parameter(layer["b"]) for layer in mlp])

    @property
    def mlp(self):
        """models/mlp.py's parameter list, sharing these parameters."""
        return [{"w": w, "b": b} for w, b in zip(self.weights, self.biases)]

    def forward(self, cfg: FieldConfig, p_norm, wi_world):
        return field_eval(self, cfg, p_norm, wi_world)


def init_field(generator: torch.Generator, cfg: FieldConfig, device=None) -> Field:
    in_dim = cfg.grid.out_dim + (cfg.sh_order + 1) ** 2
    sizes = [in_dim] + [cfg.width] * (cfg.depth - 1) + [3]
    grid = init_hashgrid(generator, cfg.grid, device=device)
    return Field(grid, init_mlp(generator, sizes, device=device))


def field_eval(params: Field, cfg: FieldConfig, p_norm, wi_world):
    """L(x, omega).  p_norm in [0,1]^3; exp output for nonnegative radiance
    (exp(out) - 1, as written in the JAX package, not expm1)."""
    feat_p = hashgrid_encode(params.grid, p_norm, cfg.grid)
    feat_d = sh_eval(wi_world, cfg.sh_order)
    h = torch.cat([feat_p, feat_d.to(feat_p.dtype)], dim=-1)
    if cfg.fused:
        out = fused_apply_mlp(params.mlp, h.float(), "leaky_relu", cfg.fused_tile)
    else:
        out = apply_mlp(params.mlp, h, hidden_act="leaky_relu", out_act="none")
    return torch.exp(out.float()) - 1.0


@dataclasses.dataclass(frozen=True)
class NeradTrainer:
    field_cfg: FieldConfig = FieldConfig()
    batch_size: int = 1 << 14
    m_rhs: int = 32          # RHS fan-out
    lr: float = 1e-3

    # ---------------- scene-space normalization -----------------------
    @staticmethod
    def scene_bounds(scene):
        lo = torch.amin(scene.geometry.vertices, dim=0)
        hi = torch.amax(scene.geometry.vertices, dim=0)
        return lo, hi - lo

    # ---------------- surface sampling ---------------------------------
    @staticmethod
    def make_area_dist(scene):
        v = scene.geometry.vertices.cpu().numpy()
        f = scene.geometry.faces.cpu().numpy()
        tri = v[f]
        areas = 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
        )
        return DiscreteDistribution.create(areas.astype(np.float32), device=scene.device)

    def sample_surface(self, scene, area_dist, sampler):
        """Area-weighted surface point + uniform-sphere wi -> synthetic si."""
        g = scene.geometry
        sampler, u_f = sampler.next_1d()
        face, u_re = area_dist.sample_reuse(u_f)
        sampler, u_b = sampler.next_1d()
        fl = face.long()
        fidx = g.faces[fl].long()
        v0, v1, v2 = g.vertices[fidx[:, 0]], g.vertices[fidx[:, 1]], g.vertices[fidx[:, 2]]
        b = warp.square_to_uniform_triangle(torch.stack([u_re, u_b], dim=-1))
        p = v0 + (v1 - v0) * b[..., :1] + (v2 - v0) * b[..., 1:2]
        ng = m.normalize(m.cross(v1 - v0, v2 - v0))
        sampler, u_d = sampler.next_2d()
        wi_w = warp.square_to_uniform_sphere(u_d)
        # flip to the outside hemisphere
        wi_w = torch.where(m.dot(wi_w, ng)[:, None] < 0, -wi_w, wi_w)
        s, t = m.coordinate_system(ng)
        n = p.shape[0]
        si = SurfaceInteraction(
            t=torch.ones((n,), dtype=m.Float, device=p.device),
            p=p, n=ng, sh_n=ng, sh_s=s, sh_t=t,
            uv=torch.zeros((n, 2), dtype=m.Float, device=p.device),
            wi=m.to_local(s, t, ng, wi_w),
            prim_idx=face.to(torch.int32),
            mat_id=g.face_mat[fl],
            emitter_id=g.face_emitter[fl],
        )
        return si, sampler

    # ---------------- specular walk ------------------------------------
    def next_smooth_si(self, scene, sampler, si, active):
        """Walk through delta lobes until a Smooth surface (4 steps, all
        of them run whatever the mask, so the sampler advances as in JAX)."""
        n = si.p.shape[0]
        f = torch.ones((n, 3), dtype=m.Float, device=si.p.device)
        for _ in range(4):
            flags = bsdflib.bsdf_flags(scene.materials, si.mat_id)
            delta_only = ~has_flag(flags, BSDFFlags.Smooth) & si.valid
            walk = active & delta_only
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, w = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, walk)
            ray = si.spawn_ray(si.to_world(bs.wo))
            si2 = ray_intersect(scene, ray, walk)
            si = twhere(walk, si2, si)
            f = torch.where(walk[:, None], f * w, f)
        return si, f, sampler

    # ---------------- RHS ------------------------------------------------
    def sample_rhs(self, scene, params, sampler, si, lo, extent):
        """One-bounce estimate at si: NEE+MIS + BSDF bounce into the field;
        M-fold fan-out then block mean."""
        M = self.m_rhs
        mats, tex = scene.materials, scene.textures
        si_r = trepeat(si, M)
        nM = si_r.p.shape[0]
        sampler_r = dataclasses.replace(
            sampler.fork(99), lane=torch.arange(nM, dtype=torch.int64, device=si.p.device)
        )

        L = eval_emitter(scene, si_r)

        # NEE
        sampler_r, u_em = sampler_r.next_2d()
        flags = bsdflib.bsdf_flags(mats, si_r.mat_id)
        active_em = has_flag(flags, BSDFFlags.Smooth) & si_r.valid
        ds, em_w = sample_emitter_direction(scene, si_r, u_em, True, active_em)
        wo_l = si_r.to_local(ds.d)
        f_em, pdf_em = bsdflib.eval_pdf(mats, tex, si_r, wo_l, active_em)
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_em))
        L = L + torch.where(active_em[:, None], f_em * em_w * mis_em[:, None], 0.0)

        # BSDF bounce -> field at next smooth si (+ MIS emitter hit)
        sampler_r, u1 = sampler_r.next_1d()
        sampler_r, u2 = sampler_r.next_2d()
        bs, bw = bsdflib.sample(mats, tex, si_r, u1, u2, si_r.valid)
        ray = si_r.spawn_ray(si_r.to_world(bs.wo))
        si2 = ray_intersect(scene, ray, si_r.valid)

        bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
        em_pdf = pdf_emitter_direction(scene, si_r, si2, ~bsdf_delta)
        mis_b = mis_weight(bs.pdf, em_pdf)
        L = L + torch.where(
            (si_r.valid & si2.valid)[:, None], bw * eval_emitter(scene, si2) * mis_b[:, None], 0.0
        )

        si2, f_spec, sampler_r = self.next_smooth_si(scene, sampler_r, si2, si_r.valid & si2.valid)
        p_norm = torch.clamp((si2.p - lo) / extent, 0.0, 1.0)
        L_field = field_eval(params, self.field_cfg, p_norm, si2.wi_world)
        # the field models outgoing radiance incl. emission, and emitters hit
        # by the bounce were MIS-added above: mask the field there
        field_ok = si2.valid & (si2.emitter_id < 0)
        L = L + torch.where(field_ok[:, None], bw * f_spec * L_field, 0.0)
        # trepeat is [a a b b ...]-ordered, so the M fan-out of sample k sits
        # in rows [k*M, (k+1)*M)
        return block_sum(L, M) / M

    # ---------------- training step --------------------------------------
    def make_train_step(self, scene):
        """Returns (init, step): init(generator) -> (field, optimizer) on the
        scene's device; step(field, optimizer, seed) runs one step in place
        and returns the step's loss (a detached 0-d tensor)."""
        area_dist = self.make_area_dist(scene)
        lo, extent = self.scene_bounds(scene)
        dev = scene.device

        def loss_fn(params, sampler):
            si, sampler = self.sample_surface(scene, area_dist, sampler)
            p_norm = torch.clamp((si.p - lo) / extent, 0.0, 1.0)
            lhs = field_eval(params, self.field_cfg, p_norm, si.wi_world)
            rhs = self.sample_rhs(scene, params, sampler, si, lo, extent)
            # residual: gradients flow through both sides
            return torch.mean((lhs - rhs) ** 2)

        def step(params, opt, seed):
            sampler = Sampler.create(
                seed, lane=torch.arange(self.batch_size, dtype=torch.int64, device=dev)
            )
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, sampler)
            loss.backward()
            opt.step()
            return loss.detach()

        def init(generator):
            params = init_field(generator, self.field_cfg, device=dev)
            return params, torch.optim.Adam(params.parameters(), lr=self.lr,
                                            betas=(0.9, 0.999), eps=1e-8)

        return init, step

    def train(self, scene, n_iters=200, seed=0, log_every=50):
        init, step = self.make_train_step(scene)
        params, opt = init(torch.Generator().manual_seed(seed))
        losses = []
        for i in range(n_iters):
            loss = step(params, opt, i)
            if (i + 1) % log_every == 0:
                losses.append(float(loss))
        return params, losses


@dataclasses.dataclass(frozen=True, eq=False)
class NeradIntegrator:
    """Render by querying the trained field at the first non-delta hit."""

    trainer: NeradTrainer
    params: Field = None

    @torch.no_grad()
    def sample(self, scene, sampler, ray, active=None):
        n = ray.o.shape[0]
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=ray.o.device)
        si = ray_intersect(scene, ray, active)
        si, f_spec, sampler = self.trainer.next_smooth_si(scene, sampler, si, active & si.valid)
        lo, extent = self.trainer.scene_bounds(scene)
        p_norm = torch.clamp((si.p - lo) / extent, 0.0, 1.0)
        L_field = field_eval(self.params, self.trainer.field_cfg, p_norm, si.wi_world)
        # emitters render their own radiance
        L_emit = eval_emitter(scene, si)
        use_field = si.valid & (si.emitter_id < 0)
        L = torch.where(use_field[:, None], f_spec * L_field, L_emit)
        return torch.clamp(L, min=0.0), si.valid, sampler


register_integrator("nerad", NeradIntegrator)
