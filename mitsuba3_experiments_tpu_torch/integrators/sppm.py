"""Stochastic progressive photon mapping.

Counterpart of ``mitsuba3_experiments_tpu.integrators.sppm``: the camera
pass collects visible points through a walk over delta interactions only,
the sort-based hash grid of ops/hashgrid.py buckets them, and emitter-ray
photon walks deposit flux onto the visible points near each photon, with
the standard SPPM radius / flux update (Hachisuka & Jensen 2009,
alpha=2/3).  The flux deposit is an ``index_add_``, atomic on the card, so
the card and the CPU agree to float rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.records import BSDFFlags, has_flag
from ..core.rng import Sampler
from ..core.struct import twhere
from ..intersect import ray_intersect
from ..ops.hashgrid import HashGrid
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter, sample_emitter_ray
from .common import register_integrator

ALPHA = 2.0 / 3.0


@dataclasses.dataclass(frozen=True)
class SPPMState:
    radius2: torch.Tensor    # (N,) current search radius^2 per pixel
    n_photons: torch.Tensor  # (N,) accumulated photon count (tau N)
    tau: torch.Tensor        # (N, 3) accumulated (normalized) flux
    direct: torch.Tensor     # (N, 3) accumulated direct + emitted radiance
    frames: torch.Tensor     # () int32


@dataclasses.dataclass(frozen=True)
class SPPM:
    max_depth: int = 8
    photon_count: int = 1 << 16
    initial_radius: float = 0.05
    max_per_cell: int = 32
    grid_cells: int = 1 << 16

    def init_state(self, scene) -> SPPMState:
        w, h = scene.camera.resolution
        n = w * h
        f32 = dict(dtype=m.Float, device=scene.device)
        return SPPMState(
            radius2=torch.full((n,), self.initial_radius**2, **f32),
            n_photons=torch.zeros((n,), **f32),
            tau=torch.zeros((n, 3), **f32),
            direct=torch.zeros((n, 3), **f32),
            frames=torch.zeros((), dtype=torch.int32, device=scene.device),
        )

    # ------------------------------------------------------------------
    def sample_visible_point(self, scene, sampler, ray):
        """Walk through delta interactions only (4 steps); the first smooth
        (diffuse or glossy) surface is the visible point."""
        n = ray.o.shape[0]
        dev = ray.o.device
        f = torch.ones((n, 3), dtype=m.Float, device=dev)
        si = ray_intersect(scene, ray)
        L_direct = eval_emitter(scene, si)
        walking = torch.ones((n,), dtype=torch.bool, device=dev)
        si_vp = si
        for _ in range(4):
            smooth = has_flag(bsdflib.bsdf_flags(scene.materials, si.mat_id),
                              BSDFFlags.Smooth) & si.valid
            # lanes that just arrived at a smooth surface store their point
            si_vp = twhere(walking & smooth, si, si_vp)
            walking = walking & ~smooth & si.valid
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, w = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, walking)
            f = torch.where(walking[:, None], f * w, f)
            si = ray_intersect(scene, si.spawn_ray(si.to_world(bs.wo)), walking)
            L_direct = L_direct + torch.where(walking[:, None],
                                              f * eval_emitter(scene, si, walking), 0.0)
        vp_valid = si_vp.valid & has_flag(bsdflib.bsdf_flags(scene.materials, si_vp.mat_id),
                                          BSDFFlags.Smooth)
        return si_vp, f, L_direct, vp_valid, sampler

    # ------------------------------------------------------------------
    def photon_pass(self, scene, sampler, vp_si, vp_beta, vp_valid, radius2):
        """Trace photons; deposit their flux on the visible points within
        each point's radius.  Returns (tau_add (N, 3), count_add (N,))."""
        npho = self.photon_count
        dev = vp_si.p.device
        psampler = dataclasses.replace(
            sampler.fork(777), lane=torch.arange(npho, dtype=torch.int64, device=dev))
        psampler, u_pos = psampler.next_2d()
        psampler, u_dir = psampler.next_2d()
        ray, power, _ = sample_emitter_ray(scene, u_pos, u_dir)
        power = power / npho

        n_vp = vp_si.p.shape[0]
        max_r = torch.sqrt(torch.amax(torch.where(vp_valid, radius2, 0.0)))
        cell = torch.clamp(2.0 * max_r, min=1e-4)   # build_expanded's contract
        vp_pos = torch.where(vp_valid[:, None], vp_si.p, 1e10)
        grid = HashGrid.build_expanded(vp_pos, torch.sqrt(radius2), cell, self.grid_cells)

        # one spare row takes the taps that deposit nothing
        tau_add = torch.zeros((n_vp + 1, 3), dtype=m.Float, device=dev)
        count_add = torch.zeros((n_vp + 1,), dtype=m.Float, device=dev)
        active = torch.ones((npho,), dtype=torch.bool, device=dev)
        for _ in range(self.max_depth):
            si = ray_intersect(scene, ray, active)
            active = active & si.valid

            # deposit: the visible points of the photon's cell within their
            # radius (the grid holds each point in every cell its ball
            # overlaps, so one cell lookup finds them all)
            neigh = grid.gather_neighbors(si.p, self.max_per_cell)      # (P, K)
            ok = (neigh >= 0) & active[:, None]
            vps = torch.clamp(neigh, min=0).long()
            d2 = m.squared_norm(si.p[:, None, :] - vp_pos[vps])
            ok = ok & (d2 <= radius2[vps])
            flat = torch.where(ok, vps, n_vp).reshape(-1)
            contrib = power[:, None, :].expand(ok.shape + (3,)).reshape(-1, 3)
            tau_add.index_add_(0, flat, torch.where(ok.reshape(-1, 1), contrib, 0.0))
            count_add.index_add_(0, flat, ok.reshape(-1).to(m.Float))

            psampler, u1 = psampler.next_1d()
            psampler, u2 = psampler.next_2d()
            bs, w = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, active)
            power = power * w
            ray = si.spawn_ray(si.to_world(bs.wo))
            psampler, u_rr = psampler.next_1d()
            pmax = m.max_component(w)
            keep = u_rr < torch.clamp(pmax, max=0.95)
            power = power * m.safe_rcp(torch.clamp(torch.clamp(pmax, min=1e-6), max=0.95))[:, None]
            active = active & keep & (pmax > 0)
        return tau_add[:n_vp], count_add[:n_vp]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_frame(self, scene, state: SPPMState, seed):
        """One SPPM iteration: camera pass + photon pass + radius update.
        Returns (image (H, W, 3), state)."""
        w, h = scene.camera.resolution
        n = w * h
        dev = scene.device
        pix = torch.arange(n, dtype=torch.int64, device=dev)
        sampler = Sampler.create(seed, lane=pix)
        sampler, jitter = sampler.next_2d()
        pos = torch.stack([(pix % w).to(m.Float), (pix // w).to(m.Float)], dim=-1) + jitter
        ray = sensorlib.sample_ray(scene.camera, pos)

        vp_si, vp_beta, L_direct, vp_valid, sampler = self.sample_visible_point(
            scene, sampler, ray)
        tau_add, count_add = self.photon_pass(scene, sampler, vp_si, vp_beta, vp_valid,
                                              state.radius2)
        # the visible point's BSDF applied to the gathered flux: eval with
        # wo = +n (cos = 1) gives rho/pi for a Lambertian surface
        up = torch.tensor([[0.0, 0.0, 1.0]], dtype=m.Float, device=dev).expand(n, 3)
        f_vp, _ = bsdflib.eval_pdf(scene.materials, scene.textures, vp_si, up, vp_valid)
        tau_add = tau_add * vp_beta * f_vp

        # progressive radius / flux update (Hachisuka 2009)
        N = state.n_photons
        Mn = count_add
        shrink = m.safe_div(N + ALPHA * Mn, N + Mn, fill=1.0)
        radius2 = torch.where(Mn > 0, state.radius2 * shrink, state.radius2)
        tau = torch.where(Mn[:, None] > 0, (state.tau + tau_add) * shrink[:, None], state.tau)
        n_photons = N + ALPHA * Mn
        direct = state.direct + L_direct
        frames = state.frames + 1

        # estimate: direct/frames + tau / (pi r^2 * frames) (the photon power
        # is already divided by the photons per pass)
        fr = frames.to(m.Float)
        img = direct / fr + m.safe_div(tau, (m.PI * radius2 * fr)[:, None])
        return img.reshape(h, w, 3), SPPMState(radius2=radius2, n_photons=n_photons, tau=tau,
                                               direct=direct, frames=frames)


register_integrator("sppm", SPPM)
