"""Hero-wavelength spectral path tracer — Mitsuba's `*_spectral` variant.

Counterpart of ``mitsuba3_experiments_tpu.integrators.spectral`` (machinery
in core/spectrum.py):

  * each lane carries K=4 hero-rotated wavelengths; throughput and radiance
    are (N, K) tensors;
  * RGB scene data (every BSDF's sample weight, emitter radiance) upsamples
    to smooth spectra through a partition-of-unity band basis, exact for
    gray (furnace-safe);
  * the film accumulates CIE XYZ (Monte-Carlo CMF weights) and develops to
    linear sRGB.

BSDF-sampling-only transport, as SimpleIntegrator.  The JAX package's
`strict` flag and `check_scene` are not ported: the gate can never fire,
since every kind a scene holds lies in ``range(BSDFKind.COUNT)``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core import spectrum as sp
from ..core.rng import MASK32, Sampler
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter, eval_environment
from ..scene.types import Scene
from .common import register_integrator


@dataclasses.dataclass(frozen=True)
class SpectralIntegrator:
    max_depth: int = 8
    rr_depth: int = 4
    k: int = 4            # wavelengths per lane

    @torch.no_grad()
    def sample(self, scene: Scene, sampler: Sampler, ray, active=None):
        """Returns (xyz (N, 3), sampler): the CIE XYZ estimate per lane."""
        n = ray.o.shape[0]
        dev = ray.o.device
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=dev)

        sampler, u_lam = sampler.next_1d()
        lam, pdf = sp.sample_wavelengths(u_lam, self.k)   # (N, K)
        f = torch.ones((n, self.k), dtype=m.Float, device=dev)
        L = torch.zeros((n, self.k), dtype=m.Float, device=dev)

        si = ray_intersect(scene, ray, active)
        L = L + f * sp.upsample_rgb(eval_emitter(scene, si, active), lam)
        esc = active & ~si.valid
        L = L + f * sp.upsample_rgb(eval_environment(scene, esc, ray.d), lam)
        act = active & si.valid

        for depth in range(1, self.max_depth):
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, weight = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, act)
            # the spectral weight upsamples the RGB sample weight itself
            # (upsampling is linear in RGB; gray stays exactly constant)
            w_spec = sp.upsample_rgb(weight, lam)
            f = f * torch.where(act[:, None], w_spec, 1.0)

            # Russian roulette on the hero throughput
            fmax = torch.amax(f, dim=-1)
            rr_prob = torch.clamp(fmax, max=0.95)
            sampler, u_rr = sampler.next_1d()
            if depth >= self.rr_depth:
                f = f * m.safe_rcp(rr_prob)[:, None]
                act = act & (u_rr < rr_prob)
            act = act & (fmax > 0.0)

            ray = si.spawn_ray(si.to_world(bs.wo))
            si = ray_intersect(scene, ray, act)
            L = L + torch.where(act[:, None],
                                f * sp.upsample_rgb(eval_emitter(scene, si, act), lam), 0.0)
            esc = act & ~si.valid
            L = L + torch.where(esc[:, None],
                                f * sp.upsample_rgb(eval_environment(scene, esc, ray.d), lam), 0.0)
            act = act & si.valid

        # CIE XYZ Monte-Carlo estimate over the K wavelengths
        wxyz = sp.spectrum_to_xyz_weight(lam, pdf, self.k)  # (N, K, 3)
        return torch.sum(L[..., None] * wxyz, dim=1), sampler


register_integrator("spectral", SpectralIntegrator)


@torch.no_grad()
def render_spectral(scene: Scene, integrator=None, seed: int = 0, spp: int = 16,
                    chunk: int | None = None):
    """Full spectral render -> (H, W, 3) linear sRGB image (equal-energy
    white balance; see core/spectrum.py), camera ray i at pixel i // spp,
    in launches of `chunk` rays (default: all)."""
    integ = integrator or SpectralIntegrator()
    w, h = scene.camera.resolution
    dev = scene.device
    n = w * h * spp
    film = filmlib.new_film(w, h, device=dev)
    c = chunk or n
    for off in range(0, n, c):
        idx = off + torch.arange(c, dtype=torch.int64, device=dev)
        valid = idx < n
        pix = idx // spp
        px = (pix % w).to(m.Float)
        py = (pix // w).to(m.Float)
        sampler = Sampler.create(seed, lane=idx & MASK32)
        sampler, jit2 = sampler.next_2d()
        pos = torch.stack([px, py], dim=-1) + jit2
        ray = sensorlib.sample_ray(scene.camera, pos)
        xyz, _ = integ.sample(scene, sampler, ray, valid)
        filmlib.put(film, pos, torch.where(torch.isfinite(xyz), xyz, 0.0), active=valid,
                    rfilter="box")
    return torch.clamp(sp.xyz_to_srgb(filmlib.develop(film)), min=0.0)
