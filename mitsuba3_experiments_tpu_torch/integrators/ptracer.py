"""Adjoint particle tracer: light paths splatted onto the film.

Counterpart of ``mitsuba3_experiments_tpu.integrators.ptracer``: emitter-ray
walks (render/emitter.py::sample_emitter_ray) whose vertices are connected
to the camera with a visibility ray and splatted through
sensor.sample_direction — the adjoint of the camera path tracer.  Estimator:

  E[ splat ] = Le * cos / p_ray  *  f(wi->wc) / cos_at_vertex
               * G_cam(visibility, pixel-solid-angle importance)

The camera importance of a pinhole camera with a W x H film is
W_e = dist^2 / (A_pix(dir) cos^3 theta_c) per unit film area.  Splats are
an ``index_add_`` into the film, atomic on the card, so the card and the
CPU agree to float rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.rng import MASK32, Sampler
from ..intersect import ray_intersect, ray_test
from ..render import bsdf as bsdflib
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..render.emitter import sample_emitter_ray
from ..scene.types import Scene
from .common import register_integrator, render_pass
from .path import PathIntegrator


@dataclasses.dataclass(frozen=True)
class ParticleTracer:
    max_depth: int = 8
    rr_depth: int = 4

    @torch.no_grad()
    def trace_and_splat(self, scene, sampler, film, n_paths: int):
        """Trace n_paths light paths; splat every vertex->camera connection
        into `film` (in place).  Returns (film, sampler)."""
        w, h = scene.camera.resolution
        cam = scene.camera
        cam_pos = cam.to_world[:3, 3]
        # the viewing axis, and the film's pixel area at unit distance
        cam_dir = m.normalize(m.transform_vector(
            cam.to_world, torch.tensor([0.0, 0.0, 1.0], dtype=m.Float, device=cam_pos.device)))
        tx, ty = cam.tan_half_fov[0], cam.tan_half_fov[1]
        a_pix = (2.0 * tx / w) * (2.0 * ty / h)

        sampler, u_pos = sampler.next_2d()
        sampler, u_dir = sampler.next_2d()
        ray, f, _ = sample_emitter_ray(scene, u_pos, u_dir)   # f = Le * pi / p_area

        def connect(si, f_val, active):
            """Splat f_val * brdf(wi->camera) * importance to the film."""
            d_un = cam_pos[None, :] - si.p
            dist2 = m.squared_norm(d_un)
            d = d_un * m.safe_rcp(torch.sqrt(dist2))[:, None]

            pos_film, _, in_view = sensorlib.sample_direction(cam, si.p)
            ok = active & in_view & si.valid
            shadow = si.spawn_ray_to(cam_pos.expand(si.p.shape))
            ok = ok & ~ray_test(scene, shadow, ok)

            f_bsdf, _ = bsdflib.eval_pdf(scene.materials, scene.textures, si, si.to_local(d), ok)
            # pinhole importance per pixel: W = dist^2 / (cos^3 theta_c * A_pix),
            # times the 1/dist^2 of the vertex-camera coupling
            cos_c = torch.clamp(m.dot(-d, cam_dir[None, :]), 1e-6, 1.0)
            importance = m.safe_div(1.0, (cos_c**3) * a_pix * dist2)
            contrib = f_val * f_bsdf * importance[:, None]
            contrib = torch.where(torch.isfinite(contrib) & ok[:, None], contrib, 0.0)
            filmlib.put(film, pos_film, contrib, ok, rfilter="box")

        si = ray_intersect(scene, ray)
        active = si.valid
        for depth in range(self.max_depth):
            connect(si, f, active)
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, bw = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, active)
            f = f * bw
            fmax = m.max_component(f)
            sampler, u_rr = sampler.next_1d()
            if depth >= self.rr_depth:
                prob = torch.clamp(fmax, max=0.95)
                f = f * m.safe_rcp(prob)[:, None]
                active = active & (u_rr < prob)
            ray = si.spawn_ray(si.to_world(bs.wo))
            si = ray_intersect(scene, ray, active)
            active = active & si.valid & (fmax > 0.0)
        return film, sampler

    def render(self, scene: Scene, seed: int = 0, spp: int = 16):
        """spp = light paths per pixel (W*H*spp paths in passes of at most
        2^18).  The integer division of the pass count drops the remainder
        paths, as the JAX package does; the image divides by the paths
        traced, so the estimate stays unbiased."""
        w, h = scene.camera.resolution
        dev = scene.device
        n_paths_total = w * h * spp
        chunk = min(n_paths_total, 1 << 18)
        film = filmlib.new_film(w, h, device=dev)
        n_passes = max(n_paths_total // chunk, 1)
        lane = torch.arange(chunk, dtype=torch.int64, device=dev)
        for p in range(n_passes):
            sampler = Sampler.create((seed * 7919 + p) & MASK32, lane=lane)
            self.trace_and_splat(scene, sampler, film, chunk)
        # radiance estimate: sum of splats / paths traced
        img = film[..., :3] / (n_passes * chunk)
        # the camera connections never reach emitters seen directly (a delta
        # sensor against an area emitter needs the camera-side technique):
        # add the directly visible emission
        direct = filmlib.new_film(w, h, device=dev)
        render_pass(scene, PathIntegrator(max_depth=1), seed, 0, direct, spp_per_pass=1,
                    rfilter="box")
        return img + filmlib.develop(direct)


register_integrator("ptracer", ParticleTracer)
