"""Integrator protocol + render driver (counterpart of
``mitsuba3_experiments_tpu.integrators.common``).

An integrator is a config dataclass with a `sample(scene, sampler, ray,
active) -> (L, valid, sampler)` method; `render` loops passes (and optional
fixed-size lane chunks) on the host and splats every pass into one film.
The film's in-place splat carries the gradient of a differentiable
integrator's radiance to the developed image.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.rng import MASK32, Sampler
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..scene.types import Scene


_REGISTRY: dict[str, type] = {}


def register_integrator(name: str, cls):
    """mi.register_integrator analog: make_integrator({'type': name})
    builds cls."""
    _REGISTRY[name] = cls
    return cls


def make_integrator(props: dict):
    """mi.load_dict({'type': name, ...}) analog for integrators; keys that
    are not fields of the integrator are ignored."""
    props = dict(props)
    cls = _REGISTRY[props.pop("type")]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in props.items() if k in fields})


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2), 0 where not finite; carries no gradient,
    as in the JAX package."""
    a2 = pdf_a * pdf_a
    w = m.safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0).detach()


def render_pass(scene: Scene, integrator, seed, pass_idx, film,
                spp_per_pass: int = 1, rfilter: str = "box",
                chunk: int | None = None, lane_offset=0):
    """One wavefront: `chunk` camera rays starting at `lane_offset` (default:
    the whole W*H*spp_per_pass wavefront) -> film splats (in place; the film
    is also returned).  Autograd records the pass only where the
    integrator's radiance carries a gradient (a differentiable integrator
    on a scene whose tables require one)."""
    w, h = scene.camera.resolution
    n = w * h * spp_per_pass
    if chunk is None:
        chunk = n
    dev = scene.device
    lane = torch.arange(chunk, dtype=torch.int64, device=dev) + int(lane_offset)
    in_range = lane < n
    pix = lane // spp_per_pass
    px = (pix % w).to(m.Float)
    py = (pix // w).to(m.Float)

    sampler = Sampler.create(seed, lane=(lane + n * int(pass_idx)) & MASK32)
    sampler, jitter = sampler.next_2d()
    pos = torch.stack([px, py], dim=-1) + jitter

    ray = sensorlib.sample_ray(scene.camera, pos)
    L, valid, sampler = integrator.sample(scene, sampler, ray, in_range)
    L = torch.where(torch.isfinite(L), L, 0.0)
    return filmlib.put(film, pos, L, active=in_range, rfilter=rfilter)


def split_passes(w: int, h: int, spp: int, spp_per_pass: int | None = None):
    """(samples per pass, passes) of a render of `spp` samples: by default
    as many per pass as keep the wavefront around <= 2^21 lanes, lowered
    to a divisor of spp."""
    if spp_per_pass is None:
        spp_per_pass = max(1, min(spp, (1 << 21) // max(w * h, 1)))
    while spp % spp_per_pass:
        spp_per_pass -= 1
    return spp_per_pass, spp // spp_per_pass


def render(scene: Scene, integrator, seed: int = 0, spp: int = 16,
           rfilter: str | None = None, spp_per_pass: int | None = None,
           chunk: int | None = None):
    """Full render -> (H, W, 3) image on the scene's device."""
    w, h = scene.camera.resolution
    spp_per_pass, n_passes = split_passes(w, h, spp, spp_per_pass)
    rfilter = rfilter or "box"
    n = w * h * spp_per_pass

    film = filmlib.new_film(w, h, device=scene.device)
    for p in range(n_passes):
        offsets = [0] if chunk is None else range(0, n, chunk)
        for off in offsets:
            render_pass(
                scene, integrator, seed, p, film, spp_per_pass=spp_per_pass,
                rfilter=rfilter, chunk=chunk, lane_offset=off,
            )
    return filmlib.develop(film)
