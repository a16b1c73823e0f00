# Frozen copy, at commit aa7dcd9, of the port's per-ray shading of one bounce and its helpers:
# mitsuba3_experiments_tpu_torch/integrators/wavefront.py (_rand), integrators/common.py
# (mis_weight), intersect/bvh_torch.py (_const3, _make_si) and integrators/persistent.py
# (_tile_dims, ray_pixel, ray_positions, splat_deferred, _shade).  Part of the benchmark's
# plain reference; imported from benchmark/reference only, never from the port.
"""The forward's shading of a closest hit and the draws it keys, as the port's
CPU path computes them."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from .core import math as m
from .core.records import BSDFFlags, Ray, SurfaceInteraction, has_flag
from .core.rng import MASK32, pcg_hash, tea32, uint_to_float01
from .render import bsdf as bsdflib
from .render import film as filmlib
from .render import sensor as sensorlib  # noqa: F401
from .render.emitter import (
    eval_emitter,
    eval_environment,
    pdf_emitter_direction_packed,
    pdf_environment_direction,
    sample_emitter_direction,
)
from .scene.types import Scene


def _rand(seed, idx, dim, n_draw: int):
    """Uniforms with a per-lane dimension counter: draw k of lane `idx` is
    keyed by dimension `dim + k`, the same construction as
    core.rng.Sampler._draw_bits, so a ray at surface depth d draws the bits
    the lockstep sampler draws for it.  `seed`, `idx` and `dim` are Python
    ints or int64 tensors of uint32 values.  Returns (N,) for one draw,
    else (N, n_draw)."""
    seed = seed & MASK32
    idx = idx & MASK32
    outs = []
    for k in range(n_draw):
        k0, k1 = tea32(seed, dim + k)
        outs.append(uint_to_float01(pcg_hash(pcg_hash(idx ^ k0) + k1)))
    return outs[0] if n_draw == 1 else torch.stack(outs, dim=-1)


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2), 0 where not finite; carries no gradient,
    as in the JAX package."""
    a2 = pdf_a * pdf_a
    w = m.safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0).detach()


def _const3(v, like):
    return torch.tensor(v, dtype=m.Float, device=like.device)


def _make_si(scene: Scene, ray: Ray, t, face, u, v, return_row: bool = False):
    """Assemble the SurfaceInteraction from a hit (global face id): one row
    fetch from Geometry.face_packed.

    A lane without a hit fetches row `lane % F` (its fields are discarded),
    as in the JAX package, so that misses do not all read one row.
    `return_row=True` also returns the fetched (N, 32) row, whose columns
    27 (emitter pmf) and 28 (area) feed pdf_emitter_direction_packed."""
    g = scene.geometry
    valid = face >= 0
    spread = torch.arange(face.shape[0], device=face.device) % g.face_packed.shape[0]
    row = g.face_packed[torch.where(valid, face.long(), spread)]     # (N, 32)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    p = v0 + e1 * u[:, None] + v[:, None] * e2
    ng = m.normalize(m.cross(e1, e2))

    flat = row[:, 24] > 0.5
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    ns = m.normalize(n0 * (1.0 - u - v)[:, None] + n1 * u[:, None] + n2 * v[:, None])
    ns = torch.where(flat[:, None], ng, ns)
    # keep the shading normal in the hemisphere of the geometric one
    ns = torch.where(m.dot(ns, ng)[:, None] < 0.0, -ns, ns)

    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    uv = uv0 * (1.0 - u - v)[:, None] + uv1 * u[:, None] + uv2 * v[:, None]

    sh_s, sh_t = m.coordinate_system(ns)
    wi = m.to_local(sh_s, sh_t, ns, -ray.d)

    mat_id = row[:, 25].contiguous().view(torch.int32)
    emitter_id = row[:, 26].contiguous().view(torch.int32)

    inval = (~valid)[:, None]
    z, x, y = _const3((0.0, 0.0, 1.0), t), _const3((1.0, 0.0, 0.0), t), _const3((0.0, 1.0, 0.0), t)
    si = SurfaceInteraction(
        t=torch.where(valid, t, m.INF),
        p=torch.where(inval, 0.0, p),
        n=torch.where(inval, z, ng),
        sh_n=torch.where(inval, z, ns),
        sh_s=torch.where(inval, x, sh_s),
        sh_t=torch.where(inval, y, sh_t),
        uv=torch.where(inval, 0.0, uv),
        wi=torch.where(inval, z, wi),
        prim_idx=torch.where(valid, face, -1).to(torch.int32),
        mat_id=torch.where(valid, mat_id, -1).to(torch.int32),
        emitter_id=torch.where(valid, emitter_id, -1).to(torch.int32),
    )
    return (si, row) if return_row else si


def _tile_dims(w: int, h: int):
    """Largest tile sides <= 128 that divide the image."""
    tw = next(t for t in range(min(128, w), 0, -1) if w % t == 0)
    th = next(t for t in range(min(128, h), 0, -1) if h % t == 0)
    return tw, th


def ray_pixel(camera, pix, order: str = "row"):
    """(px, py) float32 of linear pixel ranks `pix` (int64): 'row' is the
    reference's row-major order, 'tile' numbers pixels tile by tile (tiles
    of up to 128x128 that divide the image)."""
    w, h = camera.resolution
    if order == "tile":
        tw, th = _tile_dims(w, h)
        per_tile = tw * th
        tiles_x = w // tw
        tile = pix // per_tile
        r = pix % per_tile
        px = (tile % tiles_x) * tw + r % tw
        py = (tile // tiles_x) * th + r // tw
        return px.to(m.Float), py.to(m.Float)
    if order != "row":
        raise ValueError(f"unknown ray order {order!r}")
    return (pix % w).to(m.Float), (pix // w).to(m.Float)


def ray_positions(camera, seed, idx, spp: int):
    """Film position of camera ray `idx` (int64): its pixel corner plus the
    jitter of dimensions 0 and 1."""
    px, py = ray_pixel(camera, idx // spp)
    jitter = _rand(seed, idx, torch.zeros_like(idx), 2)
    return torch.stack([px, py], dim=-1) + jitter


def splat_deferred(camera, seed, rayL, idx0, n_valid, *, spp: int, rfilter: str,
                   w: int, h: int):
    """One filter splat of a deferred per-ray radiance buffer (row r =
    camera ray idx0 + r), gated to its first n_valid rows; returns the
    (h, w, 4) film (RGB + filter weight)."""
    n = rayL.shape[0]
    row = torch.arange(n, dtype=torch.int64, device=rayL.device)
    pos = ray_positions(camera, seed, row + int(idx0), spp)
    film = filmlib.new_film(w, h, device=rayL.device)
    return filmlib.put(film, pos, rayL, active=row < int(n_valid), rfilter=rfilter)


def _shade(scene: Scene, seed, doneA, hit_o, hit_d, hit_t, hit_face, hit_u, hit_v,
           L, f, eta, depth, prev_p, prev_pdf, prev_delta, idx, *, max_depth: int,
           rr_depth: int):
    """Shading of finished closest hits, exactly as the JAX package's
    `_shade`: emission at the hit (MIS against the NEE that could have
    sampled it), the NEE sample, the BSDF sample, Russian roulette.  The
    draws of surface depth d start at dimension 2 + 6 (d - 1).  Returns the
    post-shade fields; the caller commits them.  `nee_L` is the NEE
    contribution before the shadow test: the forward adds it where the
    shadow ray is unoccluded, the replay where the record says so."""
    mats, tex = scene.materials, scene.textures

    ray = Ray.make(hit_o, hit_d)
    t_out = torch.where(hit_face >= 0, hit_t, m.INF)
    si, si_row = _make_si(scene, ray, t_out, hit_face, hit_u, hit_v, return_row=True)
    hit = doneA & si.valid

    # ---------------- emission at the hit (ray-first MIS) ----------------
    ref = SimpleNamespace(p=prev_p)
    gate = doneA & (prev_pdf > 0.0)
    em_pdf = pdf_emitter_direction_packed(scene, ref, si, si_row[:, 27], si_row[:, 28],
                                          gate & ~prev_delta)
    mis_hit = torch.where(prev_delta, 1.0, mis_weight(prev_pdf, em_pdf))
    L = L + torch.where((gate & hit)[:, None],
                        f * eval_emitter(scene, si, hit) * mis_hit[:, None], 0.0)
    esc = doneA & ~si.valid & (prev_pdf > 0.0)
    env_pdf = pdf_environment_direction(scene, hit_d, esc & ~prev_delta)
    mis_env = torch.where(prev_delta, 1.0, mis_weight(prev_pdf, env_pdf))
    L = L + torch.where(esc[:, None],
                        f * eval_environment(scene, esc, hit_d) * mis_env[:, None], 0.0)

    # ------------------------- NEE at the surface ------------------------
    cont = hit & (depth < max_depth)
    base = 2 + 6 * (depth.to(torch.int64) - 1)
    flags = bsdflib.bsdf_flags(mats, si.mat_id)
    active_em = cont & has_flag(flags, BSDFFlags.Smooth)

    u_em = _rand(seed, idx, base, 2)
    ds, em_weight = sample_emitter_direction(scene, si, u_em, False, active_em)
    active_em = active_em & (ds.pdf != 0.0)
    wo = si.to_local(ds.d)

    u1 = _rand(seed, idx, base + 2, 1)
    u2 = _rand(seed, idx, base + 3, 2)
    bsdf_val, bsdf_pdf, bs, bsdf_weight = bsdflib.eval_pdf_sample(mats, tex, si, wo, u1, u2,
                                                                  cont)
    mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
    nee_L = torch.where(active_em[:, None], f * bsdf_val * em_weight * mis_em[:, None], 0.0)

    # ------------------- BSDF bounce + Russian roulette ------------------
    f2 = f * bsdf_weight
    eta2 = eta * bs.eta
    # the RR decision and its reweighting carry no gradient (the replay
    # differentiates this function; under no_grad the detaches do nothing)
    fmax = m.max_component(f2).detach()
    rr_prob = torch.clamp(fmax * eta2 * eta2, max=0.95).detach()
    rr_active = depth >= rr_depth
    u_rr = _rand(seed, idx, base + 5, 1)
    rr_continue = u_rr < rr_prob
    f2 = torch.where(rr_active[:, None], f2 * m.safe_rcp(rr_prob)[:, None], f2)
    cont2 = cont & (fmax != 0.0) & (~rr_active | rr_continue)
    ray2 = si.spawn_ray(si.to_world(bs.wo))
    shadow = si.spawn_ray_to(ds.p)

    return SimpleNamespace(
        L=L, f=f2, eta=eta2, p=si.p, pdf=bs.pdf,
        delta=has_flag(bs.sampled_type, BSDFFlags.Delta),
        nee_L=nee_L, next_o=ray2.o, next_d=ray2.d, cont=cont2,
        shadow_o=shadow.o, shadow_d=shadow.d, shadow_maxt=shadow.maxt,
        active_em=active_em,
    )
