"""Production forward renderer: a bounce-synchronous wavefront around K1.

Counterpart of ``mitsuba3_experiments_tpu.integrators.persistent``, which
renders with a persistent per-lane state machine built for the TPU
(incremental traversal steps, lane refill, a shift-register stack, idle-lane
spreading).  The port keeps what that machine computes and gives it a
Hopper schedule instead:

  * camera rays go in batches of at most `n_lanes`;
  * each bounce of a batch is one closest-hit launch of the traversal
    kernel (K1, csrc/bvh_traverse.cu) over the live lanes, then the shading
    (emission with MIS, the NEE sample, the BSDF sample, Russian roulette:
    one launch of K6, csrc/shade_wavefront.cu, on the card; its plain
    version `_shade` on the CPU), then one any-hit launch over the lanes
    whose NEE is active;
  * the bounce commits, the finished rays write their radiance into a
    deferred per-ray buffer `rayL` at their camera-ray index, and the live
    lanes are compacted, so the next launch covers only survivors;
  * one `splat_deferred` turns `rayL` into the film at the end.

Every draw is `_rand(seed, camera-ray index, dimension)` with the JAX
package's dimensions, so a ray's radiance does not depend on its batch or
its compaction slot, and equals `render()`'s for the same key.

Not ported (TPU scheduling): ``PersistentState``, ``_engine_step``,
``_trav_steps``, ``idle_spread``, ``_start_traversal``, ``_poll``,
``unify_tables`` and the arguments ``steps``, ``rounds_per_launch`` and
``stepper``.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..core import math as m
from ..core.records import BSDFFlags, Ray, has_flag
from ..intersect.bvh_torch import _make_si, _query
from ..render import bsdf as bsdflib
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..render.emitter import (
    eval_emitter,
    eval_environment,
    pdf_emitter_direction_packed,
    pdf_environment_direction,
    sample_emitter_direction,
)
from ..scene.types import Scene
from ..utils.profile import count, span, spanned
from . import shade_cuda
from .common import mis_weight
from .wavefront import _rand

# camera rays per batch: a batch fills the card and bounds the wavefront's
# memory (the lockstep render's 1,843,200-lane pass peaks near 5.3 GB)
N_LANES = 1 << 21


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


@spanned("m3t.splat")
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


@spanned("m3t.shade")
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


def _masked(x, mask):
    """x[mask]: a boolean-mask read, which waits for the device."""
    with span("m3t.wait"):
        return x[mask]


@torch.no_grad()
def trace_rays(scene: Scene, seed, idx0: int, n_rows: int, n_valid: int, *, spp: int,
               max_depth: int, rr_depth: int, n_lanes: int = N_LANES, rec=None):
    """The wavefront over camera rays idx0 .. idx0 + n_valid; returns the
    (n_rows, 3) per-ray radiance (row r = ray idx0 + r, non-finite values
    zeroed, rows past n_valid zero).  With `rec` (a PathRecord of n_rows
    rows) it also writes each closest hit's (prim, u, v) and each shadow
    ray's occlusion bit at (row, depth - 1)."""
    dev = scene.device
    rayL = torch.zeros((n_rows, 3), dtype=m.Float, device=dev)
    kw = dict(max_depth=max_depth, rr_depth=rr_depth)
    # the card shades with K6, its scene packed once for the call
    packed = shade_cuda.pack_scene(scene, seed, **kw) if dev.type == "cuda" and n_valid > 0 \
        else None
    for start in range(0, n_valid, n_lanes):
        with span("m3t.record.batch"):
            row = torch.arange(start, min(start + n_lanes, n_valid), dtype=torch.int64,
                               device=dev)
            idx = row + int(idx0)
            ray = sensorlib.sample_ray(scene.camera, ray_positions(scene.camera, seed, idx, spp))
            n = row.shape[0]
            o, d = ray.o.contiguous(), ray.d   # o: the camera origin, expanded
            L = torch.zeros((n, 3), dtype=m.Float, device=dev)
            f = torch.ones((n, 3), dtype=m.Float, device=dev)
            eta = torch.ones((n,), dtype=m.Float, device=dev)
            depth = torch.ones((n,), dtype=torch.int32, device=dev)
            prev_p, prev_pdf = o, torch.ones((n,), dtype=m.Float, device=dev)
            prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
            while n:
                with span("m3t.bounce"):
                    # one traversal launch over every live ray (K1 on the card)
                    every = torch.ones((n,), dtype=torch.bool, device=dev)
                    t, face, u, v = _query(scene, Ray.make(o, d), every, False)
                    col = depth.long() - 1
                    if rec is not None:
                        hit = face >= 0
                        rec.prim[row, col] = face
                        rec.u[row, col] = torch.where(hit, u, 0.0)
                        rec.v[row, col] = torch.where(hit, v, 0.0)
                    count("m3t.shade.lanes", n)
                    if packed is None:
                        sh = _shade(scene, seed, every, o, d, t, face, u, v, L, f, eta, depth,
                                    prev_p, prev_pdf, prev_delta, idx, **kw)
                    else:
                        sh = shade_cuda.shade(packed, d, t, face, u, v, L, f, eta, depth, prev_p,
                                              prev_pdf, prev_delta, idx)
                    with span("m3t.wait"):
                        em = torch.nonzero(sh.active_em).squeeze(1)
                    unoccluded = sh.active_em.clone()
                    if em.numel():
                        shadow = Ray(o=sh.shadow_o[em], d=sh.shadow_d[em], maxt=sh.shadow_maxt[em])
                        _, occ_face, _, _ = _query(scene, shadow, every[:em.numel()], True)
                        occluded = occ_face >= 0
                        unoccluded[em] = ~occluded
                        if rec is not None:
                            rec.occl[row[em], col[em]] = occluded
                    with span("m3t.compact"):
                        L = sh.L + torch.where(unoccluded[:, None], sh.nee_L, 0.0)

                        done = ~sh.cont
                        rayL[_masked(row, done)] = torch.where(
                            torch.isfinite(_masked(L, done)), _masked(L, done), 0.0)
                        with span("m3t.wait"):
                            keep = torch.nonzero(sh.cont).squeeze(1)
                        n = keep.numel()
                        row, idx, L = row[keep], idx[keep], L[keep]
                        o, d = sh.next_o[keep], sh.next_d[keep]
                        f, eta, depth = sh.f[keep], sh.eta[keep], depth[keep] + 1
                        prev_p, prev_pdf, prev_delta = sh.p[keep], sh.pdf[keep], sh.delta[keep]
    return rayL


@torch.no_grad()
def render_persistent(scene: Scene, seed: int = 0, spp: int = 16, max_depth: int = 16,
                      rr_depth: int = 4, rfilter: str = "box", n_lanes: int = N_LANES):
    """Full-frame render -> (H, W, 3) image on the scene's device: the
    camera rays 0 .. W*H*spp (ray i: pixel i // spp) through the wavefront
    in batches of at most `n_lanes`, then one deferred splat."""
    w, h = scene.camera.resolution
    n_total = w * h * spp
    rayL = trace_rays(scene, seed, 0, n_total, n_total, spp=spp, max_depth=max_depth,
                      rr_depth=rr_depth, n_lanes=n_lanes)
    film = splat_deferred(scene.camera, seed, rayL, 0, n_total, spp=spp, rfilter=rfilter,
                          w=w, h=h)
    return filmlib.develop(film)
