# Frozen copy of mitsuba3_experiments_tpu_torch/render/emitter.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Area and environment emitters: evaluation, next-event estimation
sampling, MIS pdfs, light rays.  Counterpart of
``mitsuba3_experiments_tpu.render.emitter``.

Emissive geometry is flattened to a global set of emissive faces with a
power-weighted discrete distribution (scene/types.py EmitterTable); direction
sampling = face pick + uniform triangle point, converted to solid angle.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core import warp
from ..core.records import DirectionSample, Ray
from ..scene.types import Scene


def _has_env_map(em) -> bool:
    return tuple(em.env_map.shape[:2]) != (1, 1)


def eval_emitter(scene: Scene, si, active=None):
    """Radiance of the emitter at si towards the viewer: area lights emit
    from their front (geometric normal) side only."""
    has_em = si.emitter_id >= 0
    if active is not None:
        has_em = has_em & active
    front = si.wi[..., 2] > 0.0
    # index_select: its backward is an index_add_ (see bsdf/dispatch.py)
    rad = scene.emitters.radiance.index_select(0, torch.clamp(si.emitter_id, min=0).long())
    return torch.where((has_em & front)[:, None], rad, 0.0)


def _dir_to_uv(d):
    """World direction -> equirect (u, v), Y-up: v = theta/pi from +Y,
    u = phi/2pi with phi = atan2(x, -z)."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], -d[..., 2])
    return phi * (0.5 / m.PI) + 0.5, theta * (1.0 / m.PI), theta


def _uv_to_dir(u, v):
    theta = v * m.PI
    phi = (u - 0.5) * (2.0 * m.PI)
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.sin(phi), ct, -st * torch.cos(phi)], dim=-1), theta


def _env_bilinear(em, u, v):
    """Bilinear equirect fetch (wrap in u, clamp in v)."""
    he, we = em.env_map.shape[:2]
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    xi0 = torch.remainder(x0.to(torch.int32), we)
    xi1 = torch.remainder(x0.to(torch.int32) + 1, we)
    yi0 = torch.clamp(y0.to(torch.int32), 0, he - 1)
    yi1 = torch.clamp(y0.to(torch.int32) + 1, 0, he - 1)
    flat = em.env_map.reshape(-1, 3)
    c00 = flat[(yi0 * we + xi0).long()]
    c01 = flat[(yi0 * we + xi1).long()]
    c10 = flat[(yi1 * we + xi0).long()]
    c11 = flat[(yi1 * we + xi1).long()]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def eval_environment(scene: Scene, active, d=None):
    """Environment radiance for escaped rays; `d` may be omitted for
    constant environments."""
    em = scene.emitters
    env = em.env_radiance
    if not _has_env_map(em) or d is None:
        rgb = (env * em.env_map[0, 0])[None, :]
        return torch.where(active[:, None], rgb, 0.0)
    u, v, _ = _dir_to_uv(d)
    rgb = _env_bilinear(em, u, v) * env[None, :]
    return torch.where(active[:, None], rgb, 0.0)


def pdf_environment_direction(scene: Scene, d, active=None):
    """Solid-angle pdf that env-NEE would have sampled d, including the
    env-vs-area selection probability; zero for constant environments."""
    em = scene.emitters
    he, we = em.env_map.shape[:2]
    if not _has_env_map(em):
        return torch.zeros(d.shape[:-1], dtype=m.Float, device=d.device)
    u, v, theta = _dir_to_uv(d)
    x = torch.clamp((u * we).to(torch.int32), 0, we - 1)
    y = torch.clamp((v * he).to(torch.int32), 0, he - 1)
    pmf = em.env_dist.weights.reshape(-1)[(y * we + x).long()] / em.env_dist.total
    # d_omega = 2 pi^2 sin(theta) du dv
    pdf = m.safe_div(pmf * (he * we), 2.0 * m.PI * m.PI * torch.sin(theta)) * em.env_select_p
    if active is not None:
        pdf = torch.where(active, pdf, 0.0)
    return pdf


def _sample_env_direction(scene: Scene, u2):
    """Importance-sample the equirect map.  Returns (d, pdf_sa without the
    selection prob, radiance)."""
    em = scene.emitters
    he, we = em.env_map.shape[:2]
    x, y, ux, uy, pmf = em.env_dist.sample_reuse(u2)
    u = (x.to(m.Float) + ux) / we
    v = (y.to(m.Float) + uy) / he
    d, theta = _uv_to_dir(u, v)
    pdf_sa = m.safe_div(pmf * (he * we), 2.0 * m.PI * m.PI * torch.sin(theta))
    rad = _env_bilinear(em, u, v) * em.env_radiance[None, :]
    return d, pdf_sa, rad


def sample_emitter_direction(scene: Scene, si_ref, u2, test_visibility=True, active=None):
    """NEE: sample a direction towards an emitter from si_ref.

    With a textured environment map NEE is a mixture: with probability
    env_select_p sample the map, else a power-weighted area-light face.  The
    reported pdf includes the selection probability.

    Returns (DirectionSample, weight = Le * visibility / pdf)."""
    em = scene.emitters
    n = si_ref.p.shape[0]
    dev = si_ref.p.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)

    has_env = _has_env_map(em)
    if has_env:
        # split u2[...,0] into (selection bit, fresh uniform)
        p_env = em.env_select_p
        sel_env = u2[..., 0] < p_env
        u0 = torch.where(
            sel_env,
            m.safe_div(u2[..., 0], p_env),
            m.safe_div(u2[..., 0] - p_env, 1.0 - p_env),
        )
        u0 = torch.clamp(u0, 0.0, 1.0 - 1e-7)
    else:
        sel_env = torch.zeros((n,), dtype=torch.bool, device=dev)
        u0 = u2[..., 0]

    # pick an emissive face (power-weighted); one packed row fetch then gives
    # triangle, area, prob, CDF bin and emitter id together
    slot = em.face_dist.sample(u0)
    row = em.em_face_packed[slot.long()]                 # (N, 16)
    lo, hi = row[:, 11], row[:, 12]
    u_re = torch.clamp(m.safe_div(u0 * em.face_dist.total - lo, hi - lo), 0.0, 1.0 - 1e-7)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]

    b = warp.square_to_uniform_triangle(torch.stack([u_re, u2[..., 1]], dim=-1))
    p = v0 + e1 * b[..., 0:1] + e2 * b[..., 1:2]
    ng = m.normalize(m.cross(e1, e2))

    d_un = p - si_ref.p
    dist2 = m.squared_norm(d_un)
    dist = torch.sqrt(dist2)
    d = d_un * m.safe_rcp(dist)[..., None]

    cos_l = m.dot(ng, -d)          # the emitter's front side faces the receiver
    area = row[:, 9]
    pmf = row[:, 10]
    pdf_sa = m.safe_div(pmf * dist2, cos_l * area)
    valid = active & (cos_l > 0.0) & (dist2 > 0.0) & (pdf_sa > 0.0)

    em_id = row[:, 13].contiguous().view(torch.int32)
    rad = em.radiance.index_select(0, em_id.long())

    if has_env:
        d_env, pdf_env, rad_env = _sample_env_direction(
            scene, torch.stack([u0, u2[..., 1]], dim=-1)
        )
        valid_env = active & (pdf_env > 0.0)
        pdf_sa = torch.where(sel_env, pdf_env * p_env, pdf_sa * (1.0 - p_env))
        valid = torch.where(sel_env, valid_env, valid)
        d = torch.where(sel_env[:, None], d_env, d)
        rad = torch.where(sel_env[:, None], rad_env, rad)
        far = 2.0 * _scene_radius(scene)
        p = torch.where(sel_env[:, None], si_ref.p + d * far, p)
        ng = torch.where(sel_env[:, None], -d, ng)
        dist = torch.where(sel_env, far, dist)
        em_id = torch.where(sel_env, -2, em_id)   # -2 = environment

    weight = torch.where(valid[:, None], rad * m.safe_rcp(pdf_sa)[:, None], 0.0)

    if test_visibility:  # the reference tests its shadow rays itself (reference/trace.py)
        raise ValueError("the frozen reference samples without a visibility test")
        shadow_ray = si_ref.spawn_ray_to(p)
        occluded = ray_test(scene, shadow_ray, valid)
        valid = valid & ~occluded
        weight = torch.where(valid[:, None], weight, 0.0)

    ds = DirectionSample(
        p=p,
        n=ng,
        d=d,
        dist=dist,
        pdf=torch.where(valid, pdf_sa, 0.0),
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        emitter_id=torch.where(valid, em_id, -1).to(torch.int32),
    )
    return ds, weight


def _scene_radius(scene: Scene):
    """Conservative world-bounding radius (distance for env shadow rays)."""
    return torch.amax(torch.abs(scene.geometry.vertices)) * 2.0 + 1.0


def pdf_emitter_direction(scene: Scene, si_ref, si_hit, active=None):
    """Solid-angle pdf that NEE from si_ref would have sampled the emissive
    face hit at si_hit (for MIS of BSDF-sampled rays)."""
    em = scene.emitters
    slot = em.face_to_slot[torch.clamp(si_hit.prim_idx, min=0).long()]
    has = (si_hit.prim_idx >= 0) & (slot >= 0)
    if active is not None:
        has = has & active
    slot_s = torch.clamp(slot, min=0).long()

    d_un = si_hit.p - si_ref.p
    dist2 = m.squared_norm(d_un)
    d = d_un * m.rsqrt_safe(dist2)[..., None]
    cos_l = m.dot(si_hit.n, -d)
    row = em.em_face_packed[slot_s]
    area, pmf = row[:, 9], row[:, 10]
    pdf = m.safe_div(pmf * dist2, cos_l * area)
    if _has_env_map(em):
        pdf = pdf * (1.0 - em.env_select_p)   # NEE technique-selection prob
    return torch.where(has & (cos_l > 0.0), pdf, 0.0)


def pdf_emitter_direction_packed(scene: Scene, si_ref, si_hit, em_pmf, em_area, active=None):
    """pdf_emitter_direction from the NEE-pdf columns of the hit's face row
    (``_make_si(..., return_row=True)``: row[:, 27] = pmf, row[:, 28] =
    area): the same floats as the emitter-table path without its two
    gathers.  Used by the persistent renderer and the path replay."""
    em = scene.emitters
    has = (si_hit.prim_idx >= 0) & (si_hit.emitter_id >= 0) & (em_pmf > 0.0)
    if active is not None:
        has = has & active
    d_un = si_hit.p - si_ref.p
    dist2 = m.squared_norm(d_un)
    d = d_un * m.rsqrt_safe(dist2)[..., None]
    cos_l = m.dot(si_hit.n, -d)
    pdf = m.safe_div(em_pmf * dist2, cos_l * em_area)
    if _has_env_map(em):
        pdf = pdf * (1.0 - em.env_select_p)   # NEE technique-selection prob
    return torch.where(has & (cos_l > 0.0), pdf, 0.0)


def sample_emitter_ray(scene: Scene, u_pos2, u_dir2, active=None):
    """Sample a ray leaving an emitter (scene.sample_emitter_ray): a
    power-weighted face pick, a uniform point on it and a cosine-weighted
    direction about the face normal.  The light paths of the particle
    tracer, BDPT and SPPM start here.

    Returns (ray, weight, emitter_id) with weight = Le * pi / p_area (the
    cosine direction pdf cancels cos theta)."""
    em = scene.emitters
    u0 = u_pos2[..., 0]
    slot = em.face_dist.sample(u0)
    row = em.em_face_packed[slot.long()]                 # (N, 16)
    lo, hi = row[:, 11], row[:, 12]
    u_re = torch.clamp(m.safe_div(u0 * em.face_dist.total - lo, hi - lo), 0.0, 1.0 - 1e-7)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    b = warp.square_to_uniform_triangle(torch.stack([u_re, u_pos2[..., 1]], dim=-1))
    p = v0 + e1 * b[..., 0:1] + e2 * b[..., 1:2]
    ng = m.normalize(m.cross(e1, e2))

    d_local = warp.square_to_cosine_hemisphere(u_dir2)
    s, t = m.coordinate_system(ng)
    d = m.to_world(s, t, ng, d_local)

    area = row[:, 9]
    pmf = row[:, 10]
    p_area = m.safe_div(pmf, area)
    em_id = row[:, 13].contiguous().view(torch.int32)
    rad = em.radiance.index_select(0, em_id.long())
    weight = rad * (m.PI * m.safe_rcp(p_area))[:, None]

    o = p + ng * m.RAY_EPS
    return Ray.make(o, d), weight, em_id
