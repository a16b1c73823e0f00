"""Independent CPU reference path tracer for cross-renderer validation.

The port's own copy of ``mitsuba3_experiments_tpu.validation.oracle``.
Rules of independence:

  * plain numpy only, with no torch anywhere in this module: it shares no
    code with the renderer it checks: its own brute-force Moller-Trumbore
    intersection (no BVH), its own cosine hemisphere sampling, its own NEE
    + power-heuristic MIS bookkeeping, and numpy's PCG64 generator instead
    of the renderer's TEA/PCG stream;
  * it consumes only the compiled scene data (triangles, albedo, emitter
    radiance, camera) as numpy arrays, read off the port's `Scene` by
    `scene_to_numpy`;
  * any unbiased estimator converges to the same radiance, so agreement of
    block means is evidence that the renderer's traversal, BSDF maths, MIS
    weights and film are right, not that the two share sampling strategies.

Diffuse-only (the Cornell box is all-diffuse); depth counts surface
scattering events like the renderer's PathIntegrator (NEE at surfaces with
depth < max_depth).  No Russian roulette: compare with roulette disabled.
"""
from __future__ import annotations

import numpy as np


def _host(x):
    """A tensor of the port (on any device) as a numpy array."""
    return x.detach().cpu().numpy()


def scene_to_numpy(scene):
    """Extract the plain-numpy scene data the oracle consumes from the
    port's `Scene`."""
    g = scene.geometry
    v = _host(g.vertices)
    f = _host(g.faces)
    tri = v[f]                                     # (F, 3, 3)
    albedo = _host(scene.materials.base_color)[_host(g.face_mat)]
    em_id = _host(g.face_emitter)
    radiance = _host(scene.emitters.radiance)
    emit = np.where(
        (em_id >= 0)[:, None], radiance[np.maximum(em_id, 0)], 0.0
    )                                              # (F, 3)
    cam = scene.camera
    return {
        "tri": tri.astype(np.float32),
        "albedo": albedo.astype(np.float32),
        "emit": emit.astype(np.float32),
        "to_world": _host(cam.to_world).astype(np.float64),
        "tan_half_fov": _host(cam.tan_half_fov).astype(np.float64),
        "resolution": cam.resolution,
    }


def _intersect(tri, o, d, eps=1e-7):
    """Brute-force Moller-Trumbore: o,d (N,3) vs tri (F,3,3).

    Returns (t, face, n_geom) with face == -1 on miss."""
    v0 = tri[:, 0]                                  # (F, 3)
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    pvec = np.cross(d[:, None, :], e2[None, :, :])  # (N, F, 3)
    det = np.einsum("fk,nfk->nf", e1, pvec)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = np.einsum("nfk,nfk->nf", tvec, pvec) * inv
    qvec = np.cross(tvec, e1[None, :, :])
    w = np.einsum("nk,nfk->nf", d, qvec) * inv
    t = np.einsum("fk,nfk->nf", e2, qvec) * inv
    hit = (
        (np.abs(det) > 1e-12) & (u >= 0) & (w >= 0) & (u + w <= 1)
        & (t > eps)
    )
    t = np.where(hit, t, np.inf)
    face = np.argmin(t, axis=1)
    t_best = t[np.arange(len(o)), face]
    miss = ~np.isfinite(t_best)
    face = np.where(miss, -1, face)
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n_hit = np.where(miss[:, None], 0.0, n[np.maximum(face, 0)])
    return t_best, face, n_hit


def _cosine_sample(n, u1, u2):
    """Cosine-weighted hemisphere around unit normals n (N, 3)."""
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    z = np.sqrt(np.maximum(0.0, 1.0 - u1))
    # build an orthonormal basis per normal
    a = np.where(np.abs(n[:, 2:3]) < 0.9, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    t = np.cross(a, n)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    return t * x[:, None] + b * y[:, None] + n * z[:, None]


def render_oracle(data, spp=64, max_depth=8, seed=0, chunk=65536):
    """Render (H, W, 3) radiance means; NEE + BSDF MIS, no RR."""
    w, h = data["resolution"]
    tri = data["tri"]
    albedo = data["albedo"]
    emit = data["emit"]
    is_em = emit.sum(-1) > 0
    em_faces = np.nonzero(is_em)[0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=-1)
    n_face = cr / np.linalg.norm(cr, axis=-1, keepdims=True)
    em_area_total = area[em_faces].sum()
    em_cdf = np.cumsum(area[em_faces]) / em_area_total

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3))
    n_total = w * h * spp

    for start in range(0, n_total, chunk):
        idx = np.arange(start, min(start + chunk, n_total))
        N = len(idx)
        pix = idx // spp
        px = (pix % w) + rng.random(N)
        py = (pix // w) + rng.random(N)
        # camera ray (film x right -> camera -x, y down -> -y, +z forward)
        dx = (1.0 - 2.0 * px / w) * data["tan_half_fov"][0]
        dy = (1.0 - 2.0 * py / h) * data["tan_half_fov"][1]
        d_cam = np.stack([dx, dy, np.ones(N)], axis=-1)
        R = data["to_world"][:3, :3]
        o = np.broadcast_to(data["to_world"][:3, 3], (N, 3)).copy()
        d = d_cam @ R.T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)

        L = np.zeros((N, 3))
        beta = np.ones((N, 3))
        spec_or_first = np.ones(N, bool)   # first hit: add emission directly
        prev_pdf = np.zeros(N)
        alive = np.ones(N, bool)

        for depth in range(1, max_depth + 1):
            if not alive.any():
                break
            t, face, ng = _intersect(tri, o, d)
            hit = alive & (face >= 0)
            alive = hit
            fs = np.maximum(face, 0)
            # sanitize dead lanes so no inf/NaN leaks through 0*NaN into
            # masked contributions (np.maximum propagates NaN)
            t = np.where(hit, t, 1.0)
            ng = np.where(hit[:, None], ng, [0.0, 0.0, 1.0])
            p_hit = o + d * t[:, None]
            p_hit = np.where(hit[:, None], p_hit, 0.0)

            # emission on the front side, MIS-weighted vs prev bsdf pdf
            front = np.einsum("nk,nk->n", ng, -d) > 0
            le = emit[fs] * (hit & front)[:, None]
            if le.any():
                # pdf of having sampled this point via NEE from prev vertex
                dist2 = np.maximum(t, 1e-12) ** 2
                cos_l = np.abs(np.einsum("nk,nk->n", ng, -d))
                pdf_nee_sa = np.where(
                    is_em[fs] & hit,
                    dist2 / np.maximum(cos_l * em_area_total, 1e-12), 0.0,
                )
                w_mis = np.where(
                    spec_or_first, 1.0,
                    prev_pdf ** 2
                    / np.maximum(prev_pdf ** 2 + pdf_nee_sa ** 2, 1e-300),
                )
                L += beta * le * w_mis[:, None]

            if depth >= max_depth:
                break

            # flip normal to the ray side for shading
            ns = np.where(front[:, None], ng, -ng)

            # --- NEE: uniform-area sample on the emitters ---
            ue = rng.random(N)
            pick = np.searchsorted(em_cdf, ue)
            ef = em_faces[np.minimum(pick, len(em_faces) - 1)]
            b1 = rng.random(N)
            b2 = rng.random(N)
            flip = b1 + b2 > 1
            b1 = np.where(flip, 1 - b1, b1)
            b2 = np.where(flip, 1 - b2, b2)
            p_l = (
                tri[ef, 0]
                + (tri[ef, 1] - tri[ef, 0]) * b1[:, None]
                + (tri[ef, 2] - tri[ef, 0]) * b2[:, None]
            )
            wi = p_l - p_hit
            dist = np.linalg.norm(wi, axis=-1)
            wi /= np.maximum(dist, 1e-12)[:, None]
            cos_s = np.einsum("nk,nk->n", ns, wi)
            cos_l = np.einsum("nk,nk->n", n_face[ef], -wi)
            vis_ok = hit & (cos_s > 0) & (cos_l > 0)
            # shadow ray (offset both ends)
            t_o, f_o, _ = _intersect(
                tri, p_hit + wi * 1e-4, wi
            )
            unoccluded = ~(t_o < dist - 1e-3)
            vis_ok &= unoccluded
            pdf_nee_sa = dist ** 2 / np.maximum(cos_l * em_area_total, 1e-12)
            f_brdf = albedo[fs] / np.pi
            pdf_b = np.maximum(cos_s, 0.0) / np.pi
            w_mis = pdf_nee_sa ** 2 / np.maximum(
                pdf_nee_sa ** 2 + pdf_b ** 2, 1e-300
            )
            contrib = (
                beta * f_brdf * emit[ef]
                * (cos_s / np.maximum(pdf_nee_sa, 1e-300))[:, None]
                * w_mis[:, None]
            )
            L += np.where(vis_ok[:, None], contrib, 0.0)

            # --- BSDF bounce: cosine sample ---
            wo = _cosine_sample(ns, rng.random(N), rng.random(N))
            cos_o = np.einsum("nk,nk->n", ns, wo)
            prev_pdf = np.maximum(cos_o, 0.0) / np.pi
            # f * cos / pdf = albedo for cosine sampling
            beta = beta * albedo[fs]
            spec_or_first = np.zeros(N, bool)
            alive &= prev_pdf > 0
            o = p_hit + wo * 1e-4
            d = wo

        np.add.at(
            img.reshape(-1, 3), pix, L / spp
        )
    return img


def block_means(img, block=8):
    h, w, _ = img.shape
    return img.reshape(h // block, block, w // block, block, 3).mean((1, 3))
