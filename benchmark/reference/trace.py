"""The reference's own ray queries and path tracing, in plain torch.

The reference builds its scene from the scene dict with the frozen compiler
(`frozen/scene/build.py`, no BVH) and answers ray queries with its own
structure: the triangles sorted along a Morton curve of their centroids and
cut into clusters of `CLUSTER` consecutive triangles, each with its bounding
box.  A query tests every ray against every cluster's box, then the
triangles of the clusters whose box it enters, with the frozen
Moller-Trumbore test (`frozen/intersect/triangle.py`).  Nothing of it comes
from the port's BVH.

`RefScene.lower()` gives the control: the same reference with every floating
table, ray and hit rounded to bfloat16 (computed in float32 between the
roundings), the precision a program that stored them in bfloat16 would have.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .frozen import shade
from .frozen.core import math as m
from .frozen.core.records import Ray
from .frozen.intersect.triangle import intersect_tri
from .frozen.render import film as filmlib
from .frozen.render import sensor as sensorlib
from .frozen.scene.build import load_dict

CLUSTER = 128          # triangles per cluster
PAIR_BUDGET = 1 << 22  # (ray, cluster) pairs tested at once
BOX_PAD = 1e-4         # box padding, in scene units (the stand-in's room is ~8 units wide)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _morton(c, lo, hi):
    """30-bit Morton codes of points c (F, 3) in the box [lo, hi]."""
    q = np.clip(((c - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


@dataclasses.dataclass
class RefScene:
    """The reference's compiled scene (`scene`, frozen tables) and its
    clusters: `tris` (C * CLUSTER, 3, 3) in cluster order (padding
    triangles are degenerate), `face` their face ids (-1 pad), `lo` / `hi`
    (C, 3) the clusters' boxes."""

    scene: object
    tris: torch.Tensor
    face: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    rounded: bool = False

    @staticmethod
    def build(scene_dict: dict, device) -> "RefScene":
        scene, _ = load_dict(scene_dict, device=device)
        return RefScene.of(scene)

    @staticmethod
    def of(scene, rounded: bool = False) -> "RefScene":
        g = scene.geometry
        V = g.vertices.double().cpu().numpy()
        F = g.faces.long().cpu().numpy()
        tri = V[F].astype(np.float32)                      # (F, 3, 3)
        cen = tri.mean(axis=1)
        order = np.argsort(_morton(cen, cen.min(0), cen.max(0)), kind="stable")
        nf = F.shape[0]
        nc = -(-nf // CLUSTER)
        face = np.full(nc * CLUSTER, -1, np.int64)
        face[:nf] = order
        tris = np.zeros((nc * CLUSTER, 3, 3), np.float32)
        tris[:nf] = tri[order]
        tris[nf:] = tri[order[-1]][0]                        # degenerate: det 0, never hit
        blk = tris.reshape(nc, CLUSTER * 3, 3)
        lo = blk.min(axis=1) - BOX_PAD
        hi = blk.max(axis=1) + BOX_PAD
        dev = g.vertices.device
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        return RefScene(scene, t(tris), t(face, torch.int64), t(lo), t(hi), rounded)

    def lower(self) -> "RefScene":
        """The control: every floating table of the scene rounded to bfloat16
        (the face rows' material and emitter ids, stored as int32 bits in
        float32, are kept)."""
        s = self.scene
        g = s.geometry
        fp = _bf16(g.face_packed)
        fp[:, 25:27] = g.face_packed[:, 25:27]
        geo = dataclasses.replace(g, vertices=_bf16(g.vertices), normals=_bf16(g.normals),
                                  uvs=_bf16(g.uvs), face_packed=fp)
        em = s.emitters
        epk = _bf16(em.em_face_packed)
        epk[:, 10:14] = em.em_face_packed[:, 10:14]          # pmf, cdf and emitter ids kept
        ems = dataclasses.replace(em, radiance=_bf16(em.radiance), em_face_packed=epk)
        mats = dataclasses.replace(s.materials, base_color=_bf16(s.materials.base_color),
                                   params=_bf16(s.materials.params))
        tex = dataclasses.replace(s.textures, data=_bf16(s.textures.data))
        low = dataclasses.replace(s, geometry=geo, emitters=ems, materials=mats, textures=tex)
        return RefScene(low, _bf16(self.tris), self.face, self.lo, self.hi, True)

    def with_tables(self, scene) -> "RefScene":
        return dataclasses.replace(self, scene=scene)

    # ---------------------------------------------------------------- queries
    def _pairs(self, o, d, maxt):
        """(ray, cluster) pairs whose box the ray segment (0, maxt) enters."""
        n, nc = o.shape[0], self.lo.shape[0]
        inv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
        rays, cls = [], []
        step = max(1, PAIR_BUDGET // max(nc, 1))
        for a in range(0, n, step):
            oa, ia, ma = o[a:a + step, None, :], inv[a:a + step, None, :], maxt[a:a + step, None]
            t0 = (self.lo[None] - oa) * ia
            t1 = (self.hi[None] - oa) * ia
            tn = torch.minimum(t0, t1).amax(dim=-1)
            tf = torch.maximum(t0, t1).amin(dim=-1)
            hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < ma)
            r, c = torch.nonzero(hit, as_tuple=True)
            rays.append(r + a)
            cls.append(c)
        return torch.cat(rays), torch.cat(cls)

    def query(self, o, d, maxt, any_hit: bool):
        """(t, face, u, v) of the closest hit in (0, maxt), face -1 on a miss
        (any_hit: face >= 0 where some hit exists, t/u/v of one of them).
        Equal distances go to the lower face id."""
        if self.rounded:
            o, d = _bf16(o), _bf16(d)
        n = o.shape[0]
        dev = o.device
        t_best = torch.full((n,), m.INF, dtype=torch.float32, device=dev)
        f_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        u_best = torch.zeros((n,), dtype=torch.float32, device=dev)
        v_best = torch.zeros((n,), dtype=torch.float32, device=dev)
        if n == 0:
            return t_best, f_best, u_best, v_best
        rays, cls = self._pairs(o, d, maxt)
        step = max(1, PAIR_BUDGET // CLUSTER)
        big = torch.iinfo(torch.int64).max
        for a in range(0, rays.numel(), step):
            r, c = rays[a:a + step], cls[a:a + step]
            tri_ix = c[:, None] * CLUSTER + torch.arange(CLUSTER, device=dev)[None, :]
            t, u, v, _ = intersect_tri(o[r], d[r], self.tris[tri_ix], maxt[r])
            fc = self.face[tri_ix]
            t = torch.where(fc >= 0, t, m.INF)
            tp, k = t.min(dim=1)                       # the pair's nearest
            fp = torch.gather(fc, 1, k[:, None])[:, 0]
            # ties within the pair: lowest face id at the nearest distance
            fp = torch.where(t == tp[:, None], fc, big).amin(dim=1)
            fp = torch.where(torch.isfinite(tp), fp, big)
            kk = torch.argmax((fc == fp[:, None]).to(torch.int8), dim=1)
            up = torch.gather(u, 1, kk[:, None])[:, 0]
            vp = torch.gather(v, 1, kk[:, None])[:, 0]
            # fold the pairs into the rays' running best
            t_new = t_best.scatter_reduce(0, r, tp, reduce="amin")
            cand = torch.isfinite(tp) & (tp == t_new[r])
            keep_old = torch.isfinite(t_best) & (t_best == t_new)
            f_cand = torch.full((n,), big, dtype=torch.int64, device=dev)
            f_cand = f_cand.scatter_reduce(0, r, torch.where(cand, fp, big), reduce="amin")
            f_new = torch.where(keep_old, torch.minimum(f_best, f_cand), f_cand)
            win = cand & (fp == f_new[r])
            u_best = u_best.index_put((r[win],), up[win])
            v_best = v_best.index_put((r[win],), vp[win])
            f_best = torch.where(f_new == big, -1, f_new)
            t_best = t_new
        if self.rounded:
            t_best, u_best, v_best = _bf16(t_best), _bf16(u_best), _bf16(v_best)
        return t_best, f_best, u_best, v_best

    def tri_t(self, o, d, face):
        """Distance along each ray to its own face `face` (inf where missed)."""
        g = self.scene.geometry
        tri = g.vertices[g.faces[face.clamp(min=0).long()].long()]   # (N, 3, 3)
        maxt = torch.full(face.shape, m.INF, dtype=torch.float32, device=face.device)
        t, _, _, _ = intersect_tri(o, d, tri[:, None], maxt)
        return torch.where(face >= 0, t[:, 0], m.INF)


# -------------------------------------------------------------- path tracing
def trace(ref: RefScene, seed, idx, *, spp: int, max_depth: int, rr_depth: int, rec=None):
    """The frozen forward wavefront (the port's persistent.trace_rays at
    aa7dcd9) over camera rays `idx` (int64), with the reference's queries
    in place of the BVH traversal.  Returns the rays' radiance (N, 3),
    non-finite values zeroed.  With `rec` (frozen PathRecord of N rows) it
    also writes each closest hit's (prim, u, v) and each shadow ray's
    occlusion bit at (row, depth - 1)."""
    scene = ref.scene
    dev = scene.device
    n = idx.shape[0]
    rayL = torch.zeros((n, 3), dtype=m.Float, device=dev)
    row = torch.arange(n, dtype=torch.int64, device=dev)
    ray = sensorlib.sample_ray(scene.camera, shade.ray_positions(scene.camera, seed, idx, spp))
    o, d = ray.o.contiguous(), ray.d
    L = torch.zeros((n, 3), dtype=m.Float, device=dev)
    f = torch.ones((n, 3), dtype=m.Float, device=dev)
    eta = torch.ones((n,), dtype=m.Float, device=dev)
    depth = torch.ones((n,), dtype=torch.int32, device=dev)
    prev_p, prev_pdf = o, torch.ones((n,), dtype=m.Float, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    kw = dict(max_depth=max_depth, rr_depth=rr_depth)
    while n:
        every = torch.ones((n,), dtype=torch.bool, device=dev)
        inf = torch.full((n,), m.INF, dtype=m.Float, device=dev)
        t, face, u, v = ref.query(o, d, inf, False)
        face = face.to(torch.int32)
        col = depth.long() - 1
        if rec is not None:
            hit = face >= 0
            rec.prim[row, col] = face
            rec.u[row, col] = torch.where(hit, u, 0.0)
            rec.v[row, col] = torch.where(hit, v, 0.0)
        sh = shade._shade(scene, seed, every, o, d, t, face, u, v, L, f, eta, depth, prev_p,
                          prev_pdf, prev_delta, idx, **kw)
        unoccluded, occluded = _shadow(ref, sh)
        if rec is not None:
            em = sh.active_em
            rec.occl[row[em], col[em]] = occluded[em]
        L = sh.L + torch.where(unoccluded[:, None], sh.nee_L, 0.0)
        if ref.rounded:
            L = _bf16(L)
        done = ~sh.cont
        rayL[row[done]] = torch.where(torch.isfinite(L[done]), L[done], 0.0)
        keep = torch.nonzero(sh.cont).squeeze(1)
        n = keep.numel()
        row, idx, L = row[keep], idx[keep], L[keep]
        o, d = sh.next_o[keep], sh.next_d[keep]
        f, eta, depth = sh.f[keep], sh.eta[keep], depth[keep] + 1
        if ref.rounded:
            f = _bf16(f)
        prev_p, prev_pdf, prev_delta = sh.p[keep], sh.pdf[keep], sh.delta[keep]
    return rayL


def _shadow(ref, sh):
    """(unoccluded, occluded) of each lane's NEE shadow ray (False where
    the lane has none)."""
    em = torch.nonzero(sh.active_em).squeeze(1)
    unoccluded = sh.active_em.clone()
    occluded = torch.zeros_like(sh.active_em)
    if em.numel():
        _, occ_face, _, _ = ref.query(sh.shadow_o[em], sh.shadow_d[em], sh.shadow_maxt[em], True)
        occluded[em] = occ_face >= 0
        unoccluded[em] = occ_face < 0
    return unoccluded, occluded


def render_pixels(ref: RefScene, seed, pixels, *, spp: int, max_depth: int, rr_depth: int,
                  rfilter: str):
    """The developed value (P, 3) of each pixel of `pixels` (linear ids,
    int64): every camera ray whose splat reaches it (its own pixel's for a
    box filter; the 3x3 neighbourhood's for a tent) traced by `trace` and
    splat as the port's deferred splat does."""
    scene = ref.scene
    w, h = scene.camera.resolution
    dev = scene.device
    r = 0 if rfilter == "box" else 1
    px, py = pixels % w, pixels // w
    offs = torch.arange(-r, r + 1, device=dev)
    nx = (px[:, None, None] + offs[None, :, None]).expand(-1, 2 * r + 1, 2 * r + 1)
    ny = (py[:, None, None] + offs[None, None, :]).expand(-1, 2 * r + 1, 2 * r + 1)
    ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
    near = torch.unique((ny * w + nx)[ok])
    idx = (near[:, None] * spp + torch.arange(spp, device=dev)[None, :]).reshape(-1)
    rayL = trace(ref, seed, idx, spp=spp, max_depth=max_depth, rr_depth=rr_depth)
    pos = shade.ray_positions(scene.camera, seed, idx, spp)
    film = filmlib.put(filmlib.new_film(w, h, device=dev), pos, rayL, rfilter=rfilter)
    return filmlib.develop(film).reshape(-1, 3)[pixels]


def record_off(ref: RefScene, rows_rec, idx, seed, *, spp: int, max_depth: int, rr_depth: int,
               uv_tol: float = 1e-4, t_tol: float = 1e-6):
    """Holds record rows `rows_rec` (prim, u, v, occl of (S, D)) of camera
    rays `idx` (S,) int64 against the reference.  Each row's path is
    followed along the record's own hits: at each recorded step the
    reference queries the same ray and shades the recorded hit with the
    frozen `_shade`.  An entry is off where the face differs (unless the
    record's face lies at the reference's distance, a tie, within t_tol
    relative), where u or v differ by more than uv_tol, where a shadow bit
    differs, and where the record goes on past a step at which the
    reference's path ends.  Returns (rows with an entry off, rows held)."""
    scene = ref.scene
    dev = scene.device
    D = rows_rec.prim.shape[1]
    idx = idx.to(dev)
    n = idx.shape[0]
    prim = rows_rec.prim.to(dev).long()
    ru, rv, rocc = rows_rec.u.to(dev), rows_rec.v.to(dev), rows_rec.occl.to(dev)
    sel = torch.arange(n, dtype=torch.int64, device=dev)
    ray = sensorlib.sample_ray(scene.camera, shade.ray_positions(scene.camera, seed, idx, spp))
    o, d = ray.o.contiguous(), ray.d
    L = torch.zeros((n, 3), dtype=m.Float, device=dev)
    f = torch.ones((n, 3), dtype=m.Float, device=dev)
    eta = torch.ones((n,), dtype=m.Float, device=dev)
    depth = torch.ones((n,), dtype=torch.int32, device=dev)
    prev_p, prev_pdf = o, torch.ones((n,), dtype=m.Float, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    bad = torch.zeros((n,), dtype=torch.bool, device=dev)
    held = n
    k = 0
    while n and k < D:
        inf = torch.full((n,), m.INF, dtype=m.Float, device=dev)
        t_r, f_r, u_r, v_r = ref.query(o, d, inf, False)
        p = prim[sel, k]
        up, vp = ru[sel, k], rv[sel, k]
        same = p == f_r
        uv_bad = same & (p >= 0) & (((up - u_r).abs() > uv_tol) | ((vp - v_r).abs() > uv_tol))
        t_p = ref.tri_t(o, d, p)
        tie = (~same) & (p >= 0) & (f_r >= 0) & ((t_p - t_r).abs() <= t_tol * torch.clamp(
            t_r.abs(), min=1.0))
        wrong = (~same & ~tie) | uv_bad
        # shade the recorded hit (its distance plays no part: the replay's t)
        every = torch.ones((n,), dtype=torch.bool, device=dev)
        t1 = torch.where(p >= 0, 1.0, m.INF)
        sh = shade._shade(scene, seed, every, o, d, t1, p.to(torch.int32), up, vp, L, f, eta,
                          depth, prev_p, prev_pdf, prev_delta, idx, max_depth=max_depth,
                          rr_depth=rr_depth)
        _, occluded = _shadow(ref, sh)
        em = sh.active_em
        wrong |= ((rocc[sel, k] != occluded) & em) | (rocc[sel, k] & ~em)
        go = sh.cont & (p >= 0)
        # a path that ends here must have nothing recorded after it
        if k + 1 < D:
            wrong |= ~go & (prim[sel, k + 1:] >= 0).any(dim=1)
        bad[sel[wrong]] = True
        keep = torch.nonzero(go).squeeze(1)
        n = keep.numel()
        sel, idx = sel[keep], idx[keep]
        L = sh.L[keep]
        o, d = sh.next_o[keep], sh.next_d[keep]
        f, eta, depth = sh.f[keep], sh.eta[keep], depth[keep] + 1
        prev_p, prev_pdf, prev_delta = sh.p[keep], sh.pdf[keep], sh.delta[keep]
        k += 1
    return int(bad.sum()), held
