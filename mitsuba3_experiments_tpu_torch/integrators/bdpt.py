"""Bidirectional path tracing: camera + light subpaths with vertex connection.

Counterpart of ``mitsuba3_experiments_tpu.integrators.bdpt``.  The subpath
vertex buffers are records whose fields have depth on the leading axis,
(max_depth+1, N, ...) or (n_steps, N, ...): a Python loop over depth walks
the subpath and ``torch.stack`` stacks its vertices.

Two tiers:

* `BDPTIntegrator` (default, `mis=True`): every (s, t) strategy with t >= 2
  (camera + at least one surface vertex) is connected with a visibility ray,
  and the strategies are combined with the Veach power heuristic computed
  from the forward/reverse area pdfs both walks record (PBRT's iterative
  ratio walk with per-strategy endpoint-pdf overrides).  Light-tracing
  strategies (t < 2, film splats) are left out of the estimator and of
  every weight's denominator, so the restricted mixture still sums to one.
  Environment emitters are reachable only through the s=0 family (weight
  1).  A vertex counts as delta for MIS when its material has no smooth
  lobe.
* `mis=False`: the reference's unweighted (s=1, t=1) combination with its
  re-intersection connection.

Each connection's visibility test is one any-hit query (one K1 launch on
the card): O(depth^2) launches per pass.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core import warp
from ..core.records import BSDFFlags, Ray, SurfaceInteraction, has_flag
from ..core.struct import tgather, tmap
from ..intersect import ray_intersect, ray_test
from ..render import bsdf as bsdflib
from ..render.emitter import eval_emitter, eval_environment, sample_emitter_ray
from .common import register_integrator


@dataclasses.dataclass(frozen=True)
class Vertex:
    """Per-bounce path vertex (leading axis = depth)."""

    p: torch.Tensor       # (..., N, 3)
    f: torch.Tensor       # (..., N, 3) cumulative throughput
    L: torch.Tensor       # (..., N, 3) cumulative radiance
    wi: torch.Tensor      # (..., N, 3) world-space incident dir at the vertex
    mat_id: torch.Tensor  # (..., N) material at the vertex
    valid: torch.Tensor   # (..., N)


def _stack(records):
    """A list of records -> one record with a new leading axis."""
    return tmap(lambda *xs: torch.stack(xs, dim=0), *records)


def record_path(scene, sampler, ray, max_depth: int = 8):
    """Trace and record per-bounce vertices into a (depth, lane) buffer:
    `path.p[d]` is vertex d of every lane (0 = the ray origin); whole-buffer
    select and gather are core.struct operations."""
    integ = BDPTIntegrator(max_depth=max_depth)
    return integ.record_camera_path(scene, sampler, ray)


@dataclasses.dataclass(frozen=True)
class FullVertex:
    """Per-vertex record with the pdf bookkeeping MIS needs (leading axis =
    depth for subpath buffers; index 0 = first surface vertex)."""

    p: torch.Tensor         # (..., N, 3)
    ng: torch.Tensor        # (..., N, 3) geometric normal
    sh_s: torch.Tensor      # (..., N, 3) shading frame
    sh_t: torch.Tensor
    sh_n: torch.Tensor
    uv: torch.Tensor        # (..., N, 2)
    wi_world: torch.Tensor  # (..., N, 3) unit dir from the vertex toward prev
    mat_id: torch.Tensor    # (..., N)
    emitter_id: torch.Tensor
    prim_idx: torch.Tensor
    smooth: torch.Tensor    # (..., N) bool: the material has a smooth lobe
    beta: torch.Tensor      # (..., N, 3) throughput into the vertex
    pdf_fwd: torch.Tensor   # (..., N) area pdf of generating it from prev
    pdf_rev: torch.Tensor   # (..., N) area pdf of generating it from next
    valid: torch.Tensor     # (..., N) bool


def _remap0(x):
    """PBRT's remap0: never-sampled (0) pdfs count as 1 in MIS ratios."""
    return torch.where(x == 0.0, 1.0, x)


def _to_area(pdf_sw, p_from, p_to, ng_to):
    """Solid-angle pdf at p_from -> area pdf at p_to."""
    d = p_to - p_from
    dist2 = m.squared_norm(d)
    dn = d * m.rsqrt_safe(dist2)[..., None]
    return pdf_sw * m.safe_div(torch.abs(m.dot(ng_to, dn)), dist2)


def _vert_si(v: FullVertex, wi_world) -> SurfaceInteraction:
    """A SurfaceInteraction at a recorded vertex with an arbitrary incident
    direction (for swapped-argument pdf evaluations)."""
    n = v.p.shape[0]
    return SurfaceInteraction(
        t=torch.ones((n,), dtype=m.Float, device=v.p.device),
        p=v.p, n=v.ng, sh_n=v.sh_n, sh_s=v.sh_s, sh_t=v.sh_t, uv=v.uv,
        wi=m.to_local(v.sh_s, v.sh_t, v.sh_n, wi_world),
        prim_idx=v.prim_idx, mat_id=v.mat_id, emitter_id=v.emitter_id,
    )


@dataclasses.dataclass(frozen=True)
class BDPTIntegrator:
    max_depth: int = 16
    rr_depth: int = 4
    mis: bool = True   # False = the reference's unweighted (s=1, t=1)

    # ------------------------------------------------------------------
    def _record_subpath(self, scene, sampler, ray, weight0, from_light):
        """Shared walk of both subpaths; returns a Vertex with leading axis
        depth 0..max_depth."""
        n = ray.o.shape[0]
        dev = ray.o.device
        ones3 = torch.ones((n, 3), dtype=m.Float, device=dev)
        verts = [Vertex(
            p=ray.o, f=ones3, L=(weight0 if from_light else ones3),
            wi=torch.zeros((n, 3), dtype=m.Float, device=dev),
            mat_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
            valid=torch.ones((n,), dtype=torch.bool, device=dev),
        )]
        f = ones3
        L = weight0 if from_light else torch.zeros((n, 3), dtype=m.Float, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        for _ in range(self.max_depth):
            si = ray_intersect(scene, ray, active)
            Le = eval_emitter(scene, si, active)
            active_next = active & si.valid
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, bsdf_w = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, active_next)
            ray = si.spawn_ray(si.to_world(bs.wo))
            if from_light:
                # importance chain: f *= w; L = f * L + Le
                f = f * bsdf_w
                L = f * L + Le
            else:
                # radiance: L += f * Le; f *= w
                L = L + f * Le
                f = f * bsdf_w
            verts.append(Vertex(p=si.p, f=f, L=L, wi=si.wi_world, mat_id=si.mat_id,
                                valid=active & si.valid))
            active = active_next
        return _stack(verts), sampler

    def record_camera_path(self, scene, sampler, ray):
        n = ray.o.shape[0]
        ones3 = torch.ones((n, 3), dtype=m.Float, device=ray.o.device)
        return self._record_subpath(scene, sampler, ray, ones3, from_light=False)

    def record_light_path(self, scene, sampler, n):
        sampler, u_pos = sampler.next_2d()
        sampler, u_dir = sampler.next_2d()
        ray, weight, _ = sample_emitter_ray(scene, u_pos, u_dir)
        return self._record_subpath(scene, sampler, ray, weight, from_light=True)

    # ------------------------------------------------------------------
    def connect_s2t(self, scene, s_vert, t_vert):
        """Visibility ray from t to s, then the BSDF at s re-evaluated for
        the continuation direction s_vert.wi."""
        s_p = s_vert.p
        t_p = t_vert.p
        d = s_p - t_p
        dist = m.norm(d)
        dirn = d * m.safe_rcp(dist)[:, None]

        conn_active = s_vert.valid & t_vert.valid & (dist > 1e-4)
        shadow = Ray(o=t_p + dirn * m.RAY_EPS, d=dirn, maxt=dist * (1.0 - 1e-3))
        # as the reference, keep the lanes whose visibility ray does hit:
        # it re-intersects to land on s, within a tolerance relative to the
        # connection distance
        si = ray_intersect(scene, shadow, conn_active)
        hit_s = si.valid & (m.norm(si.p - s_p) < 1e-2 * torch.clamp(dist, min=1e-3))
        active = conn_active & hit_s

        wo = si.to_local(s_vert.wi)
        f_val, pdf = bsdflib.eval_pdf(scene.materials, scene.textures, si, wo, active)
        weight = m.safe_div(f_val, pdf[:, None])
        weight = torch.where(active[:, None], weight, 0.0)
        Le = eval_emitter(scene, si, active)
        return weight, Le

    def connect_bdpt(self, scene, s, t, camera_path, light_path):
        """The reference's (s=1, t=1) combination."""
        cs = tgather(camera_path, s, axis=0)
        lt = tgather(light_path, t, axis=0)
        camera_weight, camera_Le = self.connect_s2t(scene, cs, lt)
        light_weight, light_Le = self.connect_s2t(scene, lt, cs)
        if s == 0:
            camera_weight = torch.ones_like(camera_weight)
        return (cs.L + cs.f * camera_weight * light_Le
                + cs.f * camera_weight * light_weight * lt.L)

    # ==================================================================
    # Full multi-strategy BDPT (mis=True)
    # ==================================================================
    def _record_full(self, scene, sampler, ray, beta0, pending_pdf_sw, prev_p, prev_ng,
                     n_steps: int, active0):
        """Walk a subpath recording FullVertex with forward/reverse area
        pdfs.  Returns (vertices (n_steps, N, ...), pdf_rev of the walk's
        origin, the direction of the ray into each vertex, sampler)."""
        mats, tex = scene.materials, scene.textures
        n = ray.o.shape[0]
        beta, active = beta0, active0
        verts, rev_shift, d_in = [], [], []
        for _ in range(n_steps):
            si = ray_intersect(scene, ray, active)
            valid = active & si.valid
            pdf_fwd = _to_area(pending_pdf_sw, prev_p, si.p, si.n)
            smooth = has_flag(bsdflib.bsdf_flags(mats, si.mat_id), BSDFFlags.Smooth)

            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, bsdf_w = bsdflib.sample(mats, tex, si, u1, u2, valid)
            wo_world = si.to_world(bs.wo)

            vert = FullVertex(
                p=si.p, ng=si.n, sh_s=si.sh_s, sh_t=si.sh_t, sh_n=si.sh_n, uv=si.uv,
                wi_world=si.wi_world, mat_id=si.mat_id, emitter_id=si.emitter_id,
                prim_idx=si.prim_idx, smooth=smooth, beta=beta, pdf_fwd=pdf_fwd,
                pdf_rev=torch.zeros((n,), dtype=m.Float, device=ray.o.device), valid=valid,
            )
            # reverse pdf of the previous vertex: the pdf of scattering back
            # toward it, with the new continuation as the incident side
            _, rev_sw = bsdflib.eval_pdf(mats, tex, _vert_si(vert, wo_world), si.wi, valid)
            verts.append(vert)
            rev_shift.append(_to_area(rev_sw, si.p, prev_p, prev_ng))
            d_in.append(ray.d)

            beta = beta * bsdf_w
            ray = si.spawn_ray(wo_world)
            active = valid & (m.max_component(beta) > 0.0) & (bs.pdf > 0.0)
            pending_pdf_sw, prev_p, prev_ng = bs.pdf, si.p, si.n
        # rev_shift[k] is the pdf_rev of vertex k-1: vertex i takes rev_shift[i+1]
        pdf_rev = torch.stack(rev_shift[1:] + [torch.zeros_like(rev_shift[0])], dim=0)
        verts = dataclasses.replace(_stack(verts), pdf_rev=pdf_rev)
        return verts, rev_shift[0], torch.stack(d_in, dim=0), sampler

    def _light_origin(self, scene, sampler, n):
        """Sample y0 on an area emitter; returns (FullVertex y0, the ray
        leaving it, the solid-angle pdf of its direction, sampler)."""
        em = scene.emitters
        geo = scene.geometry
        sampler, u_pos = sampler.next_2d()
        sampler, u_dir = sampler.next_2d()

        slot, u_re = em.face_dist.sample_reuse(u_pos[..., 0])
        slot = slot.long()
        face = em.em_face[slot]
        fidx = geo.faces[face.long()].long()
        v0, v1, v2 = (geo.vertices[fidx[:, k]] for k in range(3))
        b = warp.square_to_uniform_triangle(torch.stack([u_re, u_pos[..., 1]], dim=-1))
        p = v0 + (v1 - v0) * b[..., 0:1] + (v2 - v0) * b[..., 1:2]
        ng = m.normalize(m.cross(v1 - v0, v2 - v0))

        area = em.em_face_area[slot]
        p_area = m.safe_div(em.face_dist.prob(slot), area)
        em_id = em.em_face_emitter[slot]
        rad = em.radiance[em_id.long()]

        d_local = warp.square_to_cosine_hemisphere(u_dir)
        s_f, t_f = m.coordinate_system(ng)
        d = m.to_world(s_f, t_f, ng, d_local)
        cos0 = torch.clamp(m.dot(ng, d), min=0.0)
        pdf_dir_sw = cos0 * m.INV_PI

        dev = p.device
        y0 = FullVertex(
            p=p, ng=ng, sh_s=s_f, sh_t=t_f, sh_n=ng,
            uv=torch.zeros((n, 2), dtype=m.Float, device=dev),
            wi_world=ng,          # no predecessor; placeholder
            mat_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
            emitter_id=em_id,
            prim_idx=face.to(torch.int32),
            # an area-light origin is never delta (PBRT's IsConnectible)
            smooth=torch.ones((n,), dtype=torch.bool, device=dev),
            beta=rad * m.safe_rcp(p_area)[:, None],
            pdf_fwd=p_area,
            pdf_rev=torch.zeros((n,), dtype=m.Float, device=dev),
            valid=(p_area > 0.0) & (cos0 > 0.0),
        )
        return y0, Ray.make(p + ng * m.RAY_EPS, d), pdf_dir_sw, sampler

    def _emission_pdf_area(self, scene, v_at: FullVertex, p_to, ng_to):
        """Area pdf of the emitter at vertex v_at emitting toward p_to."""
        d = p_to - v_at.p
        dist2 = m.squared_norm(d)
        dn = d * m.rsqrt_safe(dist2)[..., None]
        pdf_sw = torch.clamp(m.dot(v_at.ng, dn), min=0.0) * m.INV_PI
        return pdf_sw * m.safe_div(torch.abs(m.dot(ng_to, dn)), dist2)

    def _pos_pdf_area(self, scene, v: FullVertex):
        """Area pdf of sampling the emissive face at vertex v as y0."""
        em = scene.emitters
        slot = em.face_to_slot[torch.clamp(v.prim_idx, min=0).long()]
        ok = (v.prim_idx >= 0) & (slot >= 0)
        slot_s = torch.clamp(slot, min=0).long()
        p_area = m.safe_div(em.face_dist.prob(slot_s), em.em_face_area[slot_s])
        return torch.where(ok, p_area, 0.0)

    def _scatter_pdf_area(self, scene, v: FullVertex, wi_world, wo_world, p_to, ng_to, active):
        """pdf of scattering at v (incident wi_world) toward wo_world, as an
        area pdf at p_to."""
        wo_local = m.to_local(v.sh_s, v.sh_t, v.sh_n, wo_world)
        _, pdf_sw = bsdflib.eval_pdf(scene.materials, scene.textures, _vert_si(v, wi_world),
                                     wo_local, active)
        return _to_area(pdf_sw, v.p, p_to, ng_to)

    def _eval_at(self, scene, v: FullVertex, wi_world, wo_world, active):
        """BSDF value (with |cos|) at v for incident wi_world and outgoing
        wo_world (both world, unit)."""
        wo_local = m.to_local(v.sh_s, v.sh_t, v.sh_n, wo_world)
        f, _ = bsdflib.eval_pdf(scene.materials, scene.textures, _vert_si(v, wi_world),
                                wo_local, active)
        return f

    @staticmethod
    def _vtx(path: FullVertex, i: int) -> FullVertex:
        return tmap(lambda a: a[i], path)

    @torch.no_grad()
    def sample(self, scene, sampler, ray, active=None):
        if not self.mis:
            return self._sample_reference(scene, sampler, ray, active)
        n = ray.o.shape[0]
        dev = ray.o.device
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=dev)
        D = self.max_depth          # max surface vertices on the full path
        f32 = dict(dtype=m.Float, device=dev)
        no = torch.zeros((n,), dtype=torch.bool, device=dev)

        # ---- camera subpath: zc[0] = first surface vertex (the camera
        # vertex is implicit: its edge pdfs cancel across t >= 2) ----
        zc, _, z_din, sampler = self._record_full(
            scene, sampler, ray, torch.ones((n, 3), **f32), torch.ones((n,), **f32),
            ray.o, ray.d, D, active,
        )
        # ---- environment: only the s=0 family reaches it -> weight 1 ----
        L = torch.zeros((n, 3), **f32)
        esc_prev_act = active
        for i in range(D):
            vi = self._vtx(zc, i)
            esc = esc_prev_act & ~vi.valid   # the ray into vertex i escaped
            L = L + torch.where(esc[:, None], vi.beta * eval_environment(scene, esc, z_din[i]),
                                0.0)
            esc_prev_act = esc_prev_act & vi.valid

        # ---- light subpath ----
        y0, lray, pdf_dir_sw, sampler = self._light_origin(scene, sampler, n)
        yv, y0_rev, _, sampler = self._record_full(
            scene, sampler, lray, y0.beta * m.PI, pdf_dir_sw, y0.p, y0.ng, max(D - 1, 0),
            y0.valid,
        )
        y0 = dataclasses.replace(y0, pdf_rev=y0_rev)

        zs = [self._vtx(zc, i) for i in range(D)]
        ys = [y0] + [self._vtx(yv, i) for i in range(max(D - 1, 0))]

        def mis_weight_st(s, t, rev_z, rev_y, delta_z, delta_y):
            """Power-heuristic weight of strategy (s, t) over the t' >= 2
            set; rev_* / delta_* map an index to an override of the
            recorded reverse pdf / delta flag."""
            def pz(i, which):
                v = zs[i - 1]   # z index 1.. maps to zs[0..]
                if which == "rev" and i in rev_z:
                    return rev_z[i]
                return v.pdf_rev if which == "rev" else v.pdf_fwd

            def py(i, which):
                v = ys[i]
                if which == "rev" and i in rev_y:
                    return rev_y[i]
                return v.pdf_rev if which == "rev" else v.pdf_fwd

            def dz(i):
                return delta_z.get(i, ~zs[i - 1].smooth)

            def dy(i):
                if i < 0:
                    return no
                return delta_y.get(i, ~ys[i].smooth)

            sum_ri = torch.zeros((n,), **f32)
            ri = torch.ones((n,), **f32)
            for i in range(t - 1, 1, -1):       # camera side: t' = i >= 2
                ri = ri * m.safe_div(_remap0(pz(i, "rev")), _remap0(pz(i, "fwd")))
                sum_ri = sum_ri + torch.where(~dz(i) & ~dz(i - 1), ri, 0.0)
            ri = torch.ones((n,), **f32)
            for i in range(s - 1, -1, -1):      # light side: s' = i
                ri = ri * m.safe_div(_remap0(py(i, "rev")), _remap0(py(i, "fwd")))
                sum_ri = sum_ri + torch.where(~dy(i) & ~dy(i - 1), ri, 0.0)
            return m.safe_rcp(1.0 + sum_ri)

        def visible(p_a, ng_a, p_b, act):
            d = p_b - p_a
            dist = m.norm(d)
            dn = d * m.safe_rcp(dist)[:, None]
            o = p_a + ng_a * (m.sign_not_zero(m.dot(ng_a, dn)) * m.RAY_EPS)[:, None]
            # end clearance relative to the distance (scale-safe)
            shadow = Ray(o=o, d=dn, maxt=dist * (1.0 - 1e-3))
            return ~ray_test(scene, shadow, act), dn, dist

        # ------------------------- strategies -------------------------
        for t in range(2, D + 2):
            zi = t - 2                       # zs index of z_{t-1}
            if zi >= D:
                break
            vz = zs[zi]

            # ---- s = 0: the camera path hits an emitter ----
            has_em = vz.valid & (vz.emitter_id >= 0)
            front = m.dot(vz.wi_world, vz.ng) > 0.0
            Le = scene.emitters.radiance[torch.clamp(vz.emitter_id, min=0).long()]
            rev_z = {t - 1: self._pos_pdf_area(scene, vz)}
            if t >= 3:
                rev_z[t - 2] = self._emission_pdf_area(scene, vz, zs[zi - 1].p, zs[zi - 1].ng)
            w0 = mis_weight_st(0, t, rev_z, {}, {t - 1: no}, {})
            L = L + torch.where((has_em & front)[:, None], vz.beta * Le * w0[:, None], 0.0)

            # ---- s >= 1: connections ----
            for s in range(1, D + 1):
                if (t - 1) + s > D:
                    break
                vy = ys[s - 1]
                if s == 1:
                    act = vz.valid & vz.smooth & y0.valid
                else:
                    act = vz.valid & vz.smooth & vy.valid & vy.smooth
                vis, dzy, dist = visible(vz.p, vz.ng, vy.p, act)
                act = act & vis & (dist > 1e-6)

                # f at the camera end (incident = stored, outgoing = to y)
                f_z = self._eval_at(scene, vz, vz.wi_world, dzy, act)
                if s == 1:
                    cos_y = torch.clamp(m.dot(vy.ng, -dzy), min=0.0)
                    f_y = cos_y[:, None] * torch.ones((n, 3), **f32)
                    act = act & (cos_y > 0.0)
                else:
                    f_y = self._eval_at(scene, vy, vy.wi_world, -dzy, act)

                C = vz.beta * f_z * f_y * vy.beta * m.safe_rcp(dist * dist)[:, None]

                # ---- MIS overrides of this connection ----
                rev_z = {}
                rev_y = {}
                # z_{t-1} generated from the light side
                if s == 1:
                    rev_z[t - 1] = self._emission_pdf_area(scene, vy, vz.p, vz.ng)
                else:
                    rev_z[t - 1] = self._scatter_pdf_area(scene, vy, vy.wi_world, -dzy, vz.p,
                                                          vz.ng, act)
                # z_{t-2} regenerated through z_{t-1} with the light side's wi
                if t >= 3:
                    rev_z[t - 2] = self._scatter_pdf_area(scene, vz, dzy, vz.wi_world,
                                                          zs[zi - 1].p, zs[zi - 1].ng, act)
                # y_{s-1} generated from the camera side
                rev_y[s - 1] = self._scatter_pdf_area(scene, vz, vz.wi_world, dzy, vy.p, vy.ng,
                                                      act)
                # y_{s-2} regenerated through y_{s-1} with the camera side's wi
                if s >= 2:
                    rev_y[s - 2] = self._scatter_pdf_area(scene, vy, -dzy, vy.wi_world,
                                                          ys[s - 2].p, ys[s - 2].ng, act)
                w = mis_weight_st(s, t, rev_z, rev_y, {}, {})
                L = L + torch.where(act[:, None], C * w[:, None], 0.0)

        L = torch.where(torch.isfinite(L), L, 0.0)
        return L, torch.ones((n,), dtype=torch.bool, device=dev), sampler

    # ------------------------------------------------------------------
    def _sample_reference(self, scene, sampler, ray, active=None):
        """The reference's semantics: unweighted (1, 1)."""
        n = ray.o.shape[0]
        camera_path, sampler = self.record_camera_path(scene, sampler, ray)
        light_path, sampler = self.record_light_path(scene, sampler, n)
        L = self.connect_bdpt(scene, 1, 1, camera_path, light_path)
        L = torch.where(torch.isfinite(L), L, 0.0)
        return L, torch.ones((n,), dtype=torch.bool, device=ray.o.device), sampler


register_integrator("bdpt", BDPTIntegrator)
