"""ReSTIR GI: streaming reservoir resampling with temporal reprojection and
spatial reuse.

Counterpart of ``mitsuba3_experiments_tpu.integrators.restir``: the
cross-frame state (reservoirs, the previous frame's samples, the search
radius, the previous camera) is an explicit `RestirState` threaded through
`render_frame`; reservoir update and merge are pure functions of records;
the spatial taps unroll in Python.  Each spatial tap tests the visibility
of the neighbour's sample point, and the bias correction tests each tap's
visible point again: every test is one any-hit query (one K1 launch on the
card).  The reservoir counters M and Z are int32 (uint32 in JAX); the
clamps keep them small.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core import warp
from ..core.records import Ray
from ..core.rng import Sampler
from ..core.struct import tgather, tmap, twhere
from ..intersect import ray_intersect, ray_test
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter
from .common import register_integrator
from .path import PathIntegrator


@dataclasses.dataclass(frozen=True)
class RestirSample:
    x_v: torch.Tensor   # (N, 3) visible point
    n_v: torch.Tensor   # (N, 3) visible normal
    x_s: torch.Tensor   # (N, 3) sample (second-bounce) point
    n_s: torch.Tensor   # (N, 3) sample normal
    L_o: torch.Tensor   # (N, 3) outgoing radiance at x_s towards x_v
    p_q: torch.Tensor   # (N,) source pdf of the initial direction
    valid: torch.Tensor  # (N,) bool

    @staticmethod
    def zeros(n, device=None):
        z3 = torch.zeros((n, 3), dtype=m.Float, device=device)
        return RestirSample(x_v=z3, n_v=z3, x_s=z3, n_s=z3, L_o=z3,
                            p_q=torch.zeros((n,), dtype=m.Float, device=device),
                            valid=torch.zeros((n,), dtype=torch.bool, device=device))


@dataclasses.dataclass(frozen=True)
class RestirReservoir:
    z: RestirSample
    w: torch.Tensor   # (N,) weight sum
    W: torch.Tensor   # (N,) contribution weight
    M: torch.Tensor   # (N,) int32 stream length

    @staticmethod
    def zeros(n, device=None):
        return RestirReservoir(
            z=RestirSample.zeros(n, device),
            w=torch.zeros((n,), dtype=m.Float, device=device),
            W=torch.zeros((n,), dtype=m.Float, device=device),
            M=torch.zeros((n,), dtype=torch.int32, device=device),
        )


def p_hat(L):
    return m.norm(L)


def reservoir_update(res, sampler, snew, wnew, active):
    """Streaming reservoir update; returns (reservoir, sampler)."""
    wnew = torch.where(active, wnew, 0.0)
    w = res.w + wnew
    M = res.M + active.to(torch.int32)
    sampler, u = sampler.next_1d()
    take = active & (u < m.safe_div(wnew, w))
    return dataclasses.replace(res, z=twhere(take, snew, res.z), w=w, M=M), sampler


def reservoir_merge(res, sampler, other, phat, active):
    """Merge reservoir `other` weighted by phat."""
    M0 = res.M
    res, sampler = reservoir_update(res, sampler, other.z, phat * other.W * other.M.to(m.Float),
                                    active)
    return dataclasses.replace(res, M=torch.where(active, M0 + other.M, M0)), sampler


def jacobian_J(receiver_pos, neighbor_res):
    """Solid-angle reuse Jacobian of moving a sample's receiver."""
    v_new = receiver_pos - neighbor_res.z.x_s
    d_new = m.norm(v_new)
    cos_new = torch.clamp(m.safe_div(m.dot(v_new, neighbor_res.z.n_s), d_new), 0, 1)
    v_old = neighbor_res.z.x_v - neighbor_res.z.x_s
    d_old = m.norm(v_old)
    cos_old = torch.clamp(m.safe_div(m.dot(v_old, neighbor_res.z.n_s), d_old), 0, 1)
    div = cos_old * d_new * d_new
    jac = torch.where(div > 0, cos_new * d_old * d_old / torch.clamp(div, min=1e-20), 0.0)
    return torch.where(torch.isfinite(jac), jac, 0.0)


@dataclasses.dataclass(frozen=True)
class RestirState:
    temporal: RestirReservoir
    spatial: RestirReservoir
    search_radius: torch.Tensor  # (N,)
    prev_sample: RestirSample
    prev_to_world: torch.Tensor  # (4, 4) previous camera
    frame: torch.Tensor          # () int32


@dataclasses.dataclass(frozen=True)
class RestirGI:
    """The reference's properties."""

    max_depth: int = 8
    rr_depth: int = 2
    bias_correction: bool = True
    jacobian: bool = True
    bsdf_sampling: bool = True
    max_M_temporal: int | None = 30
    max_M_spatial: int | None = 500
    initial_search_radius: float = 10.0
    minimal_search_radius: float = 3.0
    spatial_spatial_reuse: bool = False
    dist_threshold: float = 0.1
    angle_threshold: float = 25.0 * 3.14159265 / 180.0
    n_spatial_taps: int = 9
    # the reference taps only random neighbours; a guaranteed self-tap
    # (tap 0) helps pixels whose neighbourhood fails the similarity gate
    include_self_tap: bool = False

    # ------------------------------------------------------------------
    def init_state(self, scene) -> RestirState:
        w, h = scene.camera.resolution
        n = w * h
        dev = scene.device
        return RestirState(
            temporal=RestirReservoir.zeros(n, dev),
            spatial=RestirReservoir.zeros(n, dev),
            search_radius=torch.full((n,), self.initial_search_radius, dtype=m.Float,
                                     device=dev),
            prev_sample=RestirSample.zeros(n, dev),
            prev_to_world=scene.camera.to_world,
            frame=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def similar(self, s1, s2):
        ok = m.norm(s1.x_v - s2.x_v) < self.dist_threshold
        cos_t = torch.cos(torch.tensor(self.angle_threshold, dtype=m.Float))
        return ok & (m.dot(s1.n_v, s2.n_v) > cos_t.item())

    # ------------------------------------------------------------------
    def sample_initial(self, scene, sampler, pos_film):
        """The primary hit, one sampled bounce and the path radiance L_o
        arriving along it."""
        ray = sensorlib.sample_ray(scene.camera, pos_film)
        si = ray_intersect(scene, ray)
        emittance = eval_emitter(scene, si)

        sampler, u1 = sampler.next_1d()
        sampler, u2 = sampler.next_2d()
        if self.bsdf_sampling:
            bs, _ = bsdflib.sample(scene.materials, scene.textures, si, u1, u2, si.valid)
            wo, pdf = bs.wo, bs.pdf
        else:
            wo = warp.square_to_uniform_hemisphere(u2)
            pdf = warp.square_to_uniform_hemisphere_pdf(wo)

        ray2 = si.spawn_ray(si.to_world(wo))
        inner = PathIntegrator(max_depth=self.max_depth, rr_depth=self.rr_depth)
        L_o, _, sampler = inner.sample(scene, sampler, ray2, active=si.valid & (pdf > 0))
        si2 = ray_intersect(scene, ray2, si.valid)

        S = RestirSample(x_v=si.p, n_v=si.n, x_s=si2.p, n_s=si2.n, L_o=L_o, p_q=pdf,
                         valid=si.valid)
        return S, si, emittance, sampler

    # ------------------------------------------------------------------
    def temporal_resampling(self, scene, prev_sample, temporal_prev, prev_to_world, frame,
                            sampler, S):
        """`prev_sample` is the whole previous frame's sample buffer
        (gathered at the reprojected pixel); `temporal_prev` and `S` are
        this band's lanes."""
        w, h = scene.camera.resolution
        n = S.p_q.shape[0]
        dev = S.p_q.device
        prev_cam = dataclasses.replace(scene.camera, to_world=prev_to_world)
        pos_prev, _, vis = sensorlib.sample_direction(prev_cam, S.x_v)
        Sprev = tgather(prev_sample, self.to_idx(pos_prev, w, h))
        valid = vis & self.similar(S, Sprev) & (frame > 0)

        zero_r = RestirReservoir.zeros(n, dev)
        R = twhere(valid, temporal_prev, zero_r)
        every = torch.ones_like(valid)
        phat_s = p_hat(S.L_o)
        w_s = torch.where(S.p_q > 0, m.safe_div(phat_s, S.p_q), 0.0)
        Rnew, sampler = reservoir_update(zero_r, sampler, S, w_s, every)
        Rnew, sampler = reservoir_merge(Rnew, sampler, R, p_hat(R.z.L_o), every)
        phat = p_hat(Rnew.z.L_o)
        W = torch.where(phat * Rnew.M > 0,
                        m.safe_div(Rnew.w, Rnew.M.to(m.Float) * phat), 0.0)
        M = Rnew.M
        if self.max_M_temporal is not None:
            M = torch.clamp(M, max=self.max_M_temporal)
        return dataclasses.replace(Rnew, W=W, M=M), sampler

    @staticmethod
    def to_idx(pos, w, h):
        x = torch.clamp(m.to_int32(pos[..., 0]), 0, w - 1)
        y = torch.clamp(m.to_int32(pos[..., 1]), 0, h - 1)
        return y * w + x

    # ------------------------------------------------------------------
    def spatial_resampling(self, scene, S_full, temporal_full, spatial_prev, search_radius,
                           sampler, S, pos_pix):
        """The spatial taps, the adaptive radius and the bias correction Z.
        Taps gather from the whole current frame's buffers (`S_full`,
        `temporal_full`); `spatial_prev`, `search_radius`, `S` and
        `pos_pix` are this band's lanes."""
        w, h = scene.camera.resolution
        n = S.p_q.shape[0]
        dev = S.p_q.device
        Rs = spatial_prev
        Rnew = RestirReservoir.zeros(n, dev)
        Z = torch.zeros((n,), dtype=torch.int32, device=dev)
        every = torch.ones((n,), dtype=torch.bool, device=dev)

        if self.spatial_spatial_reuse:
            Rnew, sampler = reservoir_merge(Rnew, sampler, Rs, p_hat(Rs.z.L_o), every)
            Z = Z + Rs.M

        if self.max_M_spatial is not None:
            max_iter = torch.where(Rs.M < self.max_M_spatial / 2, self.n_spatial_taps, 3)
        else:
            max_iter = torch.full((n,), self.n_spatial_taps, dtype=torch.int32, device=dev)

        any_reused = torch.zeros((n,), dtype=torch.bool, device=dev)
        taps = []  # (M, p, n, active) per tap, for the bias correction
        for s in range(self.n_spatial_taps + self.include_self_tap):
            if self.include_self_tap and s == 0:
                active = every
                offset = torch.zeros((n, 2), dtype=m.Float, device=dev)
            else:
                active = s < max_iter
                sampler, u2 = sampler.next_2d()
                offset = warp.square_to_uniform_disk_concentric(u2) * search_radius[:, None]
            idx = self.to_idx(pos_pix + offset, w, h)
            active = active & self.similar(tgather(S_full, idx), S)
            Rn = twhere(active, tgather(temporal_full, idx), RestirReservoir.zeros(n, dev))

            # visibility of the neighbour's sample point from our visible point
            shadowed = ray_test(scene, _spawn_to(S.x_v, S.n_v, Rn.z.x_s), active)
            jac = torch.clamp(jacobian_J(S.x_v, Rn), 0.0, 1000.0) if self.jacobian else 1.0
            phat_n = torch.where((~active) | shadowed, 0.0, p_hat(Rn.z.L_o) * jac)
            Rnew, sampler = reservoir_merge(Rnew, sampler, Rn, phat_n, active)
            taps.append((Rn.M, Rn.z.x_v, Rn.z.n_v, active))
            any_reused = any_reused | active

        phat = p_hat(Rnew.z.L_o)
        if self.bias_correction:
            for M_i, p_i, n_i, act_i in taps:
                unshadowed = ~ray_test(scene, _spawn_to(Rnew.z.x_s, Rnew.z.n_s, p_i), act_i)
                Z = Z + torch.where(act_i & unshadowed, M_i, 0)
            Zf = Z.to(m.Float)
            W = torch.where(Zf * phat > 0, m.safe_div(Rnew.w, Zf * phat), 0.0)
        else:
            W = torch.where(phat * Rnew.M > 0,
                            m.safe_div(Rnew.w, Rnew.M.to(m.Float) * phat), 0.0)
        search_radius = torch.clamp(torch.where(any_reused, search_radius, search_radius / 2),
                                    min=self.minimal_search_radius)
        M = Rnew.M
        if self.max_M_spatial is not None:
            M = torch.clamp(M, max=self.max_M_spatial)
        return dataclasses.replace(Rnew, W=W, M=M), search_radius, sampler

    # ------------------------------------------------------------------
    # per-band stages (pix = a band of pixel lanes, int64)
    def stage_initial(self, scene, seed, pix):
        w = scene.camera.resolution[0]
        sampler = Sampler.create(seed, lane=pix).fork(1)
        sampler, jitter = sampler.next_2d()
        pos_film = torch.stack([(pix % w).to(m.Float), (pix // w).to(m.Float)], dim=-1) + jitter
        S, si_v, emittance, _ = self.sample_initial(scene, sampler, pos_film)
        return S, si_v, emittance

    def stage_temporal(self, scene, state_band_and_full, seed, pix, S):
        prev_sample_full, temporal_prev, prev_to_world, frame = state_band_and_full
        sampler = Sampler.create(seed, lane=pix).fork(2)
        temporal, _ = self.temporal_resampling(scene, prev_sample_full, temporal_prev,
                                               prev_to_world, frame, sampler, S)
        return temporal

    def stage_spatial(self, scene, S_full, temporal_full, spatial_prev, search_radius, seed,
                      pix, S):
        w = scene.camera.resolution[0]
        pos_pix = torch.stack([(pix % w).to(m.Float), (pix // w).to(m.Float)], dim=-1)
        sampler = Sampler.create(seed, lane=pix).fork(3)
        return self.spatial_resampling(scene, S_full, temporal_full, spatial_prev,
                                       search_radius, sampler, S, pos_pix)[:2]

    @staticmethod
    def stage_shade(scene, spatial, si_v, emittance):
        """Final shading of the spatial reservoir's sample."""
        R = spatial
        dir_to_s = m.normalize(R.z.x_s - si_v.p)
        f_val, _ = bsdflib.eval_pdf(scene.materials, scene.textures, si_v,
                                    si_v.to_local(dir_to_s), si_v.valid)
        result = f_val * R.z.L_o * R.W[:, None] + emittance
        return torch.where(torch.isfinite(result), result, 0.0)

    @torch.no_grad()
    def render_frame(self, scene, state: RestirState, seed):
        """One whole frame; returns (image (H, W, 3), state)."""
        w, h = scene.camera.resolution
        pix = torch.arange(w * h, dtype=torch.int64, device=scene.device)
        S, si_v, emittance = self.stage_initial(scene, seed, pix)
        temporal = self.stage_temporal(
            scene, (state.prev_sample, state.temporal, state.prev_to_world, state.frame),
            seed, pix, S)
        spatial, search_radius = self.stage_spatial(scene, S, temporal, state.spatial,
                                                    state.search_radius, seed, pix, S)
        img = self.stage_shade(scene, spatial, si_v, emittance).reshape(h, w, 3)
        return img, RestirState(temporal=temporal, spatial=spatial, search_radius=search_radius,
                                prev_sample=S, prev_to_world=scene.camera.to_world,
                                frame=state.frame + 1)

    @torch.no_grad()
    def render_frame_chunked(self, scene, state: RestirState, seed, chunk: int = 32768):
        """The frame in pixel bands of `chunk` lanes, stage by stage, each
        stage reading the whole frame's buffers of the stages before it.
        Stage draws are keyed by (pixel, stage), not by band, so this equals
        `render_frame`."""
        w, h = scene.camera.resolution
        n = w * h
        chunk = min(chunk, n)
        dev = scene.device

        def band(off):
            """lanes [off, off+chunk), the tail clamped to the last lane"""
            return torch.clamp(torch.arange(off, off + chunk, dtype=torch.int64, device=dev),
                               max=n - 1)

        def bands(stage_fn):
            outs = [stage_fn(band(off)) for off in range(0, n, chunk)]
            return tmap(lambda *xs: torch.cat(xs, dim=0)[:n], *outs)

        S, si_v, emittance = bands(lambda idx: self.stage_initial(scene, seed, idx))
        temporal = bands(lambda idx: self.stage_temporal(
            scene, (state.prev_sample, tgather(state.temporal, idx), state.prev_to_world,
                    state.frame), seed, idx, tgather(S, idx)))
        spatial, search_radius = bands(lambda idx: self.stage_spatial(
            scene, S, temporal, tgather(state.spatial, idx), state.search_radius[idx], seed,
            idx, tgather(S, idx)))
        img = bands(lambda idx: self.stage_shade(
            scene, tgather(spatial, idx), tgather(si_v, idx), emittance[idx])).reshape(h, w, 3)
        return img, RestirState(temporal=temporal, spatial=spatial, search_radius=search_radius,
                                prev_sample=S, prev_to_world=scene.camera.to_world,
                                frame=state.frame + 1)


def _spawn_to(p, n_vec, target):
    d = target - p
    dist = m.norm(d)
    d = d * m.safe_rcp(dist)[:, None]
    sign = m.sign_not_zero(m.dot(n_vec, d))
    o = p + n_vec * (sign * m.RAY_EPS)[:, None]
    return Ray(o=o, d=d, maxt=dist * (1.0 - 1e-3) - m.RAY_EPS)


register_integrator("restirgi", RestirGI)
