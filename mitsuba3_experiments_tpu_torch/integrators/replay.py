"""Path-replay gradients: record without autograd, differentiate the replay.

Counterpart of ``mitsuba3_experiments_tpu.integrators.replay``.  The path
geometry (hit points, sampled directions, Russian-roulette decisions) does
not depend on the differentiated tables (material base colours, emitter
radiance), so the traversal stays out of the autograd graph:

  1. RECORD: the forward wavefront (persistent.trace_rays, K1 on the card)
     writes per (camera ray, depth) the closest hit's (prim, u, v) and the
     NEE shadow ray's occlusion bit into a PathRecord.  Everything else is
     rebuilt from the counter-based draws keyed by (camera ray, dimension).
  2. REPLAY: the forward's own shading (persistent._shade) of each recorded
     hit, with the recorded visibility in place of the shadow query.  On
     the card `replay_radiance` is K5 (integrators/replay_cuda.py,
     csrc/replay_path.cu) behind the autograd.Function `ReplayRadiance`:
     one launch walks every row's path for L, one walks it again for the
     gradients of materials.base_color and emitters.radiance.  Its plain
     version, `replay_radiance_plain`, is a Python loop over depth with
     torch autograd through the material and emitter table reads; the CPU
     runs it.  `jax.lax.stop_gradient` becomes `.detach()` at the same
     places (the RR probability and the throughput test, inside `_shade`).
  3. GRADIENTS (`replay_grads`): on the card a step-level loop
     (`_CardReplay`) with no autograd and no host wait inside it: K5's
     scene packed once, each chunk's K5 forward, its film adjoint dL formed
     explicitly (`render.film.gather_taps`), K5's adjoint adding into two
     table gradients, then one backward pass through `update_fn` a call.
     The CPU differentiates the plain replay chunk by chunk under autograd.

The JAX package's `_prim_encode` / `_prim_decode` (a TPU flush-to-zero
workaround) are not needed: the record keeps prim as int32.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from .. import resolve_device
from ..core import math as m
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..scene.params import PARAM_KEYS
from ..scene.types import Scene
from ..utils.profile import count, span
from . import persistent as pp
from . import replay_cuda
from .wavefront import _rand


# replay_radiance_plain calls (a plain int, read by tests and the smoke test)
plain_calls = 0


@dataclasses.dataclass(frozen=True)
class PathRecord:
    """Per-(row, depth) facts of traced paths the replay cannot rebuild."""

    prim: torch.Tensor  # (N, D) int32 hit face id, -1 = miss / not traced
    u: torch.Tensor     # (N, D) float32 barycentric
    v: torch.Tensor     # (N, D) float32
    occl: torch.Tensor  # (N, D) bool NEE shadow ray occluded

    @staticmethod
    def empty(n: int, d: int, device=None):
        dev = resolve_device(device)
        return PathRecord(
            prim=torch.full((n, d), -1, dtype=torch.int32, device=dev),
            u=torch.zeros((n, d), dtype=torch.float32, device=dev),
            v=torch.zeros((n, d), dtype=torch.float32, device=dev),
            occl=torch.zeros((n, d), dtype=torch.bool, device=dev),
        )

    def rows(self, sel) -> "PathRecord":
        """The record of rows `sel` (a slice or an index tensor)."""
        return PathRecord(*(getattr(self, f.name)[sel] for f in dataclasses.fields(self)))


def record_chunk(scene: Scene, seed, idx0: int, n: int, *, spp: int, max_depth: int,
                 rr_depth: int, ray_end=None, n_lanes: int = pp.N_LANES):
    """PathRecord of camera rays idx0 .. idx0 + n (row r = ray idx0 + r);
    rays at or past `ray_end` are not traced and their rows stay empty."""
    end = idx0 + n if ray_end is None else min(int(ray_end), idx0 + n)
    rec = PathRecord.empty(n, max_depth, scene.device)
    pp.trace_rays(scene, seed, idx0, n, max(end - idx0, 0), spp=spp, max_depth=max_depth,
                  rr_depth=rr_depth, n_lanes=n_lanes, rec=rec)
    return rec


def record_frame(scene: Scene, seed, n_rays: int, *, spp: int, max_depth: int,
                 rr_depth: int, n_lanes: int = pp.N_LANES, pad_to: int | None = None):
    """(PathRecord, per-ray radiance) of all camera rays 0 .. n_rays, both
    padded to `pad_to` rows (rows past n_rays stay empty: prim -1, replayed
    as misses, radiance 0)."""
    rows = max(pad_to or n_rays, n_rays)
    rec = PathRecord.empty(rows, max_depth, scene.device)
    rayL = pp.trace_rays(scene, seed, 0, rows, n_rays, spp=spp, max_depth=max_depth,
                         rr_depth=rr_depth, n_lanes=n_lanes, rec=rec)
    return rec, rayL


def record_full(scene: Scene, seed, n_rays: int, *, spp: int, max_depth: int,
                rr_depth: int, n_lanes: int = pp.N_LANES, pad_to: int | None = None):
    """PathRecord of all camera rays 0 .. n_rays, padded to `pad_to` rows."""
    return record_frame(scene, seed, n_rays, spp=spp, max_depth=max_depth, rr_depth=rr_depth,
                        n_lanes=n_lanes, pad_to=pad_to)[0]


def _rows(scene: Scene, rec: PathRecord, seed, idx0, spp: int, ray_end, idx):
    """(camera-ray index (N,) int64, film position (N, 2), active (N,)) of
    a record's rows."""
    n = rec.prim.shape[0]
    dev = rec.prim.device
    idx = torch.arange(int(idx0), int(idx0) + n, dtype=torch.int64, device=dev) if idx is None \
        else idx.to(torch.int64)
    act0 = torch.ones((n,), dtype=torch.bool, device=dev) if ray_end is None \
        else idx < int(ray_end)
    return idx, _positions(scene.camera, seed, idx, spp), act0


def _positions(camera, seed, idx, spp: int):
    """persistent.ray_positions of camera rays `idx`, bit for bit, with the
    jitter's dimension a host int, so that its TEA key is two host ints
    rather than ~300 device operations a call."""
    px, py = pp.ray_pixel(camera, idx // spp)
    return torch.stack([px, py], dim=-1) + _rand(seed, idx, 0, 2)


def replay_radiance_plain(scene: Scene, rec: PathRecord, seed, idx0, *, spp: int,
                          max_depth: int, rr_depth: int, ray_end=None, idx=None,
                          n_steps: int | None = None):
    """K5's plain version: the per-row radiance of a PathRecord as a Python
    loop over depth of the forward's own torch operators, differentiable by
    autograd with respect to every scene tensor: (L (N, 3), film pos (N, 2),
    act0 (N,) bool).  Row r is camera ray idx0 + r, or idx[r] when `idx`
    (int64) is given; rows at or past `ray_end` are inactive.  `n_steps`
    truncates the depth loop, exactly for rows whose path needs at most
    n_steps steps (path_lengths); the loop also ends once no row is active,
    since every later step adds nothing."""
    global plain_calls
    plain_calls += 1
    n = rec.prim.shape[0]
    dev = rec.prim.device
    idx, pos, act0 = _rows(scene, rec, seed, idx0, spp, ray_end, idx)

    # the camera ray, exactly as the recorder armed it
    ray0 = sensorlib.sample_ray(scene.camera, pos)

    L = torch.zeros((n, 3), dtype=m.Float, device=dev)
    f = torch.ones((n, 3), dtype=m.Float, device=dev)
    eta = torch.ones((n,), dtype=m.Float, device=dev)
    prev_p, prev_pdf = ray0.o, torch.ones((n,), dtype=m.Float, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    o, d, act = ray0.o, ray0.d, act0
    depth = torch.ones((n,), dtype=torch.int32, device=dev)
    d_use = rec.prim.shape[1] if n_steps is None else min(n_steps, rec.prim.shape[1])
    kw = dict(max_depth=max_depth, rr_depth=rr_depth)
    for k in range(d_use):
        with span("m3t.wait"):
            any_active = bool(act.any())
        if not any_active:
            break
        # the forward's shading of the recorded hit, with the recorded
        # visibility in place of the shadow query
        prim = rec.prim[:, k]
        t = torch.where(prim >= 0, 1.0, m.INF)
        sh = pp._shade(scene, seed, act, o, d, t, prim, rec.u[:, k], rec.v[:, k], L, f, eta,
                       depth, prev_p, prev_pdf, prev_delta, idx, **kw)
        L = sh.L + torch.where((~rec.occl[:, k])[:, None], sh.nee_L, 0.0)

        # commit the lanes that go on; the rest keep their state
        adv = act & sh.cont
        f = torch.where(adv[:, None], sh.f, f)
        eta = torch.where(adv, sh.eta, eta)
        prev_p = torch.where(act[:, None], sh.p, prev_p)
        prev_pdf = torch.where(act, sh.pdf, prev_pdf)
        prev_delta = torch.where(act, sh.delta, prev_delta)
        o = torch.where(adv[:, None], sh.next_o, o)
        d = torch.where(adv[:, None], sh.next_d, d)
        act = adv
        depth = torch.where(adv, depth + 1, depth)
    return L, pos, act0


# the scene tensors K5 differentiates; replay_radiance raises on the card if
# another of scene/params.py's keys requires a gradient
K5_KEYS = ("materials.base_color", "emitters.radiance")


def _on_card(device) -> bool:
    return device.type == "cuda"


def _check_k5_keys(scene: Scene):
    """Raises, naming them, if keys K5 does not differentiate require a
    gradient."""
    others = [k for k in PARAM_KEYS if k not in K5_KEYS and PARAM_KEYS[k](scene).requires_grad]
    if others:
        raise ValueError(f"K5 differentiates only {', '.join(K5_KEYS)}; the replay on the card "
                         f"cannot differentiate {', '.join(others)}")


class ReplayRadiance(torch.autograd.Function):
    """L (N, 3) of a PathRecord chunk on the card as a function of the
    tables `base_color` (M, 3) and `radiance` (E, 3), which are `job.scene`'s
    own: forward launches K5's forward kernel, backward its adjoint.  `job`
    holds the rest of replay_radiance's arguments."""

    @staticmethod
    def forward(ctx, base_color, radiance, job):
        ctx.job = job
        return replay_cuda.replay_forward(replay_cuda.pack_args(job.scene, job.rec, **job.kw))

    @staticmethod
    def backward(ctx, dL):
        job = ctx.job
        g_bc, g_rad = replay_cuda.replay_adjoint(
            replay_cuda.pack_args(job.scene, job.rec, **job.kw), dL)
        want = ctx.needs_input_grad
        return (g_bc if want[0] else None), (g_rad if want[1] else None), None


def replay_radiance(scene: Scene, rec: PathRecord, seed, idx0, *, spp: int, max_depth: int,
                    rr_depth: int, ray_end=None, idx=None, n_steps: int | None = None):
    """Differentiable per-row radiance of a PathRecord: (L (N, 3), film pos
    (N, 2), act0 (N,) bool), as replay_radiance_plain gives it.  On the card
    L comes from K5 through ReplayRadiance, which differentiates
    materials.base_color and emitters.radiance; another scene key that
    requires a gradient (materials.params, textures.data, camera.to_world)
    raises there.  On the CPU it is replay_radiance_plain, which
    differentiates every key."""
    kw = dict(seed=seed, idx0=idx0, spp=spp, max_depth=max_depth, rr_depth=rr_depth,
              ray_end=ray_end, idx=idx, n_steps=n_steps)
    if not _on_card(rec.prim.device):
        return replay_radiance_plain(scene, rec, **kw)
    _check_k5_keys(scene)
    L = ReplayRadiance.apply(scene.materials.base_color, scene.emitters.radiance,
                             SimpleNamespace(scene=scene, rec=rec, kw=kw))
    _, pos, act0 = _rows(scene, rec, seed, idx0, spp, ray_end, idx)
    return L, pos, act0


def _splat(scene, L, pos, act0, rfilter):
    w, h = scene.camera.resolution
    film = filmlib.new_film(w, h, device=L.device)
    return filmlib.put(film, pos, torch.where(torch.isfinite(L), L, 0.0), active=act0,
                       rfilter=rfilter)


def _grad(scene, params, update_fn, objective):
    """Gradients of objective(update_fn(scene, p)) with respect to every
    tensor of `params`, as a dict (zeros where a tensor is not reached)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = objective(update_fn(scene, p))
    gs = torch.autograd.grad(out, list(p.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), gs)}


def _replay_grad_impl(scene, params, update_fn, rec, target, seed, idx0, ray_end, *,
                      spp: int, max_depth: int, rr_depth: int, rfilter: str):
    """Gradient of one chunk's MSE against `target` over the pixels the
    chunk covers (its own film, developed)."""
    def loss(s):
        L, pos, act0 = replay_radiance(s, rec, seed, idx0, spp=spp, max_depth=max_depth,
                                       rr_depth=rr_depth, ray_end=ray_end)
        with span("m3t.replay.loss"):
            film = _splat(s, L, pos, act0, rfilter)
            img = filmlib.develop(film)
            msk = (film[..., 3] > 0.0)[..., None]
            return torch.where(msk, (img - target) ** 2, 0.0).sum()

    return _grad(scene, params, update_fn, loss)


def _add(acc, g):
    return g if acc is None else {k: acc[k] + g[k] for k in acc}


def _check_chunks(rec, chunk):
    rows = rec.prim.shape[0]
    if rows % chunk:
        raise ValueError(f"the record's {rows} rows are not a multiple of chunk {chunk}")
    return rows


def _film_adjoint(film, target):
    """d/dS of the squared error of develop(film) against `target` over the
    covered pixels, S the film's summed radiance: 2 (S/w - target) / w
    where the filter weight w > 0 (w does not depend on the radiance;
    S/w there is develop's quotient)."""
    wgt = film[..., 3:4]
    cov = wgt > 0.0
    w = torch.where(cov, wgt, 1.0)
    return torch.where(cov, 2.0 * (film[..., :3] / w - target) / w, 0.0)


def _put(film, L, ok, taps):
    """_splat of a chunk's L (`ok` its finite entries, `taps` its film
    positions' filter taps) into `film`, in place."""
    return filmlib.put_taps(film, taps, torch.where(ok, L, 0.0))


def _splat_adjoint(adj, ok, taps):
    """dL of <adj, _splat(L)[..., :3]>: the filter's transpose of `adj`, 0
    where L is not finite (_splat passes no derivative there)."""
    return torch.where(ok, filmlib.gather_taps(adj, taps), 0.0)


class _CardReplay:
    """replay_grads on the card as one step-level loop with no autograd and
    no host wait inside it: `update_fn(scene, params)` evaluated once (the
    tables, with `params` requiring grad), K5's scene packed once, and the
    gradients of the two tables K5 differentiates accumulated over the
    chunks by K5's adjoint; `grads` then takes one backward pass through
    `update_fn`, which is linear in them, so one pass equals the sum of a
    pass a chunk.  Each chunk: `forward` (K5's forward), the caller's dL,
    `adjoint` (K5's adjoint)."""

    def __init__(self, scene, params, update_fn, rec, seed, *, chunk: int, spp: int,
                 max_depth: int, rr_depth: int, rfilter: str):
        self.p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        self.tables = t = update_fn(scene, self.p)
        _check_k5_keys(t)
        dev = rec.prim.device
        self.seed, self.spp, self.rfilter = seed, spp, rfilter
        w, h = scene.camera.resolution
        self.film_hw = (h, w)
        self.packed = replay_cuda.pack_step(t, dev, seed, spp=spp, max_depth=max_depth,
                                            rr_depth=rr_depth)
        self.g = (torch.zeros(t.materials.base_color.shape, dtype=torch.float32, device=dev),
                  torch.zeros(t.emitters.radiance.shape, dtype=torch.float32, device=dev))
        self.scratch = torch.empty((rec.prim.shape[1], 6, chunk), dtype=torch.float32,
                                   device=dev)

    def forward(self, rec, idx0, ray_end, idx=None, n_steps=None):
        """(L (N, 3), its finite entries, the filter taps of its film
        positions) of a record chunk from one K5 forward launch; L as
        replay_radiance gives it."""
        replay_cuda.bind_rows(self.packed, rec, idx0, ray_end=ray_end, idx=idx, n_steps=n_steps)
        L = replay_cuda.replay_forward(self.packed)
        count("m3t.replay.step_rows", int(rec.prim.shape[0]))
        _, pos, act0 = _rows(self.tables, rec, self.seed, idx0, self.spp, ray_end, idx)
        return L, torch.isfinite(L), filmlib.taps(pos, act0, self.rfilter, *self.film_hw)

    def adjoint(self, dL):
        """K5's adjoint of the chunk `forward` last bound, added into the
        tables' gradients."""
        replay_cuda.replay_adjoint(self.packed, dL, out=self.g, scratch=self.scratch)

    def grads(self):
        """The gradients with respect to every tensor of `params`, as a dict
        (zeros where a tensor is not reached), as `_grad` gives them."""
        t = self.tables
        outs = [(x, g) for x, g in zip((t.materials.base_color, t.emitters.radiance), self.g)
                if x.requires_grad]
        gs = (torch.autograd.grad([x for x, _ in outs], list(self.p.values()),
                                  grad_outputs=[g for _, g in outs], allow_unused=True)
              if outs else [None] * len(self.p))
        return {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(self.p.items(), gs)}


def replay_grads_full(scene: Scene, params: dict, update_fn, target, seed, rec: PathRecord,
                      n_rays: int, *, chunk: int, spp: int, max_depth: int, rr_depth: int,
                      rfilter: str = "box"):
    """Gradients over a whole-frame PathRecord (rows a multiple of
    `chunk`), summed over chunks of `chunk` rows, each with its own MSE
    (exact for the box filter: chunks of consecutive rays cover disjoint
    pixels when chunk is a multiple of spp).  On the card a chunk's dL is
    the adjoint of its own film's MSE, put back through the filter."""
    rows = _check_chunks(rec, chunk)
    kw = dict(spp=spp, max_depth=max_depth, rr_depth=rr_depth)
    if not _on_card(rec.prim.device):
        acc = None
        for off in range(0, rows, chunk):
            with span("m3t.replay.chunk"):
                g = _replay_grad_impl(scene, params, update_fn, rec.rows(slice(off, off + chunk)),
                                      target, seed, off, min(off + chunk, n_rays),
                                      rfilter=rfilter, **kw)
                acc = _add(acc, g)
        return acc
    card = _CardReplay(scene, params, update_fn, rec, seed, chunk=chunk, rfilter=rfilter, **kw)
    w, h = scene.camera.resolution
    film = filmlib.new_film(w, h, device=rec.prim.device)
    for off in range(0, rows, chunk):
        with span("m3t.replay.chunk"):
            L, ok, taps = card.forward(rec.rows(slice(off, off + chunk)), off,
                                       min(off + chunk, n_rays))
            with span("m3t.replay.loss"):
                dL = _splat_adjoint(_film_adjoint(_put(film.zero_(), L, ok, taps), target), ok,
                                    taps)
            card.adjoint(dL)
    return card.grads()


def path_lengths(rec: PathRecord):
    """(rows,) int32: the depth steps that replay row i exactly — one past
    its last recorded hit (that step adds the escape), at most D."""
    D = rec.prim.shape[1]
    depth_ix = torch.arange(1, D + 1, dtype=torch.int32, device=rec.prim.device)[None, :]
    last_hit = torch.amax(torch.where(rec.prim >= 0, depth_ix, 0), dim=1)
    return torch.clamp(last_hit + 1, max=D).to(torch.int32)


def _depth_classes(D: int):
    """Doubling ladder of depth-loop lengths {1, 2, 4, ..., D}."""
    cs = []
    c = 1
    while c < D:
        cs.append(c)
        c *= 2
    cs.append(D)
    return cs


def replay_grads_sorted(scene: Scene, params: dict, update_fn, target, seed, rec: PathRecord,
                        n_rays: int, *, chunk: int, spp: int, max_depth: int, rr_depth: int,
                        rfilter: str = "box", film=None):
    """Gradients over a whole-frame PathRecord with rows sorted by path
    length, so that each chunk's depth loop runs only as long as the class
    of its longest path.  Sorted chunks share pixels, so the MSE is
    decomposed through the film adjoint: adj = 2 (S/w - target) / w on
    covered pixels (S the summed radiance, w the filter weight, which does
    not depend on the parameters), computed once from the forward film, and
    each chunk adds the gradient of <adj, S_chunk>.  `film` (optional) is
    that forward film, weight channel included (record_full_pipelined with
    return_film=True); without it a forward pass over the sorted chunks
    makes it."""
    rows = _check_chunks(rec, chunk)
    lens = path_lengths(rec)
    order = torch.argsort(-lens, stable=True)
    n_chunks = rows // chunk
    classes = _depth_classes(rec.prim.shape[1])
    with span("m3t.wait"):
        longest = lens[order[::chunk]].tolist()
    cls = [min(c for c in classes if c >= int(mx)) for mx in longest]
    kw = dict(spp=spp, max_depth=max_depth, rr_depth=rr_depth, ray_end=n_rays)
    card = (_CardReplay(scene, params, update_fn, rec, seed, chunk=chunk, spp=spp,
                        max_depth=max_depth, rr_depth=rr_depth, rfilter=rfilter)
            if _on_card(rec.prim.device) else None)

    def chunk_rows(j):
        oj = order[j * chunk:(j + 1) * chunk]
        return rec.rows(oj), oj

    def replayed(s, j):
        """Chunk j replayed: on the card K5's forward as _CardReplay.forward
        gives it, else replay_radiance's (L, pos, act0) on the scene `s`."""
        sl, oj = chunk_rows(j)
        if card is not None:
            return card.forward(sl, 0, n_rays, idx=oj, n_steps=cls[j])
        return replay_radiance(s, sl, seed, 0, idx=oj, n_steps=cls[j], **kw)

    if film is None:
        w, h = scene.camera.resolution
        film = filmlib.new_film(w, h, device=rec.prim.device)
        with torch.no_grad():
            for j in range(n_chunks):
                with span("m3t.replay.chunk"):
                    if card is not None:
                        _put(film, *replayed(None, j))
                    else:
                        film = film + _splat(scene, *replayed(scene, j), rfilter)
    with span("m3t.replay.loss"):
        adj = _film_adjoint(film, target).detach()

    if card is not None:
        for j in range(n_chunks):
            with span("m3t.replay.chunk"):
                _, ok, taps = replayed(None, j)
                with span("m3t.replay.loss"):
                    dL = _splat_adjoint(adj, ok, taps)
                card.adjoint(dL)
        return card.grads()
    acc = None
    for j in range(n_chunks):
        with span("m3t.replay.chunk"):
            def inner(s, j=j):
                L, pos, act0 = replayed(s, j)
                with span("m3t.replay.loss"):
                    return (adj * _splat(s, L, pos, act0, rfilter)[..., :3]).sum()

            acc = _add(acc, _grad(scene, params, update_fn, inner))
    return acc


def replay_grads(scene: Scene, params: dict, update_fn, target, seed, rec: PathRecord,
                 n_rays: int, *, chunk: int, spp: int, max_depth: int, rr_depth: int,
                 rfilter: str = "box", mode: str = "auto", film=None):
    """The production fwd+bwd replay.  mode 'auto' takes 'sorted' when
    max_depth >= 16 (deep paths: most die early, so sorted chunks loop
    short), else 'full'.  'trunc' is 'full': the JAX package cuts each
    chunk's depth loop to the class of its longest path, and the port's
    replay_radiance already leaves a chunk's loop once no row is active, so
    the cut changes neither the result nor the steps run.  `film` is passed
    on to the sorted mode."""
    if mode == "auto":
        mode = "sorted" if max_depth >= 16 else "full"
    kw = dict(chunk=chunk, spp=spp, max_depth=max_depth, rr_depth=rr_depth, rfilter=rfilter)
    if mode in ("full", "trunc"):
        return replay_grads_full(scene, params, update_fn, target, seed, rec, n_rays, **kw)
    if mode == "sorted":
        return replay_grads_sorted(scene, params, update_fn, target, seed, rec, n_rays,
                                   film=film, **kw)
    raise ValueError(f"replay mode {mode!r}: the port has 'auto', 'full', 'sorted' and 'trunc'")


def replay_render_grad(scene: Scene, params: dict, update_fn, target, seed, idx0: int, n: int,
                       *, spp: int, max_depth: int, rr_depth: int, rfilter: str = "box",
                       ray_end=None, n_lanes: int = pp.N_LANES):
    """One chunk of the fwd+bwd workload: record camera rays idx0 .. idx0+n
    (no autograd), then the gradient of the replayed chunk's MSE with
    respect to `params`.  `update_fn(scene, params) -> scene` rebinds the
    differentiated tables (scene.params.update)."""
    rec = record_chunk(scene, seed, idx0, n, spp=spp, max_depth=max_depth, rr_depth=rr_depth,
                       ray_end=ray_end, n_lanes=n_lanes)
    end = idx0 + n if ray_end is None else ray_end
    return _replay_grad_impl(scene, params, update_fn, rec, target, seed, idx0, end, spp=spp,
                             max_depth=max_depth, rr_depth=rr_depth, rfilter=rfilter)
