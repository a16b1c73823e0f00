"""Ray-parallel data parallelism over a one-dimensional ``("dp",)`` mesh.

Counterpart of ``mitsuba3_experiments_tpu.parallel.mesh``.  There one
controller runs a ``shard_map`` over the mesh and merges with ``psum``.
PyTorch is multi-controller, so here:

  * every rank calls the same entry point with its own replica of the
    scene, on its own device (the tables replicated, as ``P()`` is in JAX);
  * every rank traces only its own camera rays: lanes
    ``[rank * per, (rank + 1) * per)`` of a wavefront, ``per = ceil(n /
    ranks)``, keyed by their global index, so a ray draws the same numbers
    as in the single-device render;
  * ``dist.all_reduce`` over the mesh's group takes the place of ``psum``,
    and every rank gets back the whole result.

Lanes at or past the wavefront's end are gated (``render_pass``'s
``in_range``).  The JAX package points them at lane 0 instead, which splats
lane 0's sample again into pixel (0, 0); the port does not copy that.

Not ported (TPU scheduling): the arguments ``steps``,
``rounds_per_launch``, ``scheduler`` and ``arm_every`` of
``render_persistent_sharded`` and ``sharded_replay_grad``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import default_device
from ..integrators import persistent as pp
from ..integrators.common import render_pass, split_passes
from ..integrators.replay import PathRecord, _grad, _splat, replay_radiance
from ..render import film as filmlib
from ..scene.params import update as scene_update


def make_mesh(n_devices: int | None = None) -> DeviceMesh:
    """The ``("dp",)`` mesh over every rank of the initialized default
    process group; its device type is the default device's (the card), or
    ``cpu`` for a gloo group.  Raises when no group is initialized: the
    caller starts one (``init_process_group`` with its rank, world size,
    rendezvous and timeout).  JAX's ``make_mesh(k)`` takes the first k of
    one process's devices; here a rank is a process, so `n_devices` must be
    the world size (a smaller mesh is a smaller world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {world}: the mesh spans "
                         "the whole world")
    device_type = "cpu" if dist.get_backend() == "gloo" else default_device().type
    return DeviceMesh(device_type, torch.arange(world), mesh_dim_names=("dp",))


def _rank_size(mesh: DeviceMesh):
    return mesh.get_local_rank("dp"), mesh.size()


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    dist.all_reduce(t, group=mesh.get_group("dp"))
    return t


def _ray_slice(n: int, rank: int, ndev: int, idx0: int = 0):
    """(first ray, rays per rank, rays this rank traces) of the contiguous
    slice of rays idx0 .. idx0 + n that this rank owns."""
    per = -(-n // ndev)
    start = idx0 + rank * per
    return start, per, max(min(per, idx0 + n - start), 0)


def _launches(n: int, rank: int, ndev: int, chunk):
    """(lane offset, lanes) of each launch of this rank over a wavefront of
    n lanes: its slice, or with `chunk` its chunk of every launch of
    chunk * ndev lanes."""
    if chunk is None:
        start, per, _ = _ray_slice(n, rank, ndev)
        return [(start, per)]
    return [(off + rank * chunk, chunk) for off in range(0, n, chunk * ndev)]


def render_sharded(scene, integrator, mesh: DeviceMesh, seed: int = 0, spp: int = 16,
                   rfilter: str = "box", spp_per_pass: int | None = None,
                   chunk: int | None = None):
    """Multi-rank render -> the (H, W, 3) image on every rank.  Passes as in
    `render`; `chunk` is the lanes of one rank per launch (each launch
    covers chunk * ranks lanes).  One all-reduce of the (H, W, 4) film per
    pass or launch, then develop."""
    w, h = scene.camera.resolution
    spp_per_pass, n_passes = split_passes(w, h, spp, spp_per_pass)
    rank, ndev = _rank_size(mesh)
    n = w * h * spp_per_pass
    film = filmlib.new_film(w, h, device=scene.device)
    for p in range(n_passes):
        for off, count in _launches(n, rank, ndev, chunk):
            part = filmlib.new_film(w, h, device=scene.device)
            render_pass(scene, integrator, seed, p, part, spp_per_pass=spp_per_pass,
                        rfilter=rfilter, chunk=count, lane_offset=off)
            film += _all_reduce(part, mesh)
    return filmlib.develop(film)


@torch.no_grad()
def render_persistent_sharded(scene, mesh: DeviceMesh, seed: int = 0, spp: int = 16,
                              max_depth: int = 16, rr_depth: int = 4, rfilter: str = "box",
                              n_lanes: int = pp.N_LANES):
    """Multi-rank production forward -> the (H, W, 3) image on every rank:
    each rank runs the wavefront (`persistent.trace_rays`) over its
    contiguous slice of the W*H*spp camera rays, splats its slice once,
    and one all-reduce merges the films."""
    w, h = scene.camera.resolution
    rank, ndev = _rank_size(mesh)
    start, per, n_valid = _ray_slice(w * h * spp, rank, ndev)
    rayL = pp.trace_rays(scene, seed, start, per, n_valid, spp=spp, max_depth=max_depth,
                         rr_depth=rr_depth, n_lanes=n_lanes)
    film = pp.splat_deferred(scene.camera, seed, rayL, start, n_valid, spp=spp, rfilter=rfilter,
                             w=w, h=h)
    return filmlib.develop(_all_reduce(film, mesh))


def _sum_grads(grads: dict, mesh: DeviceMesh) -> dict:
    for g in grads.values():
        _all_reduce(g, mesh)
    return grads


def sharded_grad_step(scene, params: dict, target, seed, mesh: DeviceMesh, integrator,
                      spp_per_pass: int = 1):
    """One data-parallel step of the differentiable render: (loss, grads),
    the same on every rank.  Loss: the mean squared error of the developed
    whole-frame image against `target`.  `integrator` is differentiable
    (``PathIntegrator(differentiable=True)``).

    Each rank traces its lanes under autograd into a partial film; an
    all-reduce of a detached copy gives the whole film, whose adjoint
    dLoss/dfilm is formed once; each rank backpropagates <adjoint, its
    film>, and the gradients are summed over the ranks.  That is the exact
    whole-frame gradient for any split of the lanes, since the filter
    weights do not depend on the parameters.  (JAX differentiates through
    psum, whose transpose inflates each device's cotangent by the device
    count, and divides it out; ``torch.distributed.nn`` would inflate it
    the same way.)"""
    w, h = scene.camera.resolution
    n = w * h * spp_per_pass
    rank, ndev = _rank_size(mesh)
    start, per, _ = _ray_slice(n, rank, ndev)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    part = filmlib.new_film(w, h, device=scene.device)
    render_pass(scene_update(scene, p), integrator, seed, 0, part, spp_per_pass=spp_per_pass,
                rfilter="box", chunk=per, lane_offset=start)

    film = _all_reduce(part.detach().clone(), mesh).requires_grad_(True)
    loss = torch.mean((filmlib.develop(film) - target) ** 2)
    adj, = torch.autograd.grad(loss, film)
    if part.requires_grad:
        gs = torch.autograd.grad((adj * part).sum(), list(p.values()), allow_unused=True)
    else:   # a rank whose lanes all lie past the wavefront
        gs = [None] * len(p)
    grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), gs)}
    return loss.detach(), _sum_grads(grads, mesh)


def sharded_replay_grad(scene, params: dict, target, seed, mesh: DeviceMesh, *, idx0: int = 0,
                        n_lanes: int = 32768, spp: int, max_depth: int, rr_depth: int = 4,
                        rfilter: str = "box", ray_end=None, chunk: int | None = None):
    """Multi-rank record + replay fwd+bwd: (loss, grads), the same on every
    rank.  The camera rays idx0 .. ray_end (default idx0 + n_lanes * ranks)
    are split into contiguous slices of ceil(n / ranks); each rank

      1. records its slice (the wavefront in batches of at most `n_lanes`
         rays, K1 on the card) and splats the recorded radiance: its
         forward film;
      2. all-reduces the films: the whole frame, from which it computes the
         masked sum of squared errors against `target` and the film adjoint
         2 (S / w - target) / w on covered pixels, as the JAX package does;
      3. replays its slice in chunks of `chunk` rows (default: the whole
         slice), adding the gradient of <adjoint, the chunk's film>;
      4. sums the gradients over the ranks (they are linear in the splats,
         so the sum is the whole-frame gradient)."""
    w, h = scene.camera.resolution
    rank, ndev = _rank_size(mesh)
    if ray_end is None:
        ray_end = idx0 + n_lanes * ndev
    start, per, n_valid = _ray_slice(ray_end - idx0, rank, ndev, idx0)
    if chunk is None or chunk > per:
        chunk = per
    rows = -(-per // chunk) * chunk
    end = start + n_valid
    kw = dict(spp=spp, max_depth=max_depth, rr_depth=rr_depth)

    rec = PathRecord.empty(rows, max_depth, scene.device)
    rayL = pp.trace_rays(scene, seed, start, rows, n_valid, n_lanes=min(n_lanes, per), rec=rec,
                         **kw)
    film = pp.splat_deferred(scene.camera, seed, rayL, start, n_valid, spp=spp, rfilter=rfilter,
                             w=w, h=h)
    film = _all_reduce(film, mesh)
    img = filmlib.develop(film)
    wgt = film[..., 3:4]
    msk = wgt > 0.0
    loss = torch.where(msk, (img - target) ** 2, 0.0).sum()
    adj = torch.where(msk, 2.0 * (img - target) / torch.where(msk, wgt, 1.0), 0.0)

    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    for j in range(0, n_valid, chunk):   # the chunks past n_valid hold no ray
        sl = rec.rows(slice(j, j + chunk))
        idx = torch.arange(start + j, start + j + chunk, dtype=torch.int64, device=scene.device)

        def inner(s, sl=sl, idx=idx):
            L, pos, act0 = replay_radiance(s, sl, seed, 0, ray_end=end, idx=idx, **kw)
            return (adj * _splat(s, L, pos, act0, rfilter)[..., :3]).sum()

        for k, g in _grad(scene, params, scene_update, inner).items():
            acc[k] += g
    return loss, _sum_grads(acc, mesh)
