"""The pipelined renderer and recorder, under their JAX names.

Counterpart of ``mitsuba3_experiments_tpu.integrators.pipelined``.  There the
two-path-per-lane machine is a second TPU schedule of the persistent
renderer: the same rays, draws and shading, so the same images and records.
On the card both entry points run the persistent wavefront
(persistent.trace_rays).  ``PipelinedState``, its slots, the dense retire
and the flush modes are TPU scheduling and are not ported, nor are the
arguments ``steps``, ``rounds_per_launch``, ``n_slots``, ``arm_every``,
``retire``, ``gen_cap`` and ``flush``.
"""
from __future__ import annotations

from ..scene.types import Scene
from . import persistent as pp
from .replay import record_frame


def render_pipelined(scene: Scene, seed: int = 0, spp: int = 16, max_depth: int = 16,
                     rr_depth: int = 4, rfilter: str = "box", n_lanes: int = pp.N_LANES):
    """Full-frame render -> (H, W, 3) image; equal to render_persistent."""
    return pp.render_persistent(scene, seed=seed, spp=spp, max_depth=max_depth,
                                rr_depth=rr_depth, rfilter=rfilter, n_lanes=n_lanes)


def record_full_pipelined(scene: Scene, seed, n_rays: int, *, spp: int, max_depth: int,
                          rr_depth: int, n_lanes: int = pp.N_LANES, pad_to: int | None = None,
                          return_film: bool = False, rfilter: str = "box"):
    """replay.record_full, and with return_film=True also the forward film
    (weight channel included, splat with `rfilter`) from the recorded rays'
    own radiance: the film replay_grads_sorted would otherwise recompute."""
    rec, rayL = record_frame(scene, seed, n_rays, spp=spp, max_depth=max_depth,
                             rr_depth=rr_depth, n_lanes=n_lanes, pad_to=pad_to)
    if not return_film:
        return rec
    w, h = scene.camera.resolution
    film = pp.splat_deferred(scene.camera, seed, rayL[:n_rays], 0, n_rays, spp=spp,
                             rfilter=rfilter, w=w, h=h)
    return rec, film
