"""The benchmark's plain reference, in plain torch on the card.

It imports nothing of the port (`mitsuba3_experiments_tpu_torch`), nor
`jax` or the JAX package, and takes no table the port made: it compiles the
scene dict again with a frozen copy of the port's plain code (`frozen/`,
copied at aa7dcd9), answers ray queries with its own structure
(`trace.py`), and replays gradients with the frozen plain replay.  The
functions below are what `correct` compares.
"""
from __future__ import annotations

import dataclasses

import torch

from .frozen import replay as ref_replay
from .trace import RefScene, record_off, render_pixels, trace  # noqa: F401

DIFF_KEYS = ("materials.base_color", "emitters.radiance")


def update(scene, p: dict):
    """The scene with `p`'s base colours and emitter radiances (the frozen
    counterpart of the port's scene.params.update for these two keys)."""
    s = scene
    if "materials.base_color" in p:
        s = dataclasses.replace(s, materials=dataclasses.replace(
            s.materials, base_color=p["materials.base_color"]))
    if "emitters.radiance" in p:
        s = dataclasses.replace(s, emitters=dataclasses.replace(
            s.emitters, radiance=p["emitters.radiance"]))
    return s


def as_record(prim, u, v, occl):
    """A frozen PathRecord of the given (N, D) tensors."""
    return ref_replay.PathRecord(prim=prim, u=u, v=v, occl=occl)


def replay_grads(ref: RefScene, params: dict, target, seed, rec, n_rays: int, *, chunk: int,
                 spp: int, max_depth: int, rr_depth: int, mode: str):
    """Gradients of the image MSE against `target` with respect to
    `params` over the record `rec` (full or sorted chunks, as `mode`
    says), by the frozen plain replay on the reference's own tables; the
    sorted mode makes its forward film itself."""
    rec = as_record(rec.prim, rec.u, rec.v, rec.occl)
    kw = dict(chunk=chunk, spp=spp, max_depth=max_depth, rr_depth=rr_depth, rfilter="box")
    p = {k: v.detach().clone() for k, v in params.items()}
    scene = update(ref.scene, p)       # the sorted mode's film is made with these tables
    if mode == "full":
        return ref_replay.replay_grads_full(scene, p, update, target, seed, rec, n_rays, **kw)
    if mode == "sorted":
        return ref_replay.replay_grads_sorted(scene, p, update, target, seed, rec, n_rays,
                                              film=None, **kw)
    raise ValueError(f"replay mode {mode!r}: 'full' or 'sorted'")


def grad_gap(g_prog: dict, g_ref: dict) -> float:
    """The worst key's largest entry gap, over that key's largest reference
    entry: max_k max_i |prog_ki - ref_ki| / max_i |ref_ki|."""
    gap = 0.0
    for k, r in g_ref.items():
        p = g_prog[k].to(r.device, torch.float32)
        scale = float(r.abs().max())
        err = float((p - r).abs().max())
        gap = max(gap, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    return gap


def share_off(prog, ref, rtol: float = 1e-3, atol: float = 1e-4) -> float:
    """Share of the rows (pixels) of `prog` (P, 3) with a channel off `ref`
    by more than atol + rtol |ref| (a non-finite value is off)."""
    prog = prog.to(ref.device, torch.float32)
    ok = ((prog - ref).abs() <= atol + rtol * ref.abs()).all(dim=-1)
    return float((~ok).float().mean())
