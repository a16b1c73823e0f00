#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: camera rays/s of the path-MIS
forward and forward+backward on the bedroom-class scene, the counterpart of
bench.py (which measures the JAX package on a TPU).

    python3 bench_torch.py                   # on the card
    BENCH_SMALL=1 python3 bench_torch.py --device cpu

Prints ONE JSON line, {"metric", "value", "unit", "vs_baseline", "extra"}:
`value` is the fwd+bwd camera rays/s of the headline rung; `extra` holds the
forward's rays/s, the depth-65 companion's two rates and the device.  Lines
before it start with "#": seconds, the record / replay split, peak device
memory, K1's launches against plain traversals and, for the replay, K5's
forward + adjoint launches against plain replays, per rung.

Rungs, each in a worker process of its own (`--worker JSON`), so that the
depth-8 and depth-65 records never share one allocator:

  * headline: 1280x720, spp 4, depth 8, 2M triangles — `render_pipelined`
    (tent) timed after an untimed call at another seed, then one fwd+bwd
    (`record_full_pipelined` + `replay_grads`, box, chunks of 131,072 rays)
    timed after an untimed one; the target is the timed forward image;
  * companion (`BENCH_SKIP_D65=1` leaves it out): the same at depth 65, the
    reference bedroom's depth, where "auto" replays sorted, fed the
    recorder's film;
  * `BENCH_SMALL=1`: 160x90, spp 2, depth 4, 100k triangles, lockstep
    `render_pass` over chunks of 14,400 lanes and autograd through
    `PathIntegrator(differentiable=True)`; no companion.

Env: BENCH_RES (WxH), BENCH_SPP, BENCH_DEPTH, BENCH_TRIS, BENCH_CHUNK
override the rung that runs (not the companion); BENCH_REPLAY
auto|full|sorted|trunc; BENCH_SCHED pipelined|persistent (record_full_
pipelined or replay.record_full: the same record); BENCH_SCENE
standin|flagship (also --scene; flagship reads --xml, default
data/bedroom/scene.xml, and caches its tables in --cache-dir, default
.scene_cache/).

There is no fallback: a rung that fails ends the run with a non-zero exit
and no JSON line, and without a card the run fails unless `--device cpu` is
given.  The history goes to OUT/bench_history_torch.json (OUT: --out,
default out/), keyed by configuration and device name.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from mitsuba3_experiments_tpu_torch.integrators import (PathIntegrator, record_full,
                                                        record_full_pipelined, render_pass,
                                                        render_persistent, render_pipelined,
                                                        replay, replay_cuda, replay_grads)
from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
from mitsuba3_experiments_tpu_torch.render import film as filmlib
from mitsuba3_experiments_tpu_torch.scene import flagship, params

REPO = os.path.dirname(os.path.abspath(__file__))
REPLAY_CHUNK = 131_072
RR_DEPTH = 4
DIFF_KEYS = ("materials.base_color", "emitters.radiance")
HISTORY = "bench_history_torch.json"
OVERRIDES = (("BENCH_RES", str), ("BENCH_SPP", int), ("BENCH_DEPTH", int),
             ("BENCH_TRIS", int), ("BENCH_CHUNK", int))


def _overrides() -> dict:
    return {k.split("_", 1)[1].lower(): cast(os.environ[k])
            for k, cast in OVERRIDES if k in os.environ}


def _rung() -> dict:
    """The rung that runs: bench.py's small lockstep rung under
    BENCH_SMALL=1, else its headline, with the BENCH_* overrides (bench.py
    applies them to the headline only: its small rung is a fallback kept
    warm in the TPU compile cache, which the port does not have)."""
    if os.environ.get("BENCH_SMALL") == "1":
        base = dict(res="160x90", spp=2, depth=4, tris=100_000, chunk=14_400, mode="lockstep")
    else:
        base = dict(res="1280x720", spp=4, depth=8, tris=2_000_000, chunk=768)
    return {**base, **_overrides()}


def _d65_rung():
    """The reference bedroom's depth (its scene.xml max_depth 65) as a
    companion rung at the headline's resolution and spp; None under
    BENCH_SKIP_D65=1 or BENCH_SMALL=1."""
    if os.environ.get("BENCH_SKIP_D65") == "1" or os.environ.get("BENCH_SMALL") == "1":
        return None
    return dict(res="1280x720", spp=4, depth=65, tris=2_000_000, chunk=768)


def _cfg_key(cfg) -> str:
    return f"{cfg['res']}-spp{cfg['spp']}-d{cfg['depth']}-t{cfg['tris']}-{cfg['scene']}"


# ---- the measured callables (the worker's, and the tests') ------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _res(cfg):
    w, h = (int(x) for x in cfg["res"].split("x"))
    return w, h


def forward(scene, cfg, seed):
    """The forward rung: render_pipelined (render_persistent under
    sched "persistent"), tent -> (H, W, 3)."""
    render = render_persistent if cfg.get("sched") == "persistent" else render_pipelined
    return render(scene, seed=seed, spp=cfg["spp"], max_depth=cfg["depth"], rr_depth=RR_DEPTH,
                  rfilter="tent")


def fwd_bwd(scene, cfg, target, seed, chunk=REPLAY_CHUNK):
    """One production fwd+bwd: the record of all W*H*spp camera rays,
    padded to a multiple of `chunk` rows, then replay_grads (box) of the
    image MSE against `target` with respect to DIFF_KEYS.  The record
    returns the forward film only where the sorted mode replays.  Returns
    (gradients, record seconds)."""
    w, h = _res(cfg)
    spp, depth = cfg["spp"], cfg["depth"]
    mode = cfg.get("replay", "auto")
    n_rays = w * h * spp
    pad = -(-n_rays // chunk) * chunk
    diff = {k: params.traverse(scene)[k] for k in DIFF_KEYS}
    kw = dict(spp=spp, max_depth=depth, rr_depth=RR_DEPTH, pad_to=pad)
    sorted_active = mode == "sorted" or (mode == "auto" and depth >= 16)
    t0 = time.perf_counter()
    film = None
    if cfg.get("sched") == "persistent":
        rec = record_full(scene, seed, n_rays, **kw)
    elif sorted_active:
        rec, film = record_full_pipelined(scene, seed, n_rays, return_film=True, rfilter="box",
                                          **kw)
    else:
        rec = record_full_pipelined(scene, seed, n_rays, **kw)
    _sync(scene.device)
    record_s = time.perf_counter() - t0
    g = replay_grads(scene, diff, params.update, target, seed, rec, n_rays, chunk=chunk, spp=spp,
                     max_depth=depth, rr_depth=RR_DEPTH, rfilter="box", mode=mode, film=film)
    return g, record_s


def lockstep_forward(scene, cfg, seed):
    """The small rung's forward: one pass of render_pass over chunks of
    cfg["chunk"] lanes, spp_per_pass 1, tent -> (H, W, 3)."""
    w, h = _res(cfg)
    integ = PathIntegrator(max_depth=cfg["depth"], rr_depth=RR_DEPTH)
    film = filmlib.new_film(w, h, device=scene.device)
    for off in range(0, w * h, cfg["chunk"]):
        render_pass(scene, integ, seed, 0, film, spp_per_pass=1, rfilter="tent",
                    chunk=cfg["chunk"], lane_offset=off)
    return filmlib.develop(film)


def lockstep_grad_chunk(scene, cfg, target, seed, pass_idx, off):
    """Gradient with respect to DIFF_KEYS of one chunk's masked MSE (box,
    the pixels the chunk's film covers) through the differentiable path
    integrator."""
    w, h = _res(cfg)
    integ = PathIntegrator(max_depth=cfg["depth"], rr_depth=RR_DEPTH, differentiable=True)
    p = {k: params.traverse(scene)[k].detach().requires_grad_(True) for k in DIFF_KEYS}
    film = filmlib.new_film(w, h, device=scene.device)
    render_pass(params.update(scene, p), integ, seed, pass_idx, film, spp_per_pass=1,
                rfilter="box", chunk=cfg["chunk"], lane_offset=off)
    img = filmlib.develop(film)
    msk = (film[..., 3] > 0.0)[..., None]
    loss = torch.where(msk, (img - target) ** 2, 0.0).sum()
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def lockstep_passes(cfg) -> int:
    return max(1, max(cfg["spp"], 2) // 2)


def lockstep_grads(scene, cfg, target, seed):
    """The small rung's fwd+bwd: lockstep_grad_chunk summed over every chunk
    of lockstep_passes(cfg) passes."""
    w, h = _res(cfg)
    acc = None
    for i in range(lockstep_passes(cfg)):
        for off in range(0, w * h, cfg["chunk"]):
            g = lockstep_grad_chunk(scene, cfg, target, seed, i, off)
            acc = g if acc is None else {k: acc[k] + g[k] for k in acc}
    return acc


# ---- the worker ---------------------------------------------------------------

def _timed(device, fn):
    """(fn(), seconds, K1 launches and plain traversals, K5 launches and
    plain replays during it), fn run between two synchronizations with the
    wrappers' counts set to 0 just before."""
    _sync(device)
    bvh_cuda.launches = bvh_torch.calls = 0
    replay_cuda.forward_launches = replay_cuda.adjoint_launches = replay.plain_calls = 0
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0, {
        "k1": bvh_cuda.launches, "plain_traverse": bvh_torch.calls,
        "k5": (replay_cuda.forward_launches, replay_cuda.adjoint_launches),
        "plain_replay": replay.plain_calls}


def worker(cfg) -> dict:
    """Runs one rung on cfg["device"]; prints "#" lines and returns the
    rung's numbers."""
    dev = torch.device(cfg["device"])
    w, h = _res(cfg)
    spp = cfg["spp"]
    t0 = time.perf_counter()
    scene, _ = flagship.load_bedroom(cfg["scene"], res=(w, h), spp=spp, tri_budget=cfg["tris"],
                                     xml_path=cfg["xml"], cache_dir=cfg["cache_dir"], device=dev)
    _sync(dev)
    print(f"# {cfg['scene']} scene: {scene.n_faces} triangles, {scene.bvh.unified.shape[0]} BVH "
          f"rows, load {time.perf_counter() - t0:.3f} s (untimed)", flush=True)
    lockstep = cfg.get("mode") == "lockstep"
    n = w * h

    if lockstep:
        lockstep_forward(scene, cfg, 0)
        img, fwd_s, fwd_counts = _timed(dev, lambda: lockstep_forward(scene, cfg, 1))
        fwd_rays = n / fwd_s
    else:
        forward(scene, cfg, 0)
        img, fwd_s, fwd_counts = _timed(dev, lambda: forward(scene, cfg, 1))
        fwd_rays = n * spp / fwd_s
    print(f"# fwd {fwd_rays:.1f} rays/s: {fwd_s:.3f} s, K1 launches {fwd_counts['k1']}, plain "
          f"traversals {fwd_counts['plain_traverse']}", flush=True)

    target = img
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if lockstep:
        lockstep_grad_chunk(scene, cfg, target, 0, 0, 0)
        _, bwd_s, bwd_counts = _timed(dev, lambda: lockstep_grads(scene, cfg, target, 1))
        bwd_rays = n * lockstep_passes(cfg)
        split = (f"{lockstep_passes(cfg)} passes of {-(-n // cfg['chunk'])} chunks of "
                 f"{cfg['chunk']} lanes")
    else:
        fwd_bwd(scene, cfg, target, 0)
        (_, record_s), bwd_s, bwd_counts = _timed(dev, lambda: fwd_bwd(scene, cfg, target, 1))
        bwd_rays = n * spp
        split = (f"record {record_s:.3f} s, replay {bwd_s - record_s:.3f} s, mode "
                 f"{cfg.get('replay', 'auto')}, {-(-bwd_rays // REPLAY_CHUNK)} chunks of "
                 f"{REPLAY_CHUNK}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    print(f"# fwd+bwd {bwd_rays / bwd_s:.1f} rays/s: {bwd_s:.3f} s ({split}), K1 launches "
          f"{bwd_counts['k1']}, plain traversals {bwd_counts['plain_traverse']}, K5 launches "
          f"{bwd_counts['k5'][0]} + {bwd_counts['k5'][1]}, plain replays "
          f"{bwd_counts['plain_replay']}, peak device memory "
          + ("not measured (cpu)" if peak is None else f"{peak:.2f} GB"), flush=True)
    return {
        "fwd_rays_per_s": fwd_rays, "fwd_bwd_rays_per_s": bwd_rays / bwd_s,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0,
    }


# ---- the main process --------------------------------------------------------

def _run_rung(cfg) -> dict:
    """Runs `cfg` in a worker process; forwards its "#" lines and returns
    its result.  Raises on a failed worker."""
    print(f"# rung {_cfg_key(cfg)} {cfg.get('mode', 'production')}", flush=True)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                          json.dumps(cfg)], cwd=REPO, stdout=subprocess.PIPE, text=True)
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise RuntimeError(f"rung {_cfg_key(cfg)} failed with exit code {out.returncode}")
    return json.loads(lines[-1])


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _history(path, key, device, res) -> float:
    """vs_baseline against the last run of `key` on `device`; records this
    run's rates in place of it, rounded as the JSON line reports them."""
    hist = {}
    if os.path.exists(path):
        with open(path) as f:
            hist = json.load(f)
    prev = hist.get(key, {}).get(device, {})
    vs = res["fwd_bwd_rays_per_s"] / prev["fwd_bwd"] if prev.get("fwd_bwd") else 1.0
    hist.setdefault(key, {})[device] = {"fwd": round(res["fwd_rays_per_s"], 1),
                                        "fwd_bwd": round(res["fwd_bwd_rays_per_s"], 1)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(hist, f, indent=1)
    return vs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--scene", choices=("standin", "flagship"),
                    default=os.environ.get("BENCH_SCENE", "standin"))
    ap.add_argument("--xml", default=None, help="the flagship's scene XML (default: "
                    "data/bedroom/scene.xml in the repository)")
    ap.add_argument("--cache-dir", default=flagship.CACHE_DIR, help="the flagship's table cache")
    ap.add_argument("--out", default=os.path.join(REPO, "out"), help="history directory")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device is available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    replay = os.environ.get("BENCH_REPLAY", "auto")
    sched = os.environ.get("BENCH_SCHED", "pipelined")
    if replay not in ("auto", "full", "sorted", "trunc"):
        print(f"bench_torch: BENCH_REPLAY={replay!r}: auto, full, sorted or trunc",
              file=sys.stderr)
        return 2
    if sched not in ("pipelined", "persistent"):
        print(f"bench_torch: BENCH_SCHED={sched!r}: pipelined or persistent", file=sys.stderr)
        return 2
    run = dict(scene=args.scene, xml=args.xml and os.path.abspath(args.xml),
               cache_dir=os.path.abspath(args.cache_dir), device=str(device), replay=replay,
               sched=sched)
    card = _card_line() if device.type == "cuda" else "cpu"
    print(f"# {card}", flush=True)
    cfg = {**_rung(), **run}
    d65 = _d65_rung()
    try:
        res = _run_rung(cfg)
        r65 = _run_rung({**d65, **run}) if d65 is not None else None
    except RuntimeError as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1

    dev_name = res["device"]
    vs = _history(os.path.join(args.out, HISTORY), _cfg_key(cfg), dev_name, res)
    extra = {"fwd_rays_per_s": round(res["fwd_rays_per_s"], 1)}
    if r65 is not None:
        extra["fwd_bwd_d65_rays_per_s"] = round(r65["fwd_bwd_rays_per_s"], 1)
        extra["fwd_d65_rays_per_s"] = round(r65["fwd_rays_per_s"], 1)
    extra["device"] = dev_name
    if device.type == "cuda":
        extra["device_count"] = res["device_count"]
        extra["power_limit"] = card.rsplit(",", 1)[-1].strip()
    print(f"# bench_torch.py: {time.perf_counter() - t_start:.1f} s in all, worker start-up and "
          f"scene builds included ({card})", flush=True)
    print(json.dumps({
        "metric": (f"camera rays/s/chip (path-MIS fwd+bwd, bedroom-class {cfg['res']} "
                   f"depth={cfg['depth']}, {cfg['tris']} tris, {cfg['scene']} scene)"),
        "value": round(res["fwd_bwd_rays_per_s"], 1),
        "unit": "rays/s",
        "vs_baseline": round(vs, 4),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(json.loads(sys.argv[2]))))
    else:
        sys.exit(main())
