"""Inverse rendering at the reference workload's scale on the PyTorch port:
recover the bedroom-class flagship's emitter radiance and material albedos
from a target image by Adam over the production fwd+bwd — the record
(`record_full_pipelined`, the film as its by-product) and the replay
(`replay_grads`, mode "auto": sorted at depth 16 and deeper) at the
bedroom's depth-65 spec.

Usage: python scripts/torch_flagship_invert.py [steps] [depth] [--chunk N]
           [--res W H] [--scene standin|flagship] [--xml PATH]
           [--tri-budget N] [--cache-dir DIR] [--device cuda|cpu] [--out DIR]
At spp 4.  The target is `render_pipelined` of the true scene (box filter);
the start point is radiance x 0.3 and base colour x 0.5 + 0.25, clipped to
[0, 1].
Radiance is optimized in log space (`update_log`); Adam at lr 8e-2, the base
colours clipped to [0, 1] after each step.  Each step logs its loss, the mean
absolute radiance and albedo errors, and its record and replay seconds.
Writes DIR/torch_flagship_invert.json and DIR/torch_flagship_invert_{start,
final}.png (DIR defaults to out/) and prints a summary JSON line.
`chip_smoke.py` runs `invert_step` on its own scene.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import (  # noqa: E402
    record_full_pipelined,
    render_pipelined,
    replay_grads,
)
from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda  # noqa: E402
from mitsuba3_experiments_tpu_torch.render import film as filmlib  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import flagship  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene.params import update  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import device_label, write_png  # noqa: E402

SPP, RR_DEPTH = 4, 4
CHUNK = 131_072
LR = 8e-2


def update_log(scene, p):
    """update() with the emitter radiance in log space: Adam's steps are of
    unit scale per coordinate, so a radiance of magnitude ~16 would recover
    at lr per step; in log space the recovery is multiplicative."""
    return update(scene, {"emitters.radiance": torch.exp(p["log_radiance"]),
                          "materials.base_color": p["materials.base_color"]})


def start_params(scene) -> dict:
    """The wrong start: radiance x 0.3, base colour x 0.5 + 0.25 (clipped)."""
    return {
        "log_radiance": torch.log(torch.clamp(scene.emitters.radiance * 0.3, min=1e-6)),
        "materials.base_color": torch.clamp(scene.materials.base_color * 0.5 + 0.25, 0.0, 1.0),
    }


def errors(p, true_rad, true_col) -> tuple:
    """(mean |radiance - true|, mean |base colour - true|)."""
    rad = float((torch.exp(p["log_radiance"]) - true_rad).abs().mean())
    col = float((p["materials.base_color"] - true_col).abs().mean())
    return rad, col


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def invert_step(scene, p: dict, opt, target, it: int, *, spp: int, depth: int,
                chunk: int = CHUNK) -> tuple:
    """One Adam step through the production fwd+bwd at seed it + 1; updates
    `p` in place.  Returns ({"loss", "record_s", "replay_s", "s"}, the
    step's forward image)."""
    dev = scene.device
    w, h = scene.camera.resolution
    n_rays = w * h * spp
    pad = -(-n_rays // chunk) * chunk
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        scene_it = update_log(scene, p)
    rec, film = record_full_pipelined(scene_it, it + 1, n_rays, spp=spp, max_depth=depth,
                                      rr_depth=RR_DEPTH, pad_to=pad, return_film=True,
                                      rfilter="box")
    img = filmlib.develop(film)
    loss = float(((img - target) ** 2).mean())
    _sync(dev)
    t1 = time.perf_counter()
    g = replay_grads(scene_it, p, update_log, target, it + 1, rec, n_rays, chunk=chunk, spp=spp,
                     max_depth=depth, rr_depth=RR_DEPTH, rfilter="box", mode="auto", film=film)
    del rec, film
    for k, v in p.items():
        v.grad = g[k]
    opt.step()
    opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        p["materials.base_color"].clamp_(0.0, 1.0)
    _sync(dev)
    t2 = time.perf_counter()
    return {"loss": loss, "record_s": t1 - t0, "replay_s": t2 - t1, "s": t2 - t0}, img


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=16)
    ap.add_argument("depth", nargs="?", type=int, default=65)
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="replay rows per chunk (a multiple of spp)")
    ap.add_argument("--res", nargs=2, type=int, default=[1280, 720], metavar=("W", "H"))
    ap.add_argument("--scene", choices=("standin", "flagship"), default="standin")
    ap.add_argument("--xml", default=None, help="the flagship's scene XML (default: "
                    "data/bedroom/scene.xml in the repository)")
    ap.add_argument("--tri-budget", type=int, default=2_000_000)
    ap.add_argument("--cache-dir", default=flagship.CACHE_DIR)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    scene, _ = flagship.load_bedroom(args.scene, res=tuple(args.res), spp=SPP,
                                     tri_budget=args.tri_budget, xml_path=args.xml,
                                     cache_dir=args.cache_dir, device=args.device)
    dev = scene.device
    w, h = scene.camera.resolution
    true_rad = scene.emitters.radiance.clone()
    true_col = scene.materials.base_color.clone()
    kw = dict(spp=SPP, max_depth=args.depth, rr_depth=RR_DEPTH, rfilter="box")
    target = render_pipelined(scene, seed=0, **kw)

    p = start_params(scene)
    opt = torch.optim.Adam(list(p.values()), lr=LR)
    os.makedirs(args.out, exist_ok=True)
    curve = []
    k1 = bvh_cuda.launches
    t_all = time.perf_counter()
    for it in range(args.steps):
        row, img = invert_step(scene, p, opt, target, it, spp=SPP, depth=args.depth,
                               chunk=args.chunk)
        if it == 0:
            write_png(os.path.join(args.out, "torch_flagship_invert_start.png"),
                      img.cpu().numpy())
        del img
        row["rad_err"], row["col_err"] = errors(p, true_rad, true_col)
        curve.append({"it": it, **row})
        print(f"it {it}: loss={row['loss']:.3e} rad_err={row['rad_err']:.4f} "
              f"col_err={row['col_err']:.4f} (record {row['record_s']:.2f} s, replay "
              f"{row['replay_s']:.2f} s)", flush=True)
    total_s = time.perf_counter() - t_all
    k1 = bvh_cuda.launches - k1

    with torch.no_grad():
        final = render_pipelined(update_log(scene, p), seed=0, **kw).cpu().numpy()
    write_png(os.path.join(args.out, "torch_flagship_invert_final.png"), final)
    steady = curve[1:] or curve
    out = {
        "workload": {"scene": args.scene, "res": [w, h], "spp": SPP, "depth": args.depth,
                     "triangles": int(scene.n_faces), "steps": args.steps, "chunk": args.chunk},
        "fwdbwd_s_per_step": float(np.mean([c["s"] for c in steady])),
        "loss_first": curve[0]["loss"], "loss_last": curve[-1]["loss"],
        "rad_err_first": curve[0]["rad_err"], "rad_err_last": curve[-1]["rad_err"],
        "col_err_first": curve[0]["col_err"], "col_err_last": curve[-1]["col_err"],
        "k1_launches": k1, "curve": curve, "total_s": total_s, "device": device_label(dev),
    }
    with open(os.path.join(args.out, "torch_flagship_invert.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("fwdbwd_s_per_step", "loss_first", "loss_last",
                                          "rad_err_first", "rad_err_last", "col_err_first",
                                          "col_err_last", "k1_launches", "device")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
