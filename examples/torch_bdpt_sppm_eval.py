"""BDPT and SPPM against the path tracer on the PyTorch port, at an equal
time budget, on two scenes where they should win:

  1. caustics: a glass sphere over a diffuse floor under a small bright
     area light (examples/torch_run_pssmlt.py's caustic scene); the error
     is also taken over the caustic crop (bright floor pixels);
  2. an occluded light: the Cornell box's panel tucked behind the tall
     box, so NEE is blocked almost everywhere.

Protocol: a path-traced reference at `ref_spp`; the path tracer at
`budget_spp`, timed (a warm-up render first); BDPT (full (s, t) MIS) at the
spp that a timed probe says fits that time; SPPM frames until that time.
Times are host seconds around renders that end in a device synchronize.

Usage: python examples/torch_bdpt_sppm_eval.py [res] [budget_spp] [ref_spp]
           [--photons N] [--device cuda|cpu] [--out DIR]
--photons is SPPM's photons a frame and its hash grid's cells (2^18 each,
as in the JAX example).
Writes DIR/torch_bdpt_sppm_{ref,path,bdpt,sppm}.png,
DIR/torch_bdpt_occluded_{ref,path,bdpt}.png and
DIR/torch_bdpt_sppm_metrics.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

from torch_run_pssmlt import caustic_scene  # noqa: E402

from mitsuba3_experiments_tpu_torch.core import math as cm  # noqa: E402
from mitsuba3_experiments_tpu_torch.integrators import (  # noqa: E402
    SPPM,
    BDPTIntegrator,
    PathIntegrator,
    render,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import mse, relative_mse, write_png  # noqa: E402

DEPTH = 8


def tonemap(x):
    return np.clip(np.asarray(x) ** (1 / 2.2), 0, 1)


def errors(img, ref, mask=None) -> dict:
    out = {"mse": mse(img, ref), "rel_mse": relative_mse(img, ref)}
    if mask is not None:
        out["mse_caustic"] = mse(img[mask], ref[mask])
        out["rel_mse_caustic"] = relative_mse(img[mask], ref[mask])
    return out


def timed(fn, device):
    """(seconds, result as numpy) of fn(), the device synchronized."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    img = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, img.cpu().numpy()


def path_and_bdpt(scene, pt, budget_spp, ref, mask, seeds, name, out_dir, tag):
    """The path tracer at budget_spp and BDPT at the spp fitting its time."""
    dev = scene.device
    render(scene, pt, spp=budget_spp, seed=3)   # warm-up
    t_budget, img_path = timed(lambda: render(scene, pt, spp=budget_spp, seed=seeds[0]), dev)
    write_png(os.path.join(out_dir, f"torch_{tag}_path.png"), tonemap(img_path))
    bd = BDPTIntegrator(max_depth=DEPTH, mis=True)
    probe_spp = max(budget_spp // 8, 4)
    render(scene, bd, spp=probe_spp, seed=3)
    t_probe, _ = timed(lambda: render(scene, bd, spp=probe_spp, seed=4), dev)
    bdpt_spp = max(4, int(probe_spp * t_budget / t_probe / 4) * 4)
    print(f"{name}: bdpt probe {probe_spp} spp took {t_probe:.2f} s -> {bdpt_spp} spp", flush=True)
    t_bdpt, img_bdpt = timed(lambda: render(scene, bd, spp=bdpt_spp, seed=seeds[1]), dev)
    write_png(os.path.join(out_dir, f"torch_{tag}_bdpt.png"), tonemap(img_bdpt))
    res = {"path": {"spp": budget_spp, "seconds": t_budget, **errors(img_path, ref, mask)},
           "bdpt": {"spp": bdpt_spp, "seconds": t_bdpt, **errors(img_bdpt, ref, mask)}}
    for k, v in res.items():
        print(f"{name} {k} {v['spp']} spp: {v['seconds']:.2f} s mse={v['mse']:.4g}", flush=True)
    return res, t_budget


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("res", nargs="?", type=int, default=256)
    ap.add_argument("budget_spp", nargs="?", type=int, default=64)
    ap.add_argument("ref_spp", nargs="?", type=int, default=2048)
    ap.add_argument("--photons", type=int, default=1 << 18)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    res = args.res

    # ---- scene 1: caustics ----
    scene, _ = load_dict(caustic_scene(res), device=args.device)
    dev = scene.device
    print("rendering the reference...", flush=True)
    ref = render(scene, PathIntegrator(max_depth=DEPTH, rr_depth=5), spp=args.ref_spp,
                 seed=777).cpu().numpy()
    write_png(os.path.join(args.out, "torch_bdpt_sppm_ref.png"), tonemap(ref))
    # caustic crop: lower-half pixels above 1.5 times the median luminance there
    lum = ref.mean(-1)
    floor = np.zeros_like(lum, bool)
    floor[res // 2:] = True
    mask = floor & (lum > np.median(lum[floor]) * 1.5)
    print(f"caustic crop: {mask.mean() * 100:.1f}% of pixels", flush=True)
    metrics = {"res": res, "depth": DEPTH, "ref_spp": args.ref_spp,
               "budget_spp": args.budget_spp, "device": str(dev)}
    pt = PathIntegrator(max_depth=DEPTH, rr_depth=5)
    metrics["methods"], t_budget = path_and_bdpt(scene, pt, args.budget_spp, ref, mask, (11, 21),
                                                 "caustic", args.out, "bdpt_sppm")

    sppm = SPPM(max_depth=DEPTH, photon_count=args.photons, initial_radius=0.02,
                max_per_cell=64, grid_cells=args.photons)
    state = sppm.init_state(scene)
    img, state = sppm.render_frame(scene, state, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    frames = 1
    while time.perf_counter() - t0 < t_budget:
        img, state = sppm.render_frame(scene, state, frames)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # one frame at a time inside the budget
        frames += 1
    t_sppm = time.perf_counter() - t0
    img_sppm = img.cpu().numpy().reshape(res, res, 3)
    write_png(os.path.join(args.out, "torch_bdpt_sppm_sppm.png"), tonemap(img_sppm))
    metrics["methods"]["sppm"] = {"frames": frames, "photons_per_frame": sppm.photon_count,
                                  "seconds": t_sppm, **errors(img_sppm, ref, mask)}
    print(f"caustic sppm {frames} frames: {t_sppm:.2f} s "
          f"mse={metrics['methods']['sppm']['mse']:.4g}", flush=True)

    # ---- scene 2: the occluded light ----
    d = cornell_box(res=res, spp=1)
    d["light"]["to_world"] = cm.matmul4(cm.translate([-0.85, -0.5, -0.55]),
                                        cm.rotate([0, 1, 0], 90), cm.scale_mat([0.25, 0.25, 1.0]))
    scene2, _ = load_dict(d, device=args.device)
    print("rendering the occluded-light reference...", flush=True)
    pt2 = PathIntegrator(max_depth=DEPTH, rr_depth=99)
    ref2 = render(scene2, pt2, spp=args.ref_spp, seed=77).cpu().numpy()
    write_png(os.path.join(args.out, "torch_bdpt_occluded_ref.png"), tonemap(ref2))
    metrics["occluded"], _ = path_and_bdpt(scene2, pt2, args.budget_spp, ref2, None, (12, 22),
                                           "occluded", args.out, "bdpt_occluded")

    with open(os.path.join(args.out, "torch_bdpt_sppm_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(f"wrote {args.out}/torch_bdpt_sppm_*.png, torch_bdpt_occluded_*.png and the metrics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
