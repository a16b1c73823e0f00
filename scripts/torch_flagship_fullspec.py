"""Render the bedroom-class flagship at the reference spec on the PyTorch port.

The bedroom's scene XML defines the north-star workload: 1280x720, spp 64,
max_depth 65, independent sampler, tent filter.  This driver runs it once
through `render_pipelined` (rr_depth 4), times it, and writes the image.

Usage: python scripts/torch_flagship_fullspec.py [spp] [depth] [--res W H]
           [--scene standin|flagship] [--xml PATH] [--tri-budget N]
           [--cache-dir DIR] [--device cuda|cpu] [--out DIR]
`--scene flagship` loads the XML at `--xml` (default: data/bedroom/scene.xml
in the repository) through `load_flagship` and raises when it is absent;
`standin` (the default) is `standin_dict`.  The kernels are built before the
timed render.
Writes DIR/torch_flagship_spp<spp>_d<depth>.{exr,png,json} (DIR defaults to
out/) and prints the JSON on one line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import render_pipelined  # noqa: E402
from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import flagship  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import device_label, write_exr, write_png  # noqa: E402


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("spp", nargs="?", type=int, default=64)
    ap.add_argument("depth", nargs="?", type=int, default=65)
    ap.add_argument("--res", nargs=2, type=int, default=[1280, 720], metavar=("W", "H"))
    ap.add_argument("--scene", choices=("standin", "flagship"), default="standin")
    ap.add_argument("--xml", default=None, help="the flagship's scene XML (default: "
                    "data/bedroom/scene.xml in the repository)")
    ap.add_argument("--tri-budget", type=int, default=2_000_000)
    ap.add_argument("--cache-dir", default=flagship.CACHE_DIR)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    t0 = time.perf_counter()
    scene, _ = flagship.load_bedroom(args.scene, res=tuple(args.res), spp=args.spp,
                                     tri_budget=args.tri_budget, xml_path=args.xml,
                                     cache_dir=args.cache_dir, device=args.device)
    load_s = time.perf_counter() - t0
    dev = scene.device
    if dev.type == "cuda":
        bvh_cuda.LIBRARY.load()   # nvcc outside the timed render
    w, h = scene.camera.resolution
    n_rays = w * h * args.spp
    k1 = bvh_cuda.launches
    sync(dev)
    t0 = time.perf_counter()
    img = render_pipelined(scene, seed=0, spp=args.spp, max_depth=args.depth, rr_depth=4,
                           rfilter="tent")
    sync(dev)
    dt = time.perf_counter() - t0
    img = img.cpu().numpy()
    out = {"scene": args.scene, "res": [w, h], "spp": args.spp, "depth": args.depth,
           "triangles": int(scene.n_faces), "load_s": load_s, "seconds": dt,
           "camera_rays_per_s": n_rays / dt, "mean": float(img.mean()),
           "nan": int(np.isnan(img).sum()), "k1_launches": bvh_cuda.launches - k1,
           "device": device_label(dev)}
    os.makedirs(args.out, exist_ok=True)
    tag = os.path.join(args.out, f"torch_flagship_spp{args.spp}_d{args.depth}")
    write_exr(tag + ".exr", img)
    write_png(tag + ".png", img)
    with open(tag + ".json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
