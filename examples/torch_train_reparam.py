"""Reparameterized-sampling training on the PyTorch port: learn the sampling
map T(z) whose pushforward density matches a 2-D image target by NLL
descent, and show the warped distribution before and after training.
Targets: a procedural checker disc, or a density image of the double
spiral.

Usage: python examples/torch_train_reparam.py [iters] [checker|spiral]
           [--device cuda|cpu] [--out DIR]
Writes DIR/torch_reparam_<target>_{target,before,after}.png and
DIR/torch_reparam_<target>_metrics.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch import resolve_device  # noqa: E402
from mitsuba3_experiments_tpu_torch.models import normflow as nf  # noqa: E402
from mitsuba3_experiments_tpu_torch.models import reparam as rp  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import write_png  # noqa: E402

RES = 64


def target_image(target):
    if target == "checker":
        img = np.zeros((RES, RES), np.float32)
        yy, xx = np.mgrid[0:RES, 0:RES]
        img[((xx // 8 + yy // 8) % 2 == 0) & (((xx - 32) ** 2 + (yy - 32) ** 2) < 900)] = 1.0
        return img
    pts = nf.spiral_sample(torch.Generator().manual_seed(0), 1 << 20).numpy()
    img, _, _ = np.histogram2d(pts[:, 1], pts[:, 0], bins=RES, range=[[0, 1], [0, 1]])
    return (img / img.max()).astype(np.float32)


def make_log_p(img, dev):
    """log of the image's density on [0,1]^2 (mean 1, floored at 1e-4) by
    bilinear lookup; log(1e-4) outside the unit square."""
    dens = torch.as_tensor(np.maximum(img / max(img.mean(), 1e-9), 1e-4), device=dev)

    def log_p(x):
        gx = torch.clamp(x[..., 0], 0.0, 1.0) * (RES - 1)
        gy = torch.clamp(x[..., 1], 0.0, 1.0) * (RES - 1)
        x0 = torch.clamp(torch.floor(gx).long(), 0, RES - 2)
        y0 = torch.clamp(torch.floor(gy).long(), 0, RES - 2)
        fx, fy = gx - x0, gy - y0
        d = (dens[y0, x0] * (1 - fx) * (1 - fy) + dens[y0, x0 + 1] * fx * (1 - fy)
             + dens[y0 + 1, x0] * (1 - fx) * fy + dens[y0 + 1, x0 + 1] * fx * fy)
        inside = (x[..., 0] >= 0.0) & (x[..., 0] <= 1.0) & (x[..., 1] >= 0.0) & (x[..., 1] <= 1.0)
        return torch.log(torch.where(inside, d, 1e-4))

    return log_p


def sample_hist(params, dev, n=1 << 20, bins=128):
    """Histogram of T(z), z ~ U[0,1]^2: the warped sampler's density."""
    z = torch.rand((n, 2), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    with torch.no_grad():
        x = rp.apply_map(params, z, squash=True).cpu().numpy()
    hist, _, _ = np.histogram2d(x[:, 1], x[:, 0], bins=bins, range=[[0, 1], [0, 1]])
    return hist / max(hist.max(), 1e-9)


def dump(path, a):
    write_png(path, np.repeat(np.asarray(a, np.float32)[..., None], 3, -1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=20000)
    ap.add_argument("target", nargs="?", choices=("checker", "spiral"), default="checker")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    img = target_image(args.target)
    cfg = rp.ReparamConfig(dim=2, hidden=64, depth=4, squash=True, fold_penalty=25.0)
    stem = os.path.join(args.out, f"torch_reparam_{args.target}")
    dump(stem + "_target.png", img / max(img.max(), 1e-9))
    dump(stem + "_before.png",
         sample_hist(rp.init_map(torch.Generator(device=dev).manual_seed(1), cfg, device=dev),
                     dev))
    t0 = time.perf_counter()
    params, losses = rp.train_reparam(make_log_p(img, dev), cfg, n_iters=args.iters,
                                      batch=1 << 14, lr=2e-3, seed=1, device=dev)
    dt = time.perf_counter() - t0
    print(f"{args.iters} iters in {dt:.1f}s; NLL first={losses[0]:.4f} last={losses[-1]:.4f}")
    dump(stem + "_after.png", sample_hist(params, dev))
    with open(stem + "_metrics.json", "w") as f:
        json.dump({"target": args.target, "iters": args.iters, "train_s": dt,
                   "nll_first100": losses[0], "nll_final": losses[-1],
                   "nll_every_100": losses[::max(1, len(losses) // 40)], "device": str(dev)},
                  f, indent=1)
    print(f"wrote {stem}_{{target,before,after}}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
