"""Normalizing-flow training on the PyTorch port: a flow trained by NLL on
the double spiral or on an image target (a procedural checker disc), then
its density and a histogram of its samples written as PNGs.

Usage: python examples/torch_train_normflow.py [iters] [spiral|image] [rqs|affine]
           [--device cuda|cpu] [--out DIR]
The spline couplings ("rqs", the default) reach the affine flow's NLL in
far fewer iterations on the spiral; "affine" is the RealNVP family.
Writes DIR/torch_normflow_{density,samples}.png (DIR defaults to out/).
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch import resolve_device  # noqa: E402
from mitsuba3_experiments_tpu_torch.core.rng import Sampler  # noqa: E402
from mitsuba3_experiments_tpu_torch.models import normflow as nf  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import write_png  # noqa: E402


def checker_disc(res=64):
    img = np.zeros((res, res), np.float32)
    yy, xx = np.mgrid[0:res, 0:res]
    img[((xx // 8 + yy // 8) % 2 == 0) & (((xx - 32) ** 2 + (yy - 32) ** 2) < 900)] = 1.0
    return img


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=3000)
    ap.add_argument("target", nargs="?", choices=("spiral", "image"), default="spiral")
    ap.add_argument("coupling", nargs="?", choices=("rqs", "affine"), default="rqs")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = nf.FlowConfig(n_couplings=6, hidden=64, coupling=args.coupling)
    if args.target == "spiral":
        sample_fn = nf.spiral_sample
    else:
        distr = nf.ImageDistr(checker_disc(), device=dev)

        def sample_fn(generator, n):
            # a fresh counter-based sampler seeded from the generator
            seed = int(torch.randint(0, 1 << 31, (1,), generator=generator,
                                     device=generator.device))
            return distr.sample(Sampler.create(seed, n, device=dev))[1]

    lr = 3e-3 if args.coupling == "rqs" else 1e-3
    params, losses = nf.train_flow(sample_fn, cfg, n_iters=args.iters, batch=1 << 14, lr=lr,
                                   device=dev)
    print(f"NLL every 100 it: {[round(l, 3) for l in losses]}")

    with torch.no_grad():
        g = torch.stack(torch.meshgrid(torch.linspace(0, 1, 128, device=dev),
                                       torch.linspace(0, 1, 128, device=dev), indexing="xy"),
                        -1).reshape(-1, 2)
        logp = nf.flow_log_eval(params, cfg, g).reshape(128, 128).cpu().numpy()
        xs, _ = nf.flow_sample(params, cfg, torch.Generator(device=dev).manual_seed(5), 1 << 14)
        xs = xs.cpu().numpy()
    dens = np.exp(logp - logp.max())
    write_png(os.path.join(args.out, "torch_normflow_density.png"),
              np.repeat(dens[..., None], 3, -1))
    hist, _, _ = np.histogram2d(xs[:, 1], xs[:, 0], bins=128, range=[[0, 1], [0, 1]])
    write_png(os.path.join(args.out, "torch_normflow_samples.png"),
              np.repeat((hist / max(hist.max(), 1e-9))[..., None], 3, -1))
    print(f"wrote {args.out}/torch_normflow_{{density,samples}}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
