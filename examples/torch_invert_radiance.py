"""Inverse rendering on the PyTorch port's path-replay gradients: recover
the Cornell box's emitter radiance (and its albedos) from a target image by
gradient descent, with no ray traversal inside the autograd graph
(integrators/replay.py: record without autograd, differentiate the replay).

Usage: python examples/torch_invert_radiance.py [steps] [res] [spp]
           [--device cuda|cpu] [--out DIR]
Adam at lr 0.2, each parameter clipped at 0 after each step (as the JAX
example's optax.adam(2e-1) and clip).  Writes DIR/torch_invert_final.png and
DIR/torch_invert_radiance.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import (  # noqa: E402
    PathIntegrator,
    render,
    replay_render_grad,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict, params  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import write_png  # noqa: E402

DEPTH, RR = 5, 4


def emitter_rel_err(p, true_rad) -> float:
    return float((p["emitters.radiance"] - true_rad).abs().max() / true_rad.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=40)
    ap.add_argument("res", nargs="?", type=int, default=64)
    ap.add_argument("spp", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    scene, _ = load_dict(cornell_box(res=args.res, spp=args.spp), device=args.device)
    n_rays = args.res * args.res * args.spp
    # the target image at the true parameters
    target = render(scene, PathIntegrator(max_depth=DEPTH), spp=args.spp, rfilter="box")
    true_rad = scene.emitters.radiance

    # start from wrong parameters
    p = {
        "emitters.radiance": (scene.emitters.radiance * 0.25).clone(),
        "materials.base_color": torch.clamp(scene.materials.base_color * 0.6 + 0.2, 0.0, 1.0),
    }
    opt = torch.optim.Adam(list(p.values()), lr=2e-1)
    errs = []
    for it in range(args.steps):
        g = replay_render_grad(params.update(scene, p), p, params.update, target, it + 1, 0,
                               n_rays, spp=args.spp, max_depth=DEPTH, rr_depth=RR, rfilter="box")
        for k, v in p.items():
            v.grad = g[k]
        opt.step()
        with torch.no_grad():
            for v in p.values():
                v.clamp_(min=0.0)
        if it % 5 == 0 or it == args.steps - 1:
            errs.append((it, emitter_rel_err(p, true_rad)))
            print(f"step {it}: emitter rel err {errs[-1][1]:.3f}", flush=True)

    final = render(params.update(scene, p), PathIntegrator(max_depth=DEPTH),
                   spp=args.spp).cpu().numpy()
    write_png(os.path.join(args.out, "torch_invert_final.png"), final)
    lit = true_rad.sum(-1) > 0
    out = {"steps": args.steps, "res": args.res, "spp": args.spp, "device": str(scene.device),
           "emitter_rel_err": errs, "true_radiance": true_rad[lit][:2].tolist(),
           "recovered": p["emitters.radiance"][lit][:2].tolist()}
    with open(os.path.join(args.out, "torch_invert_radiance.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("true radiance rows:", out["true_radiance"])
    print("recovered:", out["recovered"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
