"""PSSMLT against the path tracer on the PyTorch port: render a scene with
the PSSMLT chain integrator, with the path tracer at the same budget (one
path sample per chain and sampling round) and with a many-spp reference;
write the images, the difference image and the MSEs.  `caustic` is the
hard-transport scene: a glass sphere focusing a small bright light onto a
diffuse floor, where Markov-chain exploration beats independent sampling.

Usage: python examples/torch_run_pssmlt.py [res] [iterations] [cornell|caustic]
           [--mode path|simple] [--ref-spp N] [--device cuda|cpu] [--out DIR]
With --mode simple both integrators sample BSDFs only (Pssmlt(mode="simple")
against SimpleIntegrator).  `mean_ratio` is the PSSMLT image's mean over the
reference's: the chains start from the bootstrap rounds' last state, so it
reads low until they have mixed.
Writes DIR/torch_pssmlt_<scene>_<mode>_<iterations>{,_ref,_diff}.png and
..._metrics.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.core import math as m  # noqa: E402
from mitsuba3_experiments_tpu_torch.integrators import (  # noqa: E402
    PathIntegrator,
    Pssmlt,
    SimpleIntegrator,
    render,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import mesh as meshlib  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import write_png  # noqa: E402


def caustic_scene(res: int) -> dict:
    """Glass sphere over a diffuse floor, small bright area light."""
    sph = meshlib.sphere(radius=0.5, n_theta=24, n_phi=48)
    floor = meshlib.rectangle(subdiv=8)
    light = meshlib.rectangle(subdiv=1)
    fv = (floor.vertices * 4.0) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    lv = light.vertices * 0.15 @ np.array(
        [[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32) + np.array([1.2, 2.5, 1.2], np.float32)
    return {
        "type": "scene",
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": m.look_at([0, 2.2, 4.5], [0, 0.4, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
        },
        "ball": {"type": "mesh", "vertices": sph.vertices + np.array([0, 0.8, 0], np.float32),
                 "faces": sph.faces, "bsdf": {"type": "dielectric", "int_ior": 1.5}},
        "floor": {"type": "mesh", "vertices": fv, "faces": floor.faces,
                  "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.55, 0.5]}},
        "light": {"type": "mesh", "vertices": lv, "faces": light.faces,
                  "bsdf": {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
                  "emitter": {"type": "area", "radiance": [400.0, 380.0, 350.0]}},
    }


def mse(a, b):
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("res", nargs="?", type=int, default=128)
    ap.add_argument("iterations", nargs="?", type=int, default=200)
    ap.add_argument("scene", nargs="?", choices=("cornell", "caustic"), default="cornell")
    ap.add_argument("--mode", choices=("path", "simple"), default="path")
    ap.add_argument("--ref-spp", type=int, default=1024)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    d = caustic_scene(args.res) if args.scene == "caustic" else cornell_box(res=args.res, spp=1)
    scene, _ = load_dict(d, device=args.device)
    path = (PathIntegrator if args.mode == "path" else SimpleIntegrator)(max_depth=8, rr_depth=4)
    ref = render(scene, path, spp=args.ref_spp, seed=101).cpu().numpy()
    integ = Pssmlt(max_depth=8, rr_depth=4, mode=args.mode)
    img = integ.render(scene, seed=0, n_iterations=args.iterations).cpu().numpy()
    # equal budget: one path sample per chain and sampling round
    eq_spp = max(2, args.iterations - integ.bootstrap_count)
    eq = render(scene, path, spp=eq_spp, seed=11).cpu().numpy()
    m_pssmlt, m_path = mse(img, ref), mse(eq, ref)

    stem = os.path.join(args.out, f"torch_pssmlt_{args.scene}_{args.mode}_{args.iterations}")
    write_png(stem + ".png", img)
    write_png(stem + "_ref.png", ref)
    write_png(stem + "_diff.png", np.abs(img - ref))
    out = {
        "scene": args.scene, "mode": args.mode, "res": args.res, "iterations": args.iterations,
        "bootstrap": integ.bootstrap_count, "ref_spp": args.ref_spp,
        "equal_budget_spp": eq_spp, "device": str(scene.device),
        "mse_pssmlt": m_pssmlt, "mse_path_equal_budget": m_path,
        "pssmlt_vs_path": m_pssmlt / m_path if m_path > 0 else None,
        "mean_ratio": float(img.mean()) / float(ref.mean()),
    }
    with open(stem + "_metrics.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
