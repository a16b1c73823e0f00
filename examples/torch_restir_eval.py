"""ReSTIR GI A/B evaluation on the PyTorch port: run N frames of each
configuration of a pair and record per-frame bias, variance and MSE against
a path-traced reference, and `mabs_bias`, the mean |running-average image -
reference| (per-frame mean |error| in dynamic mode, where the camera moves).

Usage: python examples/torch_restir_eval.py [mode] [frames] [res] [chunk] [scene]
           [--ref-spp N] [--dyn-ref-spp N] [--device cuda|cpu] [--out DIR]
  mode in {spatial, jacobian, spatial_spatial, dynamic}: bias correction,
  the reconnection Jacobian or spatial-spatial reuse on and off, or a
  camera that moves 0.005 a frame;
  chunk > 0 renders each frame in bands of `chunk` pixels
  (render_frame_chunked), the same image as a whole frame;
  scene in {cornell, sphere}: `sphere` adds a large diffuse sphere near the
  left wall, where neighbour reconnection Jacobians are far from 1.
The reference is render_persistent at --ref-spp (256), kept in
DIR/torch_restir_ref_<scene>_<res>_<spp>.npy for the next run; dynamic mode
renders one at --dyn-ref-spp (64) every frame.  Writes
DIR/restir_<mode>[_<scene>]_metrics.json, the file examples/restir_plot.py
draws, and DIR/restir_<mode>[_<scene>]_<config>.png (DIR defaults to out/).
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import RestirGI, render_persistent  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import mesh as meshlib  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import write_png  # noqa: E402

CONFIG_PAIRS = {
    "spatial": [{"bias_correction": True, "jacobian": True},
                {"bias_correction": False, "jacobian": True}],
    "jacobian": [{"bias_correction": True, "jacobian": True},
                 {"bias_correction": True, "jacobian": False}],
    "spatial_spatial": [{"spatial_spatial_reuse": True}, {"spatial_spatial_reuse": False}],
    "dynamic": [{}],
}


def scene_dict(res: int, name: str) -> dict:
    d = cornell_box(res=res, spp=1)
    if name == "sphere":
        sph = meshlib.sphere(center=(-0.45, -0.45, 0.1), radius=0.52, n_theta=48, n_phi=96)
        d["sphere"] = {"type": "mesh", "vertices": np.asarray(sph.vertices),
                       "faces": np.asarray(sph.faces), "normals": np.asarray(sph.normals),
                       "bsdf": {"type": "ref", "id": "white"}}
    return d


def reference(scene, spp: int) -> np.ndarray:
    return render_persistent(scene, spp=spp, max_depth=8, rr_depth=2).cpu().numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=tuple(CONFIG_PAIRS), default="spatial")
    ap.add_argument("frames", nargs="?", type=int, default=100)
    ap.add_argument("res", nargs="?", type=int, default=256)
    ap.add_argument("chunk", nargs="?", type=int, default=0)
    ap.add_argument("scene", nargs="?", choices=("cornell", "sphere"), default="cornell")
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--dyn-ref-spp", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    res = args.res

    scene, _ = load_dict(scene_dict(res, args.scene), device=args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "dynamic":
        ref = None   # rendered every frame
    else:
        ref_path = os.path.join(args.out,
                                f"torch_restir_ref_{args.scene}_{res}_{args.ref_spp}.npy")
        if os.path.exists(ref_path):
            ref = np.load(ref_path)
            print(f"reference: loaded {ref_path}")
        else:
            print(f"reference render ({args.ref_spp} spp)...")
            ref = reference(scene, args.ref_spp)
            np.save(ref_path, ref)

    tag = args.mode if args.scene == "cornell" else f"{args.mode}_{args.scene}"
    results = {}
    for ci, overrides in enumerate(CONFIG_PAIRS[args.mode]):
        integ = RestirGI(max_depth=8, rr_depth=2, **overrides)
        state = integ.init_state(scene)
        bias, var, mse_curve, mabs = [], [], [], []
        avg = None
        cur = scene
        for i in range(args.frames):
            if args.mode == "dynamic":
                to_world = cur.camera.to_world.clone()
                to_world[0, 3] += 0.005
                cur = dataclasses.replace(cur, camera=dataclasses.replace(cur.camera,
                                                                           to_world=to_world))
            if args.chunk:
                img, state = integ.render_frame_chunked(cur, state, i, chunk=args.chunk)
            else:
                img, state = integ.render_frame(cur, state, i)
            img = img.cpu().numpy()
            if args.mode == "dynamic":
                # the camera moves every frame: a per-frame reference
                ref = reference(cur, args.dyn_ref_spp)
            diff = img - ref
            bias.append(float(diff.mean()))
            var.append(float(img.var()))
            mse_curve.append(float((diff ** 2).mean()))
            if args.mode == "dynamic":
                mabs.append(float(np.abs(diff).mean()))
            else:
                avg = img.copy() if avg is None else avg + (img - avg) / (i + 1)
                mabs.append(float(np.abs(avg - ref).mean()))
            if i % 20 == 0:
                print(f"  config {ci} frame {i}: mse={mse_curve[-1]:.4f} "
                      f"mabs_bias={mabs[-1]:.4f}", flush=True)
        results[f"config{ci}_{json.dumps(overrides)}"] = {
            "bias": bias, "variance": var, "mse": mse_curve, "mabs_bias": mabs}
        write_png(os.path.join(args.out, f"restir_{tag}_{ci}.png"), img)

    path = os.path.join(args.out, f"restir_{tag}_metrics.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
