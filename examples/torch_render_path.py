"""Path-tracer comparison on the PyTorch port: render the Cornell box with
the MIS path tracer and the simple (BSDF-only) tracer, print their MSE and
what one render pass launches (utils.kernel_history: device kernels, their
device time, host operators, peak memory), and write EXR/PNG images.

Usage: python examples/torch_render_path.py [res] [spp] [--device cuda|cpu] [--out DIR]
Writes DIR/torch_path_mis.{exr,png}, DIR/torch_path_simple.png and
DIR/torch_render_path.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import (  # noqa: E402
    PathIntegrator,
    SimpleIntegrator,
    render,
    render_pass,
)
from mitsuba3_experiments_tpu_torch.render import film as filmlib  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import (  # noqa: E402
    kernel_history,
    mse,
    write_exr,
    write_png,
)

MAX_DEPTH, RR_DEPTH = 8, 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("res", nargs="?", type=int, default=256)
    ap.add_argument("spp", nargs="?", type=int, default=256)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    scene, _ = load_dict(cornell_box(res=args.res, spp=args.spp), device=args.device)
    img_mis = render(scene, PathIntegrator(max_depth=MAX_DEPTH, rr_depth=RR_DEPTH),
                     spp=args.spp).cpu().numpy()
    img_simple = render(scene, SimpleIntegrator(max_depth=MAX_DEPTH, rr_depth=RR_DEPTH),
                        spp=args.spp).cpu().numpy()
    err = mse(img_mis, img_simple)
    print(f"MSE (mis vs simple): {err:.3e}")

    # what one render pass launches (the JAX package reads XLA's cost
    # analysis of the compiled pass here)
    hist = kernel_history(render_pass, scene, PathIntegrator(max_depth=MAX_DEPTH), 0, 0,
                          filmlib.new_film(args.res, args.res, device=scene.device),
                          spp_per_pass=1, rfilter="box")
    print(f"one pass: {hist['kernels']} device kernels, {hist['device_ms']:.3f} ms of device "
          f"time, {hist['host_ops']} host operators, peak {hist['peak_bytes']} bytes")

    write_exr(os.path.join(args.out, "torch_path_mis.exr"), img_mis)
    write_png(os.path.join(args.out, "torch_path_mis.png"), img_mis)
    write_png(os.path.join(args.out, "torch_path_simple.png"), img_simple)
    out = {"res": args.res, "spp": args.spp, "device": str(scene.device), "mse_mis_simple": err,
           "pass_kernels": hist["kernels"], "pass_device_ms": hist["device_ms"],
           "pass_host_ops": hist["host_ops"], "pass_peak_bytes": hist["peak_bytes"]}
    with open(os.path.join(args.out, "torch_render_path.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}/torch_path_mis.{{exr,png}}, torch_path_simple.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
