"""Neural radiosity at the full reference recipe on the PyTorch port: batch
2^14, 1,000 iterations, M=32 right-hand-side samples, Adam 1e-3, and the
validation MSE against a 1,000-spp path-traced reference.

Usage: python scripts/torch_nerad_fullrecipe.py [iters] [batch_pow2] [ref_spp]
           [--res N] [--fused] [--device cuda|cpu] [--out DIR]
Scene: cornell_box(res=128).  Reference: `render(PathIntegrator(max_depth=8,
rr_depth=4), spp=ref_spp, seed=99)`.  Field: hash grid of 8 levels, 2^15
entries, resolutions 8 to 256; MLP width 64, depth 4; `--fused` evaluates it
with the fused kernel (K2) on the card.  Timing: one untimed step, then the
mean of 10 timed steps, the device synchronized around them.  Validation MSE
every iters // 10 at spp 2, and the final render at spp 8.  Writes
DIR/torch_nerad_fullrecipe.json and DIR/torch_nerad_fullrecipe_{final,ref}.png
(DIR defaults to out/) and prints a summary JSON line.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render  # noqa: E402
from mitsuba3_experiments_tpu_torch.models import (  # noqa: E402
    FieldConfig,
    HashGridConfig,
    NeradIntegrator,
    NeradTrainer,
    fused_mlp_cuda,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import device_label, mse, write_png  # noqa: E402

TIMED_STEPS = 10


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=1000)
    ap.add_argument("batch_pow2", nargs="?", type=int, default=14)
    ap.add_argument("ref_spp", nargs="?", type=int, default=1000)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--fused", action="store_true", help="the fused MLP kernel (card only)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    batch = 1 << args.batch_pow2

    scene, _ = load_dict(cornell_box(res=args.res, spp=1), device=args.device)
    dev = scene.device
    sync(dev)
    t0 = time.perf_counter()
    ref = render(scene, PathIntegrator(max_depth=8, rr_depth=4), spp=args.ref_spp,
                 seed=99).cpu().numpy()
    ref_s = time.perf_counter() - t0
    print(f"# {args.ref_spp}-spp reference: {ref_s:.1f} s", flush=True)

    trainer = NeradTrainer(
        field_cfg=FieldConfig(
            grid=HashGridConfig(n_levels=8, log2_table_size=15, base_resolution=8,
                                finest_resolution=256),
            width=64, depth=4, fused=args.fused,
        ),
        batch_size=batch, m_rhs=32, lr=1e-3,
    )
    init, step = trainer.make_train_step(scene)
    field, opt = init(torch.Generator().manual_seed(0))
    k2 = fused_mlp_cuda.launches

    # one untimed step (it builds the kernels), then the steady-state step
    loss = step(field, opt, 0)
    sync(dev)
    timed = min(TIMED_STEPS, max(args.iters - 1, 0))
    t0 = time.perf_counter()
    for i in range(1, timed + 1):
        loss = step(field, opt, i)
    sync(dev)
    step_ms = (time.perf_counter() - t0) / max(timed, 1) * 1e3
    print(f"# train step: {step_ms:.1f} ms (batch {batch}, M=32, fused {args.fused})",
          flush=True)

    curve = []
    val_every = max(args.iters // 10, 1)
    t_train = time.perf_counter()
    for i in range(timed + 1, args.iters):
        loss = step(field, opt, i)
        if (i + 1) % val_every == 0 or i == args.iters - 1:
            img = render(scene, NeradIntegrator(trainer, field), spp=2).cpu().numpy()
            curve.append({"it": i + 1, "loss": float(loss), "val_mse": mse(img, ref)})
            print(f"it {i + 1}: loss={curve[-1]['loss']:.5f} val_mse={curve[-1]['val_mse']:.5f}",
                  flush=True)
    sync(dev)
    t_train = time.perf_counter() - t_train

    final = render(scene, NeradIntegrator(trainer, field), spp=8).cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    write_png(os.path.join(args.out, "torch_nerad_fullrecipe_final.png"), final)
    write_png(os.path.join(args.out, "torch_nerad_fullrecipe_ref.png"), ref)
    out = {
        "recipe": {"iters": args.iters, "batch": batch, "m_rhs": 32, "lr": 1e-3,
                   "ref_spp": args.ref_spp, "res": args.res, "fused": args.fused},
        "reference_s": ref_s, "train_step_ms": step_ms, "train_s_total": t_train,
        "final_loss": float(loss), "final_val_mse_spp8": mse(final, ref), "curve": curve,
        "k2_launches": fused_mlp_cuda.launches - k2, "device": device_label(dev),
    }
    with open(os.path.join(args.out, "torch_nerad_fullrecipe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("train_step_ms", "final_val_mse_spp8", "k2_launches",
                                          "device")} | {"curve_tail": curve[-3:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
