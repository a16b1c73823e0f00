"""Neural-radiosity training on the PyTorch port: train the hash-grid + SH
field on the Cornell box against the one-bounce right-hand side, and every
tenth of the run render with the field and take the MSE against a path
traced reference.

Usage: python examples/torch_train_nerad.py [iters] [batch_pow2] [--res N] [--ref-spp N]
           [--fused] [--device cuda|cpu] [--out DIR]
--fused evaluates the field's MLP with the fused kernel (K2) on the card.
Writes DIR/torch_nerad_<iteration>.png, DIR/torch_nerad_ref.png and
DIR/torch_train_nerad.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render  # noqa: E402
from mitsuba3_experiments_tpu_torch.models import (  # noqa: E402
    FieldConfig,
    HashGridConfig,
    NeradIntegrator,
    NeradTrainer,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402
from mitsuba3_experiments_tpu_torch.utils import mse, write_png  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=1000)
    ap.add_argument("batch_pow2", nargs="?", type=int, default=14)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--fused", action="store_true", help="the fused MLP kernel (card only)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    scene, _ = load_dict(cornell_box(res=args.res, spp=1), device=args.device)
    ref = render(scene, PathIntegrator(max_depth=8, rr_depth=4), spp=args.ref_spp).cpu().numpy()
    trainer = NeradTrainer(
        field_cfg=FieldConfig(
            grid=HashGridConfig(n_levels=8, log2_table_size=15, base_resolution=8,
                                finest_resolution=256),
            width=64, depth=4, fused=args.fused,
        ),
        batch_size=1 << args.batch_pow2, m_rhs=32, lr=1e-3,
    )
    init, step = trainer.make_train_step(scene)
    field, opt = init(torch.Generator().manual_seed(0))

    val_every = max(args.iters // 10, 1)
    log = []
    for i in range(args.iters):
        loss = step(field, opt, i)
        if (i + 1) % val_every == 0:
            img = render(scene, NeradIntegrator(trainer, field), spp=2).cpu().numpy()
            log.append({"iteration": i + 1, "loss": float(loss), "val_mse": mse(img, ref)})
            print(f"it {i + 1}: loss={log[-1]['loss']:.5f} val_mse={log[-1]['val_mse']:.5f}",
                  flush=True)
            write_png(os.path.join(args.out, f"torch_nerad_{i + 1}.png"), img)

    write_png(os.path.join(args.out, "torch_nerad_ref.png"), ref)
    with open(os.path.join(args.out, "torch_train_nerad.json"), "w") as f:
        json.dump({"res": args.res, "batch": 1 << args.batch_pow2, "fused": args.fused,
                   "device": str(scene.device), "validation": log}, f, indent=1)
    print(f"wrote {args.out}/torch_nerad_*.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
