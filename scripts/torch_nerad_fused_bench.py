"""A/B of the PyTorch port's nerad training step: the field's MLP in plain
torch (FieldConfig(fused=False)) against the fused kernel K2
(fused=True, which launches K2 on the card; on the CPU both run the plain
MLP), then the field's forward both ways on the same 8,192 seeded queries.

Usage: python scripts/torch_nerad_fused_bench.py [n_iters] [batch] [m_rhs]
           [--res N] [--device cuda|cpu] [--out DIR]
Prints a JSON line per variant and one of the whole result, which it also
writes to DIR/torch_nerad_fused_bench.json (DIR defaults to out/).  Step
times are host seconds per step over n_iters steps after one untimed step,
the device synchronized around the timed loop.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda  # noqa: E402
from mitsuba3_experiments_tpu_torch.models.nerad import (  # noqa: E402
    FieldConfig,
    NeradTrainer,
    field_eval,
    init_field,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_iters", nargs="?", type=int, default=50)
    ap.add_argument("batch", nargs="?", type=int, default=1 << 13)
    ap.add_argument("m_rhs", nargs="?", type=int, default=16)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    scene, _ = load_dict(cornell_box(res=args.res, spp=1), device=args.device)
    dev = scene.device
    results = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name, fused in (("plain", False), ("fused", True)):
        tr = NeradTrainer(field_cfg=FieldConfig(fused=fused), batch_size=args.batch,
                          m_rhs=args.m_rhs)
        init, step = tr.make_train_step(scene)
        field, opt = init(torch.Generator().manual_seed(0))
        k2 = fused_mlp_cuda.launches
        t0 = time.perf_counter()
        loss = step(field, opt, 0)
        sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(1, args.n_iters + 1):
            loss = step(field, opt, i)
        sync(dev)
        dt = (time.perf_counter() - t0) / max(args.n_iters, 1)
        results[name] = {"first_step_s": first_s, "step_ms": dt * 1e3, "final_loss": float(loss),
                         "k2_launches": fused_mlp_cuda.launches - k2}
        print(json.dumps({name: results[name]}), flush=True)

    # the field's forward both ways on the same parameters and queries
    cfg = FieldConfig()
    field = init_field(torch.Generator().manual_seed(1), cfg, device=dev)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (8192, 3)).astype(np.float32), device=dev)
    wi = rng.normal(size=(8192, 3)).astype(np.float32)
    wi = torch.as_tensor(wi / np.linalg.norm(wi, axis=-1, keepdims=True), device=dev)
    with torch.no_grad():
        a = field_eval(field, cfg, x, wi)
        b = field_eval(field, dataclasses.replace(cfg, fused=True), x, wi)
    results["forward_max_rel_diff"] = float((a - b).abs().max() / a.abs().max().clamp(min=1e-6))
    results["speedup"] = results["plain"]["step_ms"] / results["fused"]["step_ms"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_nerad_fused_bench.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
