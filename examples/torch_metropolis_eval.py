"""Metropolis sampler validation on the PyTorch port: chains against the
analytic bimodal target, the KL divergence every 50 iterations, the chain's
mean and standard deviation against the target's, and the histograms.

Usage: python examples/torch_metropolis_eval.py [chains] [iters]
           [--device cuda|cpu] [--out DIR]
Writes DIR/torch_metropolis_metrics.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators.metropolis import run_chain_1d  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("chains", nargs="?", type=int, default=16384)
    ap.add_argument("iters", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()

    kls, hist, target = run_chain_1d(n_chains=args.chains, n_iters=args.iters, seed=0,
                                     device=args.device)
    centers = (np.arange(len(hist)) + 0.5) / len(hist)
    mean = float((hist * centers).sum())
    t_mean = float((target * centers).sum())
    std = float(np.sqrt((hist * (centers - mean) ** 2).sum()))
    t_std = float(np.sqrt((target * (centers - t_mean) ** 2).sum()))
    print(f"KL history (every 50 it): {[round(k, 4) for k in kls]}")
    print(f"chain mean/std: {mean:.4f}/{std:.4f}  target: {t_mean:.4f}/{t_std:.4f}")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_metropolis_metrics.json")
    with open(path, "w") as f:
        json.dump({"kl": kls, "hist": hist.tolist(), "target": target.tolist(), "mean": mean,
                   "std": std, "target_mean": t_mean, "target_std": t_std}, f)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
