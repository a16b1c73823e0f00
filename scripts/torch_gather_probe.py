#!/usr/bin/env python3
"""Dependent row-gather probe on one CUDA card: the port's counterpart of
scripts/pallas_gather_probe.py.

    python3 scripts/torch_gather_probe.py [n_lanes] [iters] [block]
    # defaults 65536 64 256

A traversal step cannot fetch its next BVH row before the current row says
which one it is.  This measures that chain without the traversal math, on
a seeded table shaped like the stand-in's unified BVH table (431,104 rows
of 88 float32, 151.8 MB, three times the H100's L2), three ways, each with
CUDA events after a warm-up:

  * kernel:    K4 (csrc/gather_chain.cu), a group of threads per lane
               (chain) fetching the whole 352-byte row per step in one
               coalesced load, `block` chains per block;
  * torch_dep: the plain chain, a loop of `index_select` (the analogue of
               the probe's xla_dep);
  * torch_ind: `index_select` over precomputed independent indices, the
               same number of rows (the analogue of xla_ind).

Prints the card's `nvidia-smi` name and power limit, then one JSON line
with ns per row fetched for each, K4's bytes bound (the distinct rows the
chain reaches, each read once: `gather_probe.chain_bytes`, as in
chip_smoke.py), whether the kernel's final indices and accumulators equal
the plain chain's, and the shapes.  Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HBM_BYTES_S = 3.35e12   # the H100 SXM's published device-memory rate


def cuda_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_gather_probe: no CUDA device is available", file=sys.stderr)
        return 1
    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    block = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    dev = torch.device("cuda")
    table = torch.as_tensor(gather_probe.build_table(0), device=dev)
    rng = np.random.default_rng(1)
    rows_n = table.shape[0]
    idx0 = torch.as_tensor(rng.integers(0, rows_n, n).astype(np.int32), device=dev)
    idxs = torch.as_tensor(rng.integers(0, rows_n, (iters, n)).astype(np.int32), device=dev)
    fetched = n * iters

    got = gather_probe.dep_chain(table, idx0, iters, block)
    ref = gather_probe.dep_chain_plain(table, idx0, iters)
    torch.cuda.synchronize()
    match = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))

    def kernel():
        gather_probe_cuda.dep_chain_cuda(table, idx0, iters, block, check=False)

    def plain_dep():
        gather_probe.dep_chain_plain(table, idx0, iters)

    def plain_ind():
        gather_probe.ind_gather_plain(table, idxs)

    res = {}
    for name, fn, reps in (("kernel", kernel, 20), ("torch_dep", plain_dep, 3),
                           ("torch_ind", plain_ind, 3)):
        fn()
        ms = cuda_ms(fn, reps)
        res[f"{name}_ns_row"] = ms * 1e6 / fetched
        print(f"{name}: {ms:.4f} ms = {ms * 1e6 / fetched:.3f} ns/row ({card})", flush=True)
    k_ms = res["kernel_ns_row"] * fetched * 1e-6
    distinct, nbytes = gather_probe.chain_bytes(table, idx0, iters)
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    all_hbm_ms = fetched * gather_probe.ROW_FLOATS * 4 / HBM_BYTES_S * 1e3
    print(f"bytes bound ({distinct} distinct rows reached, each read once) {bound_ms:.4f} ms "
          f"at 3.35 TB/s: kernel at {bound_ms / k_ms:.4f} of it; every fetch from device "
          f"memory (not a bound: most hit the caches) would be {all_hbm_ms:.4f} ms", flush=True)
    res.update(bound_ms=bound_ms, distinct_rows=distinct, all_fetches_hbm_ms=all_hbm_ms)
    res.update(kernel_matches_plain=match, n_lanes=n, iters=iters, block=block,
               row_floats=gather_probe.ROW_FLOATS, table_rows=rows_n, card=card)
    print(json.dumps(res))
    return 0 if match else 1


if __name__ == "__main__":
    sys.exit(main())
