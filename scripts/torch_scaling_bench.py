"""Ray-parallel scaling of the PyTorch port: camera rays/s of
`render_sharded(PathIntegrator(max_depth=4, rr_depth=2), spp=1)` in worlds
of 1, 2, 4 and 8 ranks, and the scaling efficiency against one rank.

Usage: python scripts/torch_scaling_bench.py [res] [tris] [--worlds 1,2,4,8]
           [--scene standin|flagship] [--xml PATH] [--cache-dir DIR]
           [--device cuda|cpu] [--out DIR]
Scene at res x res*9/16, spp 1, `tris` triangles.  This process compiles it
once and writes it to DIR/torch_scaling_scene.npz; each world is a set of
rank processes of this script, joined through a file:// rendezvous with a
timeout, which read that scene, render once untimed, then time 3 renders
(seeds 1-3) between barriers.  On the card (the default) a rank is a card
in an NCCL group, so the worlds stop at `torch.cuda.device_count()`; with
`--device cpu` a rank is a one-thread CPU process in a gloo group (the
counterpart of the JAX package's virtual CPU mesh).  A rank that fails, or
a world that outlives JOIN_S, fails the run.  Writes DIR/torch_scaling_bench.json
(DIR defaults to out/) and prints it on one line.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator  # noqa: E402
from mitsuba3_experiments_tpu_torch.parallel import make_mesh, render_sharded  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene import flagship  # noqa: E402
from mitsuba3_experiments_tpu_torch.scene.convert import (  # noqa: E402
    read_scene_npz,
    write_scene_npz,
)
from mitsuba3_experiments_tpu_torch.utils import device_label  # noqa: E402

ITERS = 3
COLLECTIVE_S = 120   # each collective's timeout inside a rank
JOIN_S = 600         # a whole world's run, start-up included


def run_rank(rank: int, world: int, init: str, scene_path: str, device: str, out: str) -> int:
    """One rank: join the world, render, write DIR/rank<r>.json."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_S))
    try:
        scene, _ = read_scene_npz(scene_path, dev)
        mesh = make_mesh(world)
        integ = PathIntegrator(max_depth=4, rr_depth=2)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()

        img = render_sharded(scene, integ, mesh, spp=1, seed=0)
        sync()
        t0 = time.perf_counter()
        for i in range(ITERS):
            img = render_sharded(scene, integ, mesh, spp=1, seed=i + 1)
        sync()
        dt = (time.perf_counter() - t0) / ITERS
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"seconds": dt, "mean": float(img.mean())}, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_world(world: int, scene_path: str, device: str, out: str) -> dict:
    """Starts the world's ranks, waits for them all (JOIN_S in all) and
    returns rank 0's result; any failed or late rank raises."""
    wdir = os.path.abspath(os.path.join(out, f"world{world}"))
    os.makedirs(wdir, exist_ok=True)
    init = os.path.join(wdir, "rendezvous")
    if os.path.exists(init):
        os.remove(init)
    procs = []
    for rank in range(world):
        with open(os.path.join(wdir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world",
                 str(world), "--init", init, "--scene-file", scene_path, "--device", device,
                 "--out", wdir], stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1")))
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = "".join(open(os.path.join(wdir, f"rank{r}.log")).read()[-2000:] for r in bad)
        raise RuntimeError(f"world {world}: ranks {bad} failed or timed out\n{logs}")
    with open(os.path.join(wdir, "rank0.json")) as f:
        return json.load(f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("res", nargs="?", type=int, default=320)
    ap.add_argument("tris", nargs="?", type=int, default=100_000)
    ap.add_argument("--worlds", default="1,2,4,8")
    ap.add_argument("--scene", choices=("standin", "flagship"), default="standin")
    ap.add_argument("--xml", default=None, help="the flagship's scene XML (default: "
                    "data/bedroom/scene.xml in the repository)")
    ap.add_argument("--cache-dir", default=flagship.CACHE_DIR)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default="out")
    # one rank of a world (this script started by itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--scene-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return run_rank(args.rank, args.world, args.init, args.scene_file, args.device, args.out)

    device = torch.device("cuda" if args.device is None else args.device)
    res = (args.res, args.res * 9 // 16)
    scene, meta = flagship.load_bedroom(args.scene, res=res, spp=1, tri_budget=args.tris,
                                        xml_path=args.xml, cache_dir=args.cache_dir,
                                        device="cpu")
    os.makedirs(args.out, exist_ok=True)
    scene_path = os.path.join(args.out, "torch_scaling_scene.npz")
    write_scene_npz(scene_path, scene, meta)
    w, h = scene.camera.resolution
    n_rays = w * h

    worlds = [int(x) for x in args.worlds.split(",")]
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA card; run with --device cpu for CPU ranks")
        skipped = [n for n in worlds if n > cards]
        worlds = [n for n in worlds if n <= cards]
        if skipped:
            print(f"# {cards} card(s): worlds {skipped} need more, not run", flush=True)
        label = device_label(torch.device("cuda", 0))
    else:
        label = f"cpu, {os.cpu_count()} cores"
    results = {}
    for n in worlds:
        r = run_world(n, scene_path, device.type, args.out)
        rays_s = n_rays / r["seconds"]
        base = rays_s if n == 1 else results.get(1, {}).get("rays_per_s")
        eff = rays_s / (base * n) if base else None
        results[n] = {"seconds": r["seconds"], "rays_per_s": rays_s, "efficiency": eff,
                      "mean": r["mean"]}
        print(f"ranks={n}: {rays_s / 1e3:8.1f} krays/s  scaling efficiency="
              + ("n/a" if eff is None else f"{eff * 100:5.1f}%"), flush=True)
    out = {"scene": args.scene, "res": [w, h], "triangles": int(scene.n_faces),
           "backend": "nccl" if device.type == "cuda" else "gloo", "device": label,
           "worlds": {str(n): v for n, v in results.items()}}
    with open(os.path.join(args.out, "torch_scaling_bench.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
