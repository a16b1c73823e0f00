"""One rank of the port's parallel tests: joins a gloo world through a file
rendezvous, runs one suite of the parallel/ entry points on DEVICE (the
CPU, or cuda:0 for every rank of a world on one card) and writes what it
got to OUT/rank<RANK>.npz.

    python tests/torch_parallel_ranks.py SUITE RANK WORLD INIT_FILE OUT [DEVICE]

Suites (the scenes and settings of tests/test_torch_parallel_*.py):

  render  cornell_box(res=32) and the same box seen with fov 15, whose
          corner pixel (0, 0) looks at the lit back wall; PathIntegrator
          depth 3, rr_depth 2: render_sharded unchunked and with a chunk of
          48 lanes (padded), render_persistent_sharded;
  grads   cornell_box(res=16), spp 2, depth 3, rr_depth 2, against a
          seeded target: sharded_replay_grad with a lane per ray and with
          fewer lanes than rays and chunks, sharded_grad_step; then
          sharded_grad_step on cornell_box(res=TINY_RES), whose 4 lanes
          leave the last rank of a world of 3 without a lane.

`start`, `collect` and `stop` run a world of these processes for a test.  Imports
neither jax nor the JAX package.
"""
import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator  # noqa: E402
from mitsuba3_experiments_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    render_persistent_sharded,
    render_sharded,
    sharded_grad_step,
    sharded_replay_grad,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402

DEPTH, RR = 3, 2
GRAD_RES, GRAD_SPP = 16, 2
TINY_RES = 2
DIFF_KEYS = ("materials.base_color", "emitters.radiance")


def box_dict(res: int, fov: float | None = None) -> dict:
    d = cornell_box(res=res, spp=1)
    if fov is not None:
        d["sensor"]["fov"] = fov
    return d


def grad_target(res: int = GRAD_RES) -> np.ndarray:
    """The seeded target image of the gradient suite."""
    return np.random.default_rng(0).uniform(0.0, 0.5, (res, res, 3)).astype(np.float32)


def suite_render(mesh, device) -> dict:
    box = load_dict(box_dict(32), device=device)[0]
    fov = load_dict(box_dict(32, fov=15.0), device=device)[0]
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    return {
        "box": render_sharded(box, integ, mesh, spp=4, seed=5),
        "fov": render_sharded(fov, integ, mesh, spp=2, seed=7),
        "fov_chunk": render_sharded(fov, integ, mesh, spp=2, seed=7, chunk=48),
        "persistent": render_persistent_sharded(box, mesh, seed=3, spp=2, max_depth=DEPTH,
                                                rr_depth=RR, n_lanes=128),
    }


def suite_grads(mesh, device) -> dict:
    box = load_dict(box_dict(GRAD_RES), device=device)[0]
    target = torch.as_tensor(grad_target(), device=device)
    params = params_of(box)
    ndev = mesh.size()
    n = GRAD_RES * GRAD_RES * GRAD_SPP
    per = -(-n // ndev)
    kw = dict(spp=GRAD_SPP, max_depth=DEPTH, rr_depth=RR, ray_end=n)
    out = {}
    for name, lanes, chunk in (("replay", per, None), ("replay_chunked", max(per // 2, 16),
                                                         max(per // 2, 16))):
        loss, g = sharded_replay_grad(box, params, target, 4, mesh, n_lanes=lanes, chunk=chunk,
                                      **kw)
        out[f"{name}_loss"] = loss
        out.update({f"{name}:{k}": g[k] for k in DIFF_KEYS})
    loss, g = sharded_grad_step(box, params, target, 0, mesh,
                                PathIntegrator(max_depth=DEPTH, rr_depth=RR, differentiable=True))
    out["step_loss"] = loss
    out.update({f"step:{k}": g[k] for k in DIFF_KEYS})
    tiny = load_dict(box_dict(TINY_RES), device=device)[0]
    loss, g = sharded_grad_step(tiny, {k: params_of(tiny)[k] for k in DIFF_KEYS},
                                torch.as_tensor(grad_target(TINY_RES), device=device), 0, mesh,
                                PathIntegrator(max_depth=DEPTH, rr_depth=RR, differentiable=True))
    out["tiny_step_loss"] = loss
    out.update({f"tiny_step:{k}": g[k] for k in DIFF_KEYS})
    return out


def params_of(scene) -> dict:
    return {"materials.base_color": scene.materials.base_color,
            "emitters.radiance": scene.emitters.radiance}


SUITES = {"render": suite_render, "grads": suite_grads}
JOIN_S = 120   # a world's whole run; each collective also times out after 60 s


def start(suite: str, world: int, out: str, device: str = "cpu") -> list:
    """Starts the `world` rank processes of `suite` on `device`, writing
    into `out`."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    init = os.path.join(out, "rendezvous")
    procs = []
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite, str(rank), str(world), init,
                 out, device], stdout=log, stderr=subprocess.STDOUT, env=env))
    return procs


def stop(procs: list):
    """Kills the ranks still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def collect(procs: list, out: str) -> list:
    """Waits for every rank (JOIN_S in all) and returns each rank's results
    as a dict of numpy arrays; a rank that fails or hangs fails the world,
    and no rank is left running."""
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(procs)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = "".join(open(os.path.join(out, f"rank{r}.log")).read()[-2000:] for r in bad)
        raise RuntimeError(f"ranks {bad} of {len(procs)} failed or timed out:\n{logs}")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(len(procs))]


def main() -> int:
    suite, rank, world, init_file, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    device = torch.device(sys.argv[6] if len(sys.argv) > 6 else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        res = SUITES[suite](make_mesh(world), device)
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
