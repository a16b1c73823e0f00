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
          leave the last rank of a world of 3 without a lane;
  dp_inverse         the benchmark's loop file `inverse_dp` (the inverse
          step over the ranks through sharded_replay_grad) on
          cornell_box(res=GRAD_RES), spp 2, depth 3, replay chunks of
          DP_CHUNK rows (each rank's last chunk part empty): two steps,
          each gathered to rank 0, which keeps the gathered record, a
          one-process record of the same step, the gradients, the
          reference's gradients of the gathered record (benchmark/
          reference/) and the check's numbers; every rank keeps its
          parameters after each step, and the port's `m3t.dp.*` counters
          of the second step, taken under the profiler;
  dp_inverse_faults  the same, then two steps with a fault planted, whose
          check's numbers rank 0 keeps: rank 1 zeroes its own gradients
          before their all-reduce; rank 2's rows left out of the gather;
  strays  the Cornell box on a STRAY_W x 2 film (fov on its width, so the
          strip sees the lit back wall), spp 2, depth 3: sharded_replay_grad
          at STRAY_SEED, replay chunks of STRAY_CHUNK rows, against a seeded
          target; every rank keeps its gradients and its record.  One
          sample of that seed lands in the next pixel, in the next chunk.

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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
        loss, g, _ = sharded_replay_grad(box, params, target, 4, mesh, n_lanes=lanes,
                                         chunk=chunk, **kw)
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


DP_CHUNK = 96      # 512 rays: a world of 3 splits them unevenly
DP_SEED = 2**31 + 19


def dp_config() -> dict:
    """The four-card cell's configuration at the gradient suite's size."""
    import json

    with open(os.path.join(ROOT, "benchmark", "configs", "standin-d8-dp4.json")) as f:
        c = json.load(f)
    c.update(resolution=[GRAD_RES, GRAD_RES], spp=GRAD_SPP, max_depth=DEPTH, rr_depth=RR,
             replay_chunk=DP_CHUNK)
    return c


def _zero_own_grads(real):
    """sharded_replay_grad whose rank zeroes its own gradients before they
    are all-reduced."""
    from mitsuba3_experiments_tpu_torch.parallel import mesh as mesh_mod

    def sharded_replay_grad(*a, **k):
        sum_grads = mesh_mod._sum_grads
        mesh_mod._sum_grads = lambda g, m: sum_grads({n: v.zero_() for n, v in g.items()}, m)
        try:
            return real(*a, **k)
        finally:
            mesh_mod._sum_grads = sum_grads
    return sharded_replay_grad


def _dp_suite(device, faults: bool) -> dict:
    import json

    from benchmark import harness, loops, multicard
    from benchmark import reference as ref_mod
    from mitsuba3_experiments_tpu_torch import parallel
    from mitsuba3_experiments_tpu_torch.utils.profile import drain

    bench = os.path.join(ROOT, "benchmark")
    config = dp_config()
    with open(os.path.join(bench, "traffic", "inverse-dp.json")) as f:
        traffic = json.load(f)
    port = loops.Port()
    scene_dict = cornell_box(res=GRAD_RES, spp=GRAD_SPP)
    scene = port.build.load_dict(scene_dict, device=device)[0]
    me = multicard.Ranks(dist.get_rank(), dist.get_world_size(), device, dist.group.WORLD,
                         dist.new_group(backend="gloo"))
    loop = harness.load_loop(bench, traffic["loop"])(port, scene, config, traffic, DP_SEED,
                                                     harness.Spans(False, lambda: None),
                                                     ranks=me)
    ref = ref_mod.RefScene.build(scene_dict, device) if me.lead else None
    cfg = dict(spp=loop.spp, max_depth=loop.depth, rr_depth=loop.rr)
    res = {}
    for i in range(2):
        if i == 1:    # the port's counters of one step, kept while the profiler records
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                out = loop.step(i)
            res.update({f"count:{k}": torch.tensor(v) for k, v in drain().items()
                        if k.startswith("m3t.dp.")})
        else:
            out = loop.step(i)
        res[f"params{i}"] = torch.cat([v.detach().reshape(-1) for v in loop.p.values()])
        out = loop.gather(out)
        if not me.lead:
            continue
        p = {"materials.base_color": out["params"]["materials.base_color"],
             "emitters.radiance": torch.exp(out["params"][loops.LOG_RADIANCE])}
        one = port.integrators.record_full_pipelined(port.params.update(scene, p), out["seed"],
                                                     loop.n_rays, pad_to=loop.pad, **cfg)
        g_ref = loops._by_log(ref_mod.replay_grads(ref, p, loop.target, out["seed"], out["rec"],
                                                   loop.n_rays, chunk=loop.chunk, mode="full",
                                                   **cfg), p["emitters.radiance"])
        for f in ("prim", "u", "v", "occl"):
            res[f"rec{i}:{f}"] = getattr(out["rec"], f)
            res[f"one{i}:{f}"] = getattr(one, f)
        for k in g_ref:
            res[f"grads{i}:{k}"] = out["grads"][k]
            res[f"ref{i}:{k}"] = g_ref[k]
        for k, v in loop.check(ref_mod, ref, out).items():
            res[f"check{i}:{k}"] = torch.tensor(v)
    if faults:
        real = parallel.sharded_replay_grad
        if me.rank == 1:
            parallel.sharded_replay_grad = _zero_own_grads(real)
        out = loop.gather(loop.step(2))
        parallel.sharded_replay_grad = real
        got = {"zero_grads": out}
        out = loop.step(3)
        if me.rank == 2:
            out["part"] = out["part"]._replace(n_valid=0)
        got["drop_rows"] = loop.gather(out)
        for name, out in got.items():
            if me.lead:
                for k, v in loop.check(ref_mod, ref, out).items():
                    res[f"{name}:{k}"] = torch.tensor(v)
    return res


STRAY_W, STRAY_SPP, STRAY_CHUNK = 1024, 2, 64
# ray 895's jitter rounds to 1.0 in float32: from pixel 447 (chunk 13) into pixel 448 (chunk 14)
STRAY_SEED = 361


def stray_dict() -> dict:
    d = cornell_box(res=STRAY_W, spp=STRAY_SPP)
    d["sensor"]["film"]["height"] = 2
    d["sensor"]["fov_axis"] = "x"
    return d


def stray_target() -> np.ndarray:
    return np.random.default_rng(1).uniform(0.0, 0.5, (2, STRAY_W, 3)).astype(np.float32)


def suite_strays(mesh, device) -> dict:
    box = load_dict(stray_dict(), device=device)[0]
    n = STRAY_W * 2 * STRAY_SPP
    loss, g, part = sharded_replay_grad(
        box, params_of(box), torch.as_tensor(stray_target(), device=device), STRAY_SEED, mesh,
        n_lanes=-(-n // mesh.size()), spp=STRAY_SPP, max_depth=DEPTH, rr_depth=RR, ray_end=n,
        chunk=STRAY_CHUNK)
    out = {f"grads:{k}": v for k, v in g.items()}
    out.update({f"rec:{f}": getattr(part.rec, f) for f in ("prim", "u", "v", "occl")})
    out["start"], out["n_valid"] = torch.tensor(part.start), torch.tensor(part.n_valid)
    return out


SUITES = {"render": suite_render, "grads": suite_grads, "strays": suite_strays,
          "dp_inverse": lambda mesh, device: _dp_suite(device, False),
          "dp_inverse_faults": lambda mesh, device: _dp_suite(device, True)}
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
