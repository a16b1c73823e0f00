"""Multi-rank dry run of the PyTorch port's parallel/ entry points: the four
sharded paths of the JAX package's dryrun_multichip (__graft_entry__.py) on
cornell_box(res=16), each rank on its own device, results checked finite.

    torchrun --nproc_per_node N examples/torch_dryrun_multichip.py [--device cuda|cpu]
             [--out DIR]

One rank a process: torchrun sets RANK, WORLD_SIZE, LOCAL_RANK and the
rendezvous address.  On the card (the default) the group is NCCL and rank r
uses cuda:<LOCAL_RANK>; with --device cpu it is gloo.  Collectives time out
after 60 s.  Rank 0 prints one JSON line of the losses and image means and
writes it to DIR/torch_dryrun_multichip.json (DIR defaults to out/).
"""
import argparse
import json
import os
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitsuba3_experiments_tpu_torch import resolve_device  # noqa: E402
from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator  # noqa: E402
from mitsuba3_experiments_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    render_persistent_sharded,
    render_sharded,
    sharded_grad_step,
    sharded_replay_grad,
)
from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict  # noqa: E402

RES = 16


def run(device) -> dict:
    world = dist.get_world_size()
    mesh = make_mesh(world)
    scene, _ = load_dict(cornell_box(res=RES, spp=1), device=device)

    # forward sharded render: each rank's lanes, one film all-reduce
    img = render_sharded(scene, PathIntegrator(max_depth=3), mesh, spp=1)
    check(bool(torch.isfinite(img).all()), "non-finite sharded render")

    # a training step: differentiable render, MSE, summed gradients
    params = {"materials.base_color": scene.materials.base_color,
              "emitters.radiance": scene.emitters.radiance}
    target = torch.zeros((RES, RES, 3), device=device)
    loss, grads = sharded_grad_step(
        scene, params, target, 0, mesh,
        PathIntegrator(max_depth=3, rr_depth=2, differentiable=True), spp_per_pass=1)
    check(bool(torch.isfinite(loss)), "non-finite loss in the sharded grad step")

    # production forward: each rank's slice of the ray stream, one splat
    img_p = render_persistent_sharded(scene, mesh, seed=0, spp=1, max_depth=3, rr_depth=2,
                                      n_lanes=64)
    check(bool(torch.isfinite(img_p).all()), "non-finite persistent render")

    # production fwd+bwd: record each rank's slice, replay it in chunks
    n_rays = RES * RES
    per = -(-n_rays // world)
    loss2, grads2, _ = sharded_replay_grad(
        scene, params, target, 0, mesh, idx0=0, n_lanes=max(per // 2, 8), spp=1, max_depth=3,
        rr_depth=2, ray_end=n_rays, chunk=per)
    check(bool(torch.isfinite(loss2)), "non-finite replay loss")
    for g in (*grads.values(), *grads2.values()):
        check(bool(torch.isfinite(g).all()), "non-finite gradient")
    return {
        "world": world, "device": str(device), "render_mean": float(img.mean()),
        "persistent_mean": float(img_p.mean()), "grad_step_loss": float(loss),
        "replay_loss": float(loss2),
        "grad_step_emitter_grad_sum": float(grads["emitters.radiance"].sum()),
        "replay_emitter_grad_sum": float(grads2["emitters.radiance"].sum()),
    }


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    if "RANK" not in os.environ:
        ap.error("start it with torchrun, which sets RANK, WORLD_SIZE and the rendezvous")

    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=timedelta(seconds=60))
    try:
        out = run(device)
    finally:
        dist.destroy_process_group()
    if int(os.environ["RANK"]) == 0:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_dryrun_multichip.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
