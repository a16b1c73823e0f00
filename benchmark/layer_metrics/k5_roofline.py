"""k5_roofline: K5's share (%) of its roofline over the traced steps: the
least time the card could take for the work of every replay chunk, each the
larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s (the frozen `work/k5_work.py` count, from the step's record, with
the chunks the port's replay makes), over the device time of
`replay_forward_kernel` and `replay_adjoint_kernel` in those steps.  The
H100's published peaks at 700 W; the run prints the card's power limit.
Moves fwd_bwd_rays_per_s."""
import torch

from benchmark.layer_metrics import _device
from benchmark.reference.frozen.replay import _depth_classes, path_lengths
from benchmark.work.k5_work import k5_work

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def _chunks(rec, n_rays, chunk, sorted_mode):
    """(rows, kw) of each replay chunk, as the port's full and sorted
    replays cut the record."""
    rows, D = rec.prim.shape
    if not sorted_mode:
        for off in range(0, rows, chunk):
            yield slice(off, off + chunk), dict(idx0=off, idx=None, n_steps=None,
                                                 ray_end=min(off + chunk, n_rays))
        return
    lens = path_lengths(rec)
    order = torch.argsort(-lens, stable=True)
    classes = _depth_classes(D)
    for j in range(rows // chunk):
        oj = order[j * chunk:(j + 1) * chunk]
        cls = min(c for c in classes if c >= int(lens[oj[0]]))
        yield oj, dict(idx0=0, idx=oj, n_steps=cls, ray_end=n_rays)


def collect(ctx, out):
    loop = ctx["loop"]
    if "rec" not in out:
        return
    mode = loop.traffic["replay"]
    sorted_mode = mode == "sorted" or (mode == "auto" and loop.depth >= 16)
    bound = 0.0
    for sel, kw in _chunks(out["rec"], loop.n_rays, loop.chunk, sorted_mode):
        kw["max_depth"] = loop.depth
        _, _, ops, nbytes = k5_work(loop.scene, out["rec"].rows(sel), kw)
        bound += max(nbytes / HBM_BYTES_S, ops / F32_OPS_S)
    ctx["collected"]["k5_bound_s"] = ctx["collected"].get("k5_bound_s", 0.0) + bound


def read(ctx):
    tr = _device.traced(ctx, "fwd_bwd_rays_per_s")
    bound = ctx["collected"].get("k5_bound_s")
    if tr is None or not bound:
        return None
    dev_s = tr.kernel_s(_device.is_k5)
    return 100.0 * bound / dev_s if dev_s > 0 else None
