"""The "inverse_dp" loop: the `inverse` mix's gradient step spread over the
ranks of a several-card cell by the port's `parallel.sharded_replay_grad`.

The deployment (`configs/standin-d8-dp4.json`): one rank a card, the
scene's tables replicated on every card, the camera rays split into
contiguous slices of ceil(n / ranks), an all-reduce of the film and of the
gradients a step over the NCCL group the harness started, and Adam's state
replicated.

  * Set-up: the start point of `loops.InverseLoop` (radiance times one
    factor, in log space; base colours times a second plus an offset,
    clipped), `parallel.make_mesh()` over the harness's group, and the
    target: `parallel.render_persistent_sharded` (box filter) of the true
    scene, the same image on every rank.
  * A step, on every rank: `sharded_replay_grad` at the step's seed with
    the scene's keys (`emitters.radiance` = exp of the log radiance,
    `materials.base_color`): each rank records and replays its own slice,
    and every rank gets the whole frame's gradients of the sum of squared
    errors.  The radiance gradient becomes the log radiance's, and every
    rank takes the same Adam step and clips the base colours.  The loss
    read is that sum over the frame's entries, the image's MSE.
  * `gather(out)`, after the window: every rank's record rows (its valid
    rows, placed at their camera rays) come to rank 0 as one whole-frame
    record, padded to a multiple of the replay chunk as the one-card record
    is, so `InverseLoop.check` runs on it against the reference, with the
    reference's gradient in its whole-frame form (`WholeFrame`); and
    `rank_param_gap`, the largest absolute difference over the ranks
    between a rank's parameters after the last step and rank 0's, which
    must read 0: every rank takes identical steps.

The port's `parallel` entry points are looked up at each use, through
`Port.PKG`, so a test can put a broken one in their place.  The mix's keys
beyond `inverse`'s: "n_lanes" (a rank's record batch) and "split" (only
"contiguous", the split `sharded_replay_grad` makes); its replay is
`sharded_replay_grad`'s, so it has no "replay".
"""
import importlib

import torch
import torch.distributed as dist

from benchmark import harness, loops


class WholeFrame:
    """The reference module with its `replay_grads` in the film-adjoint
    form (its "sorted" mode): the adjoint 2 (S / w - target) / w is taken
    once from the whole replayed frame, which makes the gradient the whole
    frame's for any split of the rays, as `sharded_replay_grad`'s is.  The
    "full" form sums each chunk's own squared error instead.  It is the
    same only where no sample lands in a pixel of another chunk, and some
    do: in float32 a pixel corner plus a jitter just under 1 (or the jitter
    itself) rounds up to the next pixel, about 1 sample in 20,000 at
    1280x720, and 1 or 2 of those a frame cross a chunk's edge.  There the
    "full" form counts the stray sample as a pixel of its own."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def replay_grads(self, *args, mode: str, **kw):
        return self.mod.replay_grads(*args, mode="sorted", **kw)


class InverseDpLoop(loops.InverseLoop):
    def __init__(self, *args, ranks):
        # InverseLoop's state, with the target rendered over the ranks
        loops.Loop.__init__(self, *args)
        if ranks.group is None:
            raise ValueError("the inverse_dp loop runs over the ranks of a process group")
        t = self.traffic
        if t["split"] != "contiguous":
            raise ValueError(f"split {t['split']!r}: sharded_replay_grad splits the camera "
                             "rays into contiguous slices")
        self.ranks = ranks
        self.mesh = self.parallel().make_mesh()
        self.chunk = self.config["replay_chunk"]
        self.pad = -(-self.n_rays // self.chunk) * self.chunk
        true = self.port.params.traverse(self.scene)
        s = t["start"]
        rad = true["emitters.radiance"].detach() * s["radiance_scale"]
        col = true["materials.base_color"].detach() * s["base_color_scale"] + s["base_color_offset"]
        self.p = {loops.LOG_RADIANCE: torch.log(torch.clamp(rad, min=1e-6)).requires_grad_(),
                  "materials.base_color": torch.clamp(col, 0.0, 1.0).requires_grad_()}
        self.opt = torch.optim.Adam(list(self.p.values()), lr=t["lr"])
        self.target_seed = (t["target_seed"] if t.get("sampler") == "driver"
                            else harness.sub_seed(self.seed, "target"))
        with self.spans("target"):
            self.target = self.parallel().render_persistent_sharded(
                self.scene, self.mesh, seed=self.target_seed, spp=self.spp,
                max_depth=self.depth, rr_depth=self.rr, rfilter="box", n_lanes=t["n_lanes"])

    def parallel(self):
        """The port's `parallel` package, looked up now."""
        return importlib.import_module(self.port.PKG + ".parallel")

    def step(self, i):
        s = self.step_seed(i)
        p_before = {k: v.detach().clone() for k, v in self.p.items()}
        rad = torch.exp(self.p[loops.LOG_RADIANCE].detach())
        keys = {"emitters.radiance": rad,
                "materials.base_color": self.p["materials.base_color"].detach()}
        with torch.no_grad():
            scene_it = self.port.params.update(self.scene, keys)
        with self.spans("fwd_bwd"):
            sse, g, part = self.parallel().sharded_replay_grad(
                scene_it, keys, self.target, s, self.mesh, n_lanes=self.traffic["n_lanes"],
                spp=self.spp, max_depth=self.depth, rr_depth=self.rr, rfilter="box",
                ray_end=self.n_rays, chunk=self.chunk)
            loss = float(sse) / self.target.numel()
        g = loops._by_log(g, rad)
        with self.spans("adam"):
            for k, v in self.p.items():
                v.grad = g[k]
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                self.p["materials.base_color"].clamp_(0.0, 1.0)
        return {"seed": s, "params": p_before, "part": part, "grads": g, "loss": loss}

    def gather(self, out):
        """On every rank: rank 0's `out` gains the whole-frame record
        ("rec") and "rank_param_gap"; the other ranks send theirs."""
        r, group = self.ranks, self.ranks.group
        mine = torch.cat([v.detach().reshape(-1) for v in self.p.values()])
        lead = mine.clone()
        dist.broadcast(lead, 0, group=group)
        gap = (mine - lead).abs().max()
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=group)
        out["rank_param_gap"] = float(gap)

        part = out.pop("part")
        slices = r.gather((part.start, part.n_valid))
        fields = (part.rec.prim, part.rec.u, part.rec.v, part.rec.occl.to(torch.uint8))
        got = []
        for f in fields:
            bufs = [torch.empty_like(f) for _ in range(r.size)] if r.lead else None
            dist.gather(f, bufs, dst=0, group=group)
            got.append(bufs)
        if r.lead:
            rec = self.port.replay.PathRecord.empty(self.pad, self.depth, r.device)
            for k, (start, n) in enumerate(slices):
                rows = slice(start, start + n)
                rec.prim[rows] = got[0][k][:n]
                rec.u[rows] = got[1][k][:n]
                rec.v[rows] = got[2][k][:n]
                rec.occl[rows] = got[3][k][:n].bool()
            out["rec"] = rec
        return out

    def check(self, ref_mod, ref, out, control: bool = False) -> dict:
        """`InverseLoop.check` against the whole frame's reference
        gradient (`WholeFrame`), and for the program `rank_param_gap` (the
        control, the reference in bfloat16, has no ranks)."""
        got = super().check(WholeFrame(ref_mod), ref, out, control)
        if not control:
            got["rank_param_gap"] = out["rank_param_gap"]
        return got


LOOP = InverseDpLoop
