"""The loops that a cell's window drives, and the comparison of what they
produced with the reference.

A traffic mix (`traffic/<mix>.json`) names one loop here under "loop" and
sets its parameters; the configuration (`configs/<name>.json`) sets the
scene and the render settings.  Both loops are closed: one user's steps sent
back to back.

  * "inverse": inverse rendering as `scripts/torch_flagship_invert.py`
    runs it (its arithmetic copied here, nothing imported).  Set-up renders
    the target (the true scene, box filter) and starts at the mix's wrong
    point: the emitter radiances times one factor, the base colours times a
    second plus an offset, clipped to [0, 1].  The radiances are optimised
    in log space.  A step records every camera ray at a new seed
    (`record_full_pipelined`), reads the image's loss, replays the
    gradients of the image MSE (`replay_grads`), takes one Adam step in
    plain torch and clips the base colours.
  * "render": one `render_pipelined` frame a step at a new seed.

A mix's "sampler" is "seeded" (the default: the target's and each step's
sampler seeds are drawn from `--seed`) or "driver" (the invert driver's own:
the target at the mix's "target_seed", the run's n-th step at n + 1, so
every `--seed` walks one optimisation and draws only the check's sample).

The system under test is reached only through `Port`, which looks each entry
point up when it is called, so a test can put a broken one in its place.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import sys

import torch

from . import harness

LOG_RADIANCE = "log_radiance"


class Port:
    """The port's entry points and counters, looked up at each use."""

    PKG = "mitsuba3_experiments_tpu_torch"

    def __init__(self):
        self.pkg = importlib.import_module(self.PKG)
        self.integrators = importlib.import_module(self.PKG + ".integrators")
        self.build = importlib.import_module(self.PKG + ".scene.build")
        self.convert = importlib.import_module(self.PKG + ".scene.convert")
        self.params = importlib.import_module(self.PKG + ".scene.params")
        self.film = importlib.import_module(self.PKG + ".render.film")
        self.bvh_cuda = importlib.import_module(self.PKG + ".intersect.bvh_cuda")
        self.bvh_torch = importlib.import_module(self.PKG + ".intersect.bvh_torch")
        self.replay_cuda = importlib.import_module(self.PKG + ".integrators.replay_cuda")
        self.replay = importlib.import_module(self.PKG + ".integrators.replay")

    def build_sources(self):
        """The files whose code turns a scene dict into the port's tables:
        the package's scene/*.py and the host library's C++ sources."""
        here = os.path.join(os.path.dirname(os.path.abspath(self.pkg.__file__)), "scene")
        native = os.path.join(harness.ROOT, "native")
        files = [os.path.join(here, f) for f in os.listdir(here) if f.endswith(".py")]
        if os.path.isdir(native):
            files += [os.path.join(native, f) for f in os.listdir(native)
                      if f.endswith((".cpp", ".h"))]
        return sorted(files)

    def counters(self) -> dict:
        return {"k1": self.bvh_cuda.launches, "plain_traversals": self.bvh_torch.calls,
                "k5_forward": self.replay_cuda.forward_launches,
                "k5_adjoint": self.replay_cuda.adjoint_launches,
                "plain_replays": self.replay.plain_calls}


def scene_generator(bench_dir: str, config: dict):
    """(function, source path) of the configuration's scene generator,
    "<module>.<function>" under scenes/."""
    mod_name, fn = config["scene"]["generator"].rsplit(".", 1)
    path = os.path.join(bench_dir, "scenes", mod_name + ".py")
    spec = importlib.util.spec_from_file_location(f"_bench_scene_{mod_name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return getattr(mod, fn), path


def scene_dict(bench_dir: str, config: dict) -> dict:
    fn, _ = scene_generator(bench_dir, config)
    return fn(**config["scene"]["args"])


def load_scene(port: Port, bench_dir: str, config: dict, device, cache_dir: str):
    """(port Scene, cache hit) of the configuration: read from
    `cache_dir`'s table file when there is one, else generated, compiled
    by the port's load_dict and written there.  The file's name holds a
    hash of the generator's source, its arguments and the port's scene
    build sources, so a changed build builds again."""
    _, src = scene_generator(bench_dir, config)
    h = hashlib.sha256()
    for f in [src] + port.build_sources():
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    h.update(json.dumps(config["scene"], sort_keys=True).encode())
    path = os.path.join(cache_dir, f"scene-{h.hexdigest()[:24]}.npz")
    if os.path.exists(path):
        scene, _ = port.convert.read_scene_npz(path, device)
        return scene, True
    scene, meta = port.build.load_dict(scene_dict(bench_dir, config), device=device)
    port.convert.write_scene_npz(path, scene, meta)
    return scene, False


def _sample(n: int, k: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g)[:min(k, n)]


def _by_log(g: dict, rad) -> dict:
    """Gradients by base colour and radiance as the loop's state takes
    them: by base colour and log radiance (d/d log r = r d/dr)."""
    return {"materials.base_color": g["materials.base_color"],
            LOG_RADIANCE: g["emitters.radiance"] * rad}


class Loop:
    """Common settings of a loop: the configuration's render settings."""

    def __init__(self, port, scene, config, traffic, seed, spans):
        self.port, self.scene, self.config, self.traffic = port, scene, config, traffic
        self.seed, self.spans = seed, spans
        self.w, self.h = config["resolution"]
        self.spp = config["spp"]
        self.depth = config["max_depth"]
        self.rr = config["rr_depth"]
        self.n_rays = self.w * self.h * self.spp
        self.steps_taken = 0

    def step_seed(self, i) -> int:
        """The sampler seed of step `i` ("warm", 0, 1, ..., "trace<j>"):
        drawn from `--seed`, or, where the mix says "sampler": "driver", the
        invert driver's own, n + 1 for the run's n-th step, the same for
        every `--seed`."""
        n, self.steps_taken = self.steps_taken, self.steps_taken + 1
        if self.traffic.get("sampler") == "driver":
            return n + 1
        return harness.sub_seed(self.seed, f"step{i}")

    def release(self):
        """Drops the port's scene and state (before the reference runs)."""
        self.scene = None


class InverseLoop(Loop):
    metric = "fwd_bwd_rays_per_s"

    def __init__(self, *a):
        super().__init__(*a)
        t = self.traffic
        self.chunk = self.config["replay_chunk"]
        self.pad = -(-self.n_rays // self.chunk) * self.chunk
        true = self.port.params.traverse(self.scene)
        s = t["start"]
        rad = true["emitters.radiance"].detach() * s["radiance_scale"]
        col = true["materials.base_color"].detach() * s["base_color_scale"] + s["base_color_offset"]
        self.p = {LOG_RADIANCE: torch.log(torch.clamp(rad, min=1e-6)).requires_grad_(),
                  "materials.base_color": torch.clamp(col, 0.0, 1.0).requires_grad_()}
        self.opt = torch.optim.Adam(list(self.p.values()), lr=t["lr"])
        self.target_seed = (t["target_seed"] if t.get("sampler") == "driver"
                            else harness.sub_seed(self.seed, "target"))
        with self.spans("target"):
            self.target = self.port.integrators.render_pipelined(
                self.scene, seed=self.target_seed, spp=self.spp, max_depth=self.depth,
                rr_depth=self.rr, rfilter="box")

    def update(self, scene, p):
        """The scene with `p`'s base colours and exp of its log radiances."""
        return self.port.params.update(scene, {"emitters.radiance": torch.exp(p[LOG_RADIANCE]),
                                               "materials.base_color": p["materials.base_color"]})

    def step(self, i):
        port, s = self.port, self.step_seed(i)
        p_before = {k: v.detach().clone() for k, v in self.p.items()}
        with torch.no_grad():
            scene_it = self.update(self.scene, self.p)
        with self.spans("record"):
            rec, film = port.integrators.record_full_pipelined(
                scene_it, s, self.n_rays, spp=self.spp, max_depth=self.depth, rr_depth=self.rr,
                pad_to=self.pad, return_film=True, rfilter="box")
            loss = float(((port.film.develop(film) - self.target) ** 2).mean())
        with self.spans("replay"):
            g = port.integrators.replay_grads(
                scene_it, self.p, self.update, self.target, s, rec, self.n_rays,
                chunk=self.chunk, spp=self.spp, max_depth=self.depth, rr_depth=self.rr,
                rfilter="box", mode=self.traffic["replay"], film=film)
        with self.spans("adam"):
            for k, v in self.p.items():
                v.grad = g[k]
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                self.p["materials.base_color"].clamp_(0.0, 1.0)
        return {"seed": s, "params": p_before, "rec": rec, "grads": g, "loss": loss}

    def release(self):
        super().release()
        self.opt = None

    def check(self, ref_mod, ref, out, control: bool = False) -> dict:
        """The numbers `correct` compares for step output `out`: the
        target's sampled pixels, the record's sampled rows and the
        gradients, each against the reference (`control`: the reference in
        bfloat16 put in the program's place)."""
        c = self.traffic["check"]
        cfg = dict(spp=self.spp, max_depth=self.depth, rr_depth=self.rr)
        pix = _sample(self.w * self.h, c["pixels"], harness.sub_seed(self.seed, "pixels"))
        pix = pix.to(ref.scene.device)
        ref_px = ref_mod.render_pixels(ref, self.target_seed, pix, rfilter="box", **cfg)
        low = ref.lower() if control else None
        prog_px = (ref_mod.render_pixels(low, self.target_seed, pix, rfilter="box", **cfg)
                   if control else self.target.reshape(-1, 3)[pix.to(self.target.device)])
        out_n = {"target_off": ref_mod.share_off(prog_px, ref_px)}

        rec = out["rec"]
        # the step's state in the reference's keys
        p = {"materials.base_color": out["params"]["materials.base_color"],
             "emitters.radiance": torch.exp(out["params"][LOG_RADIANCE])}
        rows = _sample(self.n_rays, c["rows"], harness.sub_seed(self.seed, "rows"))
        lens = ref_mod.ref_replay.path_lengths(rec)[:self.n_rays]
        longest = torch.argsort(-lens, stable=True)[:c["longest"]].cpu()
        rows = torch.unique(torch.cat([rows, longest])).to(ref.scene.device)
        ref_p = ref.with_tables(ref_mod.update(ref.scene, p))
        if control:
            p_low = {k: v.to(torch.bfloat16).float() for k, v in p.items()}
            low_p = low.with_tables(ref_mod.update(low.scene, p_low))
            D = rec.prim.shape[1]
            rows_rec = ref_mod.ref_replay.PathRecord.empty(rows.numel(), D, ref.scene.device)
            ref_mod.trace(low_p, out["seed"], rows, rec=rows_rec, **cfg)
        else:
            rows_rec = ref_mod.as_record(rec.prim[rows], rec.u[rows], rec.v[rows], rec.occl[rows])
        off, held = ref_mod.record_off(ref_p, rows_rec, rows, out["seed"], **cfg)
        out_n["record_off"] = off / max(held, 1)

        mode = "sorted" if self.depth >= 16 else "full"
        kw = dict(chunk=self.chunk, mode=mode, **cfg)
        g_ref = _by_log(ref_mod.replay_grads(ref, p, self.target, out["seed"], rec, self.n_rays,
                                             **kw), p["emitters.radiance"])
        if control:
            g_prog = _by_log(ref_mod.replay_grads(low, p_low, self.target, out["seed"], rec,
                                                  self.n_rays, **kw), p_low["emitters.radiance"])
        else:
            g_prog = out["grads"]
        out_n["grad_gap"] = ref_mod.grad_gap(g_prog, g_ref)
        return out_n


class RenderLoop(Loop):
    metric = "fwd_rays_per_s"

    def step(self, i):
        s = self.step_seed(i)
        with self.spans("render"):
            img = self.port.integrators.render_pipelined(
                self.scene, seed=s, spp=self.spp, max_depth=self.depth, rr_depth=self.rr,
                rfilter=self.traffic["rfilter"])
        return {"seed": s, "image": img}

    def check(self, ref_mod, ref, out, control: bool = False) -> dict:
        """The frame's sampled pixels against the reference's."""
        c = self.traffic["check"]
        cfg = dict(spp=self.spp, max_depth=self.depth, rr_depth=self.rr,
                   rfilter=self.traffic["rfilter"])
        pix = _sample(self.w * self.h, c["pixels"], harness.sub_seed(self.seed, "pixels"))
        pix = pix.to(ref.scene.device)
        ref_px = ref_mod.render_pixels(ref, out["seed"], pix, **cfg)
        prog_px = (ref_mod.render_pixels(ref.lower(), out["seed"], pix, **cfg) if control
                   else out["image"].reshape(-1, 3)[pix.to(out["image"].device)])
        return {"image_off": ref_mod.share_off(prog_px, ref_px)}


LOOPS = {"inverse": InverseLoop, "render": RenderLoop}
