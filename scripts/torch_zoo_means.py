#!/usr/bin/env python3
"""Image means of the port's integrator zoo against render_persistent's, on
the CPU or the card.

    python3 scripts/torch_zoo_means.py slab [--device cpu]
    python3 scripts/torch_zoo_means.py standin [--device cpu] [--res 64 36] [--fov F]
        [--tri 20000] [--ref-spp 256] [--spp 4] [--seed 1] [--which simple,bdpt,...]

`slab`: the Cornell box at 32x32, depth 6, no Russian roulette, without a
slab, with a null slab and with a mask slab (opacity 0.6) under the light:
render_persistent (NEE + MIS) at spp 256 against SimpleIntegrator (BSDF
sampling only) at spp 1024.  The ratio shows the energy the NEE path loses
behind surfaces its shadow rays take for opaque.

`standin`: the stand-in (tri_budget triangles, res, optional horizontal fov)
rendered by render_persistent at ref-spp, depth 8, then each integrator
named in `which` with chip_smoke.py's phase-15 settings at `spp` (BDPT,
SPPM and ReSTIR: spp 1 or their two frames): the ratio of its mean to the
reference's, per channel, and over the pixels brighter than 0.05.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def slab(device):
    from mitsuba3_experiments_tpu_torch.core import math as cm
    from mitsuba3_experiments_tpu_torch.integrators import (
        SimpleIntegrator, render, render_persistent)
    from mitsuba3_experiments_tpu_torch.scene import cornell_box, load_dict

    gray = {"type": "diffuse", "reflectance": [0.5, 0.5, 0.5]}
    for kind, bsdf in (("none", None), ("null", {"type": "null"}),
                       ("mask", {"type": "mask", "opacity": 0.6, "bsdf": gray})):
        d = cornell_box(res=32, spp=1)
        if bsdf is not None:
            d["slab"] = {"type": "rectangle", "bsdf": bsdf, "to_world": cm.matmul4(
                cm.translate([0, 0.5, 0]), cm.rotate([1, 0, 0], 90), cm.scale_mat([0.6, 0.6, 1]))}
        scene, _ = load_dict(d, device=device)
        p = float(render_persistent(scene, spp=256, max_depth=6, rr_depth=99).mean())
        s = float(render(scene, SimpleIntegrator(max_depth=6, rr_depth=99), spp=1024,
                         seed=3).mean())
        print(f"[slab {kind}] path {p:.6f}, simple {s:.6f}, simple / path {s / p:.4f}", flush=True)


def standin(device, res, fov, tri, ref_spp, spp, seed, which):
    from mitsuba3_experiments_tpu_torch.integrators import (
        BDPTIntegrator, ParticleTracer, RestirGI, SimpleIntegrator, SpectralIntegrator, SPPM,
        render, render_persistent, render_spectral)
    from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict

    d = standin_dict(res=res, spp=4, tri_budget=tri)
    if fov is not None:
        d["sensor"]["fov"] = fov
    scene, _ = load_dict(d, device=device)
    ref = render_persistent(scene, seed=21, spp=ref_spp, max_depth=8, rr_depth=4).cpu().numpy()
    lit = ref.mean(-1) > 0.05
    print(f"[ref] render_persistent spp {ref_spp}: mean {ref.mean():.6f}", flush=True)

    def frames(integ, step):
        st, acc = integ.init_state(scene), 0.0
        for i in range(2):
            img, st = step(integ, st, seed + i)
            acc = acc + img
        return img if isinstance(integ, SPPM) else acc / 2

    runs = {
        "simple": lambda: render(scene, SimpleIntegrator(max_depth=8), spp=spp, seed=seed),
        "ptracer": lambda: ParticleTracer().render(scene, spp=spp, seed=seed),
        "spectral": lambda: render_spectral(scene, SpectralIntegrator(max_depth=8), spp=spp,
                                            seed=seed),
        "bdpt": lambda: render(scene, BDPTIntegrator(max_depth=8), spp=1, seed=seed),
        "sppm": lambda: frames(SPPM(), lambda i, st, k: i.render_frame(scene, st, k)),
        "restirgi": lambda: frames(RestirGI(),
                                   lambda i, st, k: i.render_frame_chunked(scene, st, k)),
    }
    for name in which:
        img = runs[name]().cpu().numpy()
        chan = img.reshape(-1, 3).mean(0) / ref.reshape(-1, 3).mean(0)
        print(f"[{name}] mean / reference {img.mean() / ref.mean():.4f}, channels "
              + " / ".join(f"{c:.4f}" for c in chan)
              + f", lit pixels {img[lit].mean() / ref[lit].mean():.4f}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("slab", "standin"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--res", type=int, nargs=2, default=(64, 36))
    ap.add_argument("--fov", type=float, default=None)
    ap.add_argument("--tri", type=int, default=20_000)
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--which", default="simple,ptracer,spectral,bdpt,sppm,restirgi")
    a = ap.parse_args()
    device = torch.device(a.device or "cuda")
    if a.mode == "slab":
        slab(device)
    else:
        standin(device, tuple(a.res), a.fov, a.tri, a.ref_spp, a.spp, a.seed, a.which.split(","))


if __name__ == "__main__":
    main()
