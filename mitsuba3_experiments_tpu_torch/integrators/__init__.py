from .common import (  # noqa: F401
    make_integrator,
    mis_weight,
    register_integrator,
    render,
    render_pass,
)
from .nrc import NRCIntegrator, NRCTrainer  # noqa: F401
from .path import PathIntegrator  # noqa: F401
from .persistent import ray_pixel, ray_positions, render_persistent, splat_deferred  # noqa: F401
from .pipelined import record_full_pipelined, render_pipelined  # noqa: F401
from .replay import (  # noqa: F401
    PathRecord,
    path_lengths,
    record_chunk,
    record_full,
    replay_grads,
    replay_grads_full,
    replay_grads_sorted,
    replay_radiance,
    replay_render_grad,
)
from .simple import SimpleIntegrator  # noqa: F401
from .restir import RestirGI  # noqa: F401
from .bdpt import BDPTIntegrator  # noqa: F401
from .sppm import SPPM  # noqa: F401
from .ptracer import ParticleTracer  # noqa: F401
from .spectral import SpectralIntegrator, render_spectral  # noqa: F401
from .wavefront import render_wavefront  # noqa: F401
