from .common import (  # noqa: F401
    make_integrator,
    mis_weight,
    register_integrator,
    render,
    render_pass,
)
from .path import PathIntegrator  # noqa: F401
