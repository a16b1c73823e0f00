from .common import mis_weight, render, render_pass  # noqa: F401
from .path import PathIntegrator  # noqa: F401
