"""Host utilities of the port: image I/O, checkpoints and profiling."""
from . import checkpoint, image, profile  # noqa: F401
from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .image import mse, read_image, relative_mse, write_exr, write_png  # noqa: F401
from .profile import (  # noqa: F401
    benchmark,
    device_label,
    kernel_history,
    profile_range,
    trace,
)
