"""Host utilities of the port (numpy only)."""
from .image import read_image, write_exr, write_png  # noqa: F401
