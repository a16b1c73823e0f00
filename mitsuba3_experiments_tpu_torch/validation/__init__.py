"""Independent numpy reference renderer (imports no torch)."""
from .oracle import block_means, render_oracle, scene_to_numpy

__all__ = ["render_oracle", "scene_to_numpy", "block_means"]
