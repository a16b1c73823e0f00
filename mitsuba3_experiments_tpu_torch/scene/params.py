"""Differentiable scene parameters: the mi.traverse analog.

Counterpart of ``mitsuba3_experiments_tpu.scene.params``.  The scene's
tables are frozen dataclasses of tensors, so `traverse` selects the
differentiable tensors into a flat dict and `update` rebuilds the scene
around a (possibly modified, possibly grad-requiring) dict with
``dataclasses.replace``; the scene passed in is not changed.
"""
from __future__ import annotations

import dataclasses

from .types import Scene

# keys exposed for differentiation and scripted updates
PARAM_KEYS = {
    "materials.base_color": lambda s: s.materials.base_color,
    "materials.params": lambda s: s.materials.params,
    "emitters.radiance": lambda s: s.emitters.radiance,
    "camera.to_world": lambda s: s.camera.to_world,
    "textures.data": lambda s: s.textures.data,
}


def traverse(scene: Scene) -> dict:
    """The differentiable parameter dict of a compiled scene."""
    return {k: f(scene) for k, f in PARAM_KEYS.items()}


def update(scene: Scene, params: dict) -> Scene:
    """A scene whose tables take the entries of `params` (keys of
    PARAM_KEYS; absent keys keep the scene's own tensors)."""
    s = scene
    if "materials.base_color" in params or "materials.params" in params:
        s = dataclasses.replace(s, materials=dataclasses.replace(
            s.materials,
            base_color=params.get("materials.base_color", s.materials.base_color),
            params=params.get("materials.params", s.materials.params),
        ))
    if "emitters.radiance" in params:
        s = dataclasses.replace(
            s, emitters=dataclasses.replace(s.emitters, radiance=params["emitters.radiance"]))
    if "camera.to_world" in params:
        s = dataclasses.replace(
            s, camera=dataclasses.replace(s.camera, to_world=params["camera.to_world"]))
    if "textures.data" in params:
        s = dataclasses.replace(
            s, textures=dataclasses.replace(s.textures, data=params["textures.data"]))
    return s
