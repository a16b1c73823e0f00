# Frozen copy of mitsuba3_experiments_tpu_torch/scene/types.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Flat scene representation: frozen dataclasses of device tensors.

Counterpart of ``mitsuba3_experiments_tpu.scene.types``: the scene graph is a
handful of structure-of-arrays tables indexed by per-lane integer ids, with
BSDF polymorphism resolved by masked selection over the `kind` column.
Int codes packed into float32 tables stay bit-cast; read them back with
``.contiguous().view(torch.int32)``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.distributions import DiscreteDistribution, DiscreteDistribution2D


class BSDFKind:
    DIFFUSE = 0
    CONDUCTOR = 1
    ROUGH_CONDUCTOR = 2
    DIELECTRIC = 3
    ROUGH_DIELECTRIC = 4
    PLASTIC = 5
    ROUGH_PLASTIC = 6
    MASK = 7
    NULL = 8
    PRINCIPLED = 9

    COUNT = 10


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Indexed triangle soup with per-face material/emitter binding."""

    vertices: torch.Tensor      # (V, 3) f32, world space
    normals: torch.Tensor       # (V, 3) f32 vertex shading normals
    uvs: torch.Tensor           # (V, 2) f32
    faces: torch.Tensor         # (F, 3) i32
    face_mat: torch.Tensor      # (F,) i32 material row
    face_emitter: torch.Tensor  # (F,) i32 emitter row or -1
    face_shape: torch.Tensor    # (F,) i32 source shape index
    face_flat: torch.Tensor     # (F,) bool: shade with the geometric normal
    # (F, 32) f32, one row per face with everything a hit needs:
    # v0[0:3] e1[3:6] e2[6:9] n0[9:12] n1[12:15] n2[15:18] uv0[18:20]
    # uv1[20:22] uv2[22:24] flat[24] mat_id[25] emitter_id[26] (i32 bit-cast)
    # em_pmf[27] em_area[28] pad[29:32]
    face_packed: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """One row per BSDF instance (param layout by kind: see the JAX
    package's MaterialTable)."""

    kind: torch.Tensor        # (M,) i32 BSDFKind
    base_color: torch.Tensor  # (M, 3) f32
    params: torch.Tensor      # (M, 8) f32
    tex_id: torch.Tensor      # (M,) i32 bitmap texture for base_color, -1 none
    flags: torch.Tensor       # (M,) i32 BSDFFlags union of lobes
    twosided: torch.Tensor    # (M,) bool
    nested_id: torch.Tensor   # (M,) i32 (MASK wrapper), -1 none
    # sorted tuple of BSDFKind values that occur (incl. MASK-nested kinds);
    # the dispatch skips absent lobe families.  () = unknown = all.
    kinds_present: tuple = ()


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """Stacked bitmap textures padded to a common resolution."""

    data: torch.Tensor   # (T, Hmax, Wmax, 3) f32
    size: torch.Tensor   # (T, 2) i32 actual (h, w)


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    """Area emitters flattened to the set of emissive faces, plus the
    environment.  NEE picks a face from a power-weighted distribution."""

    radiance: torch.Tensor         # (E, 3) f32 per emitter
    em_face: torch.Tensor          # (EF,) i32 emissive face ids
    em_face_emitter: torch.Tensor  # (EF,) i32 emitter row per emissive face
    em_face_area: torch.Tensor     # (EF,) f32 world-space area
    # (EF, 16) f32: v0[0:3] e1[3:6] e2[6:9] area[9] prob[10] cdf_lo[11]
    # cdf_hi[12] emitter_id[13] (i32 bit-cast) pad[14:16]
    em_face_packed: torch.Tensor
    face_dist: DiscreteDistribution  # over EF slots (weight = area * power)
    face_to_slot: torch.Tensor     # (F,) i32 global face -> EF slot or -1
    env_radiance: torch.Tensor     # (3,) scale
    env_map: torch.Tensor          # (He, We, 3) equirect radiance
    env_dist: DiscreteDistribution2D  # over texels (luminance * sin(theta))
    env_select_p: torch.Tensor     # () probability of NEE picking the env


@dataclasses.dataclass(frozen=True)
class Camera:
    """Perspective pinhole camera, Mitsuba convention: local +Z = view
    direction, +Y = up, +X = left."""

    to_world: torch.Tensor      # (4, 4) f32
    tan_half_fov: torch.Tensor  # (2,) f32: (tan(fov_x/2), tan(fov_y/2))
    resolution: tuple = (256, 256)  # (W, H)


@dataclasses.dataclass(frozen=True)
class BVH:
    """8-wide packed-row BVH (scene/bvh.py + scene/bvh8.py).

      nodes     (NN8, 56) f32: [0:8] child codes (bit-cast i32: >=0 internal
                row, -1 empty, <=-2 leaf row -code-2); [8:56] 8 x (lo|hi)
      leaf_tris (L, 88) f32: [0:72] 8 packed triangles, [80:88] global face
                ids (bit-cast i32, -1 pad)
      leaf_face (L, 8) i32: the same face ids as a plain table
      unified   (NN8+L, 88) f32: node rows zero-padded to 88, then leaf rows;
                one row fetch per traversal step serves both kinds
    """

    nodes: torch.Tensor
    leaf_tris: torch.Tensor
    leaf_face: torch.Tensor
    unified: torch.Tensor
    layout: object = None   # bvh8.BVHLayout; None = bvh8.DEFAULT_LAYOUT


@dataclasses.dataclass(frozen=True)
class Scene:
    geometry: Geometry
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    textures: TextureAtlas
    bvh: BVH

    @property
    def n_faces(self):
        return self.geometry.faces.shape[0]

    @property
    def device(self):
        return self.geometry.vertices.device
