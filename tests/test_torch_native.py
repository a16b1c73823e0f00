"""The port's host library (scene/native.py) and its BVH builds, on the CPU.

* Both BVH builds byte-equal the JAX package's `build_bvh` when it runs over
  the same compiled library (its `_find_lib` is pointed at the port's; no
  file of the JAX package changes), spatial splits and object splits.
* The native object-split tree against the port's numpy reference
  `_build_bvh_numpy`: the same node count and leaf-size distribution (as
  tests/test_scene_intersect.py checks for the JAX package).
* Hits on the port's own spatial-split trees, whose leaves repeat faces,
  equal brute force over every triangle: prim_idx equal, t within 1e-5.
* The library is built into build/host/ and a failed build raises.
"""
import os

import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.scene import bvh as jax_bvh
from mitsuba3_experiments_tpu.scene import native as jax_native
from mitsuba3_experiments_tpu_torch.core.records import Ray
from mitsuba3_experiments_tpu_torch.intersect import ray_intersect, ray_test
from mitsuba3_experiments_tpu_torch.intersect.bvh_torch import ray_intersect_brute
from mitsuba3_experiments_tpu_torch.scene import (
    build_bvh,
    cornell_box,
    load_dict,
    mesh as meshlib,
    native,
    standin_dict,
)
from mitsuba3_experiments_tpu_torch.scene.bvh import _build_bvh_numpy
from mitsuba3_experiments_tpu_torch.scene.bvh8 import BVHLayout
from mitsuba3_experiments_tpu_torch.scene.flagship import _BLOB_HI, _BLOB_LO

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cornell_sphere():
    d = cornell_box(res=32, spp=2)
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=24, n_phi=48)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    return d


# scene, ray origins' box, targets' box
SCENES = {
    "cornell_sphere": (_cornell_sphere, (-0.9, 0.9), (-0.8, 0.8)),
    "standin": (lambda: standin_dict(res=(64, 36), tri_budget=20_000), (-3.5, 4.5),
                (_BLOB_LO, _BLOB_HI)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def port_scene(request):
    make, o_box, t_box = SCENES[request.param]
    return request.param, load_dict(make(), device="cpu")[0], o_box, t_box


def _raw(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("sbvh", [True, False], ids=["sbvh", "object_split"])
def test_bvh_tables_byte_equal_jax_over_the_same_library(port_scene, sbvh, monkeypatch):
    name, scene, _, _ = port_scene
    monkeypatch.setattr(jax_native, "_find_lib", native.LIBRARY.load)
    v, f = scene.geometry.vertices.numpy(), scene.geometry.faces.numpy()
    lay = BVHLayout(sbvh=sbvh)
    got = build_bvh(v, f, layout=lay, device="cpu")
    ref = jax_bvh.build_bvh(v, f, layout=lay)
    for key in ("nodes", "leaf_tris", "leaf_face", "unified"):
        a, b = getattr(got, key).numpy(), np.asarray(getattr(ref, key))
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(_raw(a), _raw(b)), key
    refs = got.leaf_face.numpy()
    refs = refs[refs >= 0]
    assert np.array_equal(np.unique(refs), np.arange(scene.n_faces))
    if not sbvh:
        assert refs.size == scene.n_faces
    elif name == "standin":
        # spatial splits duplicate the triangles that straddle them
        assert refs.size > scene.n_faces


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_native_object_split_matches_numpy_builder(leaf_size):
    sph = meshlib.sphere(radius=1.0, n_theta=24, n_phi=48)
    lo, hi, left, right, first, count, order, max_leaf = native.build_bvh_native(
        sph.vertices, sph.faces, leaf_size)
    r_lo, r_hi, r_left, r_right, r_first, r_count, r_order = _build_bvh_numpy(
        sph.vertices, sph.faces, leaf_size)
    assert left.shape[0] == r_left.shape[0]
    assert max_leaf <= leaf_size
    assert sorted(count[left == -1].tolist()) == sorted(r_count[r_left == -1].tolist())
    assert np.array_equal(np.sort(order), np.arange(sph.faces.shape[0]))


def test_sbvh_hits_equal_brute_force(port_scene):
    name, scene, o_box, t_box = port_scene
    assert scene.bvh.layout.sbvh
    rng = np.random.default_rng(5)
    n = 512
    o = rng.uniform(*o_box, (n, 3)).astype(np.float32)
    tgt = rng.uniform(*t_box, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = Ray.make(torch.as_tensor(o), torch.as_tensor(d))
    si = ray_intersect(scene, ray)
    ref = ray_intersect_brute(scene, ray)
    hit = ref.prim_idx >= 0
    assert float(hit.float().mean()) > 0.5, name
    assert torch.equal(si.prim_idx, ref.prim_idx), name
    np.testing.assert_allclose(si.t[hit].numpy(), ref.t[hit].numpy(), rtol=1e-5, atol=1e-5)
    # any hit over segments that end halfway to the closest hit or beyond it
    scale = torch.as_tensor(rng.choice([0.5, 2.0], n), dtype=torch.float32)
    maxt = torch.where(hit, ref.t * scale, 10.0)
    seg = Ray.make(ray.o, ray.d, maxt)
    occl = ray_test(scene, seg)
    assert torch.equal(occl, ray_intersect_brute(scene, seg).prim_idx >= 0), name


def test_library_builds_into_build_host():
    so = native.LIBRARY.build()
    assert os.path.dirname(so) == os.path.join(REPO, "build", "host")
    assert os.path.exists(so) and native.LIBRARY.build() == so


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-fno-such-flag-m3t",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.HostLibrary().build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.HostLibrary().build()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())
