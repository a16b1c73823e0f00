"""Port scene compiler against the JAX package: every table of load_dict
byte-equal (the CDFs allclose at rtol 1e-6) with both packages building
their trees with the port's host library, and the numpy round trip."""
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import native as jax_native
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    load_dict,
    mesh as meshlib,
    native,
    scene_from_numpy,
    scene_to_numpy,
    standin_dict,
)

torch.set_num_threads(2)

# cumulative sums: jnp.cumsum sums in another order than the port's numpy
CDF_KEYS = {
    "emitters.face_dist.cdf", "emitters.face_dist.total",
    "emitters.env_dist.row_cdf", "emitters.env_dist.col_cdf",
    "emitters.env_dist.total",
}


def _cornell_sphere():
    d = cornell_box(res=32, spp=2)
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=24, n_phi=48)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    return d


SCENES = {
    "cornell": lambda: cornell_box(res=32, spp=2),
    "cornell_sphere": _cornell_sphere,
    "standin": lambda: standin_dict(res=(64, 36), tri_budget=20_000),
}


def _raw(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("name", sorted(SCENES))
def test_load_dict_tables_byte_equal(name, monkeypatch):
    # the JAX package's bridge finds the port's build of the same native/*.cpp
    monkeypatch.setattr(jax_native, "_find_lib", native.LIBRARY.load)
    d = SCENES[name]()
    jax_tables = scene_to_numpy(jax_load_dict(d)[0])
    scene, meta = load_dict(d, device="cpu")
    tables = scene_to_numpy(scene)
    assert tables.keys() == jax_tables.keys()
    assert meta["spp"] == int(d["sensor"]["sampler"]["sample_count"])
    for key, ref in jax_tables.items():
        got = tables[key]
        if not isinstance(ref, np.ndarray):
            assert got == ref, key
            continue
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        if key in CDF_KEYS:
            np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=key)
        elif key == "emitters.em_face_packed":
            np.testing.assert_allclose(got[:, 11:13], ref[:, 11:13], rtol=1e-6, err_msg=key)
            keep = np.r_[0:11, 13:16]
            assert np.array_equal(_raw(got[:, keep]), _raw(ref[:, keep])), key
        else:
            assert np.array_equal(_raw(got), _raw(ref)), key
    # every tensor of the port is float32, int32 or bool
    assert all(v.dtype in (np.float32, np.int32, np.bool_)
               for v in tables.values() if isinstance(v, np.ndarray))


def test_standin_covers_every_bsdf_type():
    scene, meta = load_dict(standin_dict(res=(64, 36), tri_budget=20_000), device="cpu")
    assert scene.materials.kinds_present == tuple(range(10))
    assert int((scene.materials.tex_id >= 0).sum()) >= 3
    assert meta["rfilter"] == "tent" and meta["integrator"]["max_depth"] == 8
    assert int(scene.emitters.em_face.shape[0]) == 4   # two rectangles


def test_scene_from_numpy_round_trips_jax_scene():
    jax_scene = jax_load_dict(_cornell_sphere())[0]
    arrays = scene_to_numpy(jax_scene)
    scene = scene_from_numpy(arrays, device="cpu")
    assert scene.device == torch.device("cpu")
    assert scene.bvh.layout.stack == jax_scene.bvh.layout.stack
    assert scene.camera.resolution == jax_scene.camera.resolution
    back = scene_to_numpy(scene)
    assert back.keys() == arrays.keys()
    for key, ref in arrays.items():
        if isinstance(ref, np.ndarray):
            assert back[key].dtype == ref.dtype and np.array_equal(_raw(back[key]), _raw(ref)), key
        else:
            assert back[key] == ref, key


def test_scene_from_numpy_rejects_float64():
    arrays = scene_to_numpy(load_dict(cornell_box(res=8, spp=1), device="cpu")[0])
    arrays["geometry.vertices"] = arrays["geometry.vertices"].astype(np.float64)
    with pytest.raises(TypeError):
        scene_from_numpy(arrays, device="cpu")
