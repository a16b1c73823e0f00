"""The port's flagship loader against the JAX package's, on a synthetic
bedroom skeleton (tests/torch_bedroom_skeleton.py): LFS-pointer and missing
OBJs, an LFS-pointer bitmap, two area emitters.

JAX's `bedroom_dict` reads its module constant REFERENCE_BEDROOM at call
time; the tests point it at the skeleton with monkeypatch, and give the
port the same path through `xml_path`.  Both dicts compile, each through its
own package's `load_dict` on the CPU, to byte-equal tables (the CDFs within
rtol 1e-6, as tests/test_torch_scene.py holds `standin_dict`)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.scene import bvh8 as jax_bvh8
from mitsuba3_experiments_tpu.scene import flagship as jax_flagship
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import native as jax_native
from mitsuba3_experiments_tpu.scene import obj as jax_obj
from mitsuba3_experiments_tpu_torch.scene import bvh8, flagship, load_dict, native, obj
from mitsuba3_experiments_tpu_torch.scene import scene_to_numpy

import torch_bedroom_skeleton as skeleton
from test_torch_scene import CDF_KEYS, _raw

torch.set_num_threads(2)

RES, SPP, TRIS = (64, 36), 2, 20_000
N_OBJ = 12


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return skeleton.write_skeleton(str(tmp_path_factory.mktemp("bedroom")), n_obj=N_OBJ)


def assert_tables_equal(tables, ref):
    assert tables.keys() == ref.keys()
    for key, r in ref.items():
        got = tables[key]
        if not isinstance(r, np.ndarray):
            assert got == r, key
            continue
        assert got.dtype == r.dtype and got.shape == r.shape, key
        if key in CDF_KEYS:
            np.testing.assert_allclose(got, r, rtol=1e-6, err_msg=key)
        elif key == "emitters.em_face_packed":
            np.testing.assert_allclose(got[:, 11:13], r[:, 11:13], rtol=1e-6, err_msg=key)
            keep = np.r_[0:11, 13:16]
            assert np.array_equal(_raw(got[:, keep]), _raw(r[:, keep])), key
        else:
            assert np.array_equal(_raw(got), _raw(r)), key


def test_bedroom_dict_compiles_to_the_tables_of_jax(xml, monkeypatch):
    monkeypatch.setattr(jax_flagship, "REFERENCE_BEDROOM", xml)
    monkeypatch.setattr(jax_native, "_find_lib", native.LIBRARY.load)
    jd = jax_flagship.bedroom_dict(res=RES, spp=SPP, tri_budget=TRIS)
    d = flagship.bedroom_dict(res=RES, spp=SPP, tri_budget=TRIS, xml_path=xml)
    assert list(d) == list(jd)
    # every obj became a mesh, the bitmap a checkerboard, the shell was added
    assert not any(isinstance(v, dict) and v.get("type") == "obj" for v in d.values())
    assert sum(k.startswith("_shell_") for k in d) == 6
    assert d["Wood"]["bsdf"]["reflectance"]["type"] == "checkerboard"
    for k, v in jd.items():
        if isinstance(v, dict) and v.get("type") == "mesh":
            for f in ("vertices", "faces", "uvs"):
                assert np.array_equal(d[k][f], v[f]), (k, f)
    ref, jmeta = jax_load_dict(jd)
    scene, meta = load_dict(d, device="cpu")
    assert meta == jmeta and meta["spp"] == SPP and meta["rfilter"] == "tent"
    assert meta["integrator"]["max_depth"] == 65
    assert_tables_equal(scene_to_numpy(scene), scene_to_numpy(ref))
    assert int(scene.emitters.radiance.abs().sum(-1).gt(0).sum()) >= 1


def test_lfs_helpers_equal_jax(xml, tmp_path):
    real = tmp_path / "tri.obj"
    real.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    nosize = tmp_path / "nosize.obj"
    nosize.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:00\n")
    models = os.path.join(os.path.dirname(xml), "models")
    pointer = os.path.join(models, "Mesh000.obj")
    missing = os.path.join(models, f"Mesh{N_OBJ - 1:03d}.obj")
    assert not os.path.exists(missing)
    cases = [pointer, str(real), missing, str(nosize)]
    assert [obj.is_lfs_pointer(p) for p in cases] == [True, False, True, True]
    assert [flagship._lfs_size(p) for p in cases] == [
        int(skeleton.TOTAL_BYTES * skeleton.BIG_SHARE), 100_000, 100_000, 100_000]
    for p in cases:
        assert obj.is_lfs_pointer(p) == jax_obj.is_lfs_pointer(p), p
        assert flagship._lfs_size(p) == jax_flagship._lfs_size(p), p


def test_load_flagship_cache(xml, tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    kw = dict(res=RES, spp=SPP, tri_budget=TRIS, cache_dir=str(cache), xml_path=xml,
              device="cpu")
    scene, meta = flagship.load_flagship(**kw)
    files = sorted(os.listdir(cache))
    assert files == [flagship.cache_key(RES, SPP, TRIS, xml) + ".npz"]

    def no_build(*a, **k):
        raise AssertionError("the second call built the scene again")

    monkeypatch.setattr(flagship, "bedroom_dict", no_build)
    again, meta2 = flagship.load_flagship(**kw)
    assert meta2 == meta
    a, b = scene_to_numpy(scene), scene_to_numpy(again)
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and np.array_equal(_raw(v), _raw(b[k])), k
        else:
            assert b[k] == v, k
    assert again.bvh.layout == scene.bvh.layout == bvh8.DEFAULT_LAYOUT

    # another skeleton (one mesh fewer) and other settings give other keys
    other = skeleton.write_skeleton(str(tmp_path / "other"), n_obj=N_OBJ - 1)
    keys = {flagship.cache_key(RES, SPP, TRIS, xml), flagship.cache_key(RES, SPP, TRIS, other),
            flagship.cache_key(RES, SPP + 1, TRIS, xml),
            flagship.cache_key(RES, SPP, 2 * TRIS, xml)}
    assert len(keys) == 4

    # a change to the code that builds the tables gives another key
    srcs = flagship._build_sources()
    edited = tmp_path / "edited.py"
    edited.write_bytes(open(srcs[0], "rb").read() + b"\n# edited\n")
    monkeypatch.setattr(flagship, "_build_sources", lambda: [str(edited)] + srcs[1:])
    assert flagship.cache_key(RES, SPP, TRIS, xml) not in keys
    monkeypatch.setattr(flagship, "_build_sources", lambda: srcs)

    # a truncated cache file raises and names itself
    path = cache / files[0]
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(RuntimeError, match=files[0]):
        flagship.load_flagship(**kw)


def test_load_flagship_without_its_xml_raises(tmp_path):
    absent = str(tmp_path / "no" / "scene.xml")
    with pytest.raises(FileNotFoundError, match=absent):
        flagship.load_flagship(res=RES, spp=SPP, tri_budget=TRIS, cache_dir=str(tmp_path),
                               xml_path=absent, device="cpu")
    assert os.listdir(tmp_path) == []


def test_default_xml_lies_inside_the_repository(tmp_path, monkeypatch):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    default = os.path.abspath(flagship.REFERENCE_BEDROOM)
    assert os.path.commonpath([repo, default]) == repo
    # the default is read at call time
    absent = str(tmp_path / "elsewhere.xml")
    monkeypatch.setattr(flagship, "REFERENCE_BEDROOM", absent)
    with pytest.raises(FileNotFoundError, match=absent):
        flagship.load_flagship(res=RES, spp=SPP, tri_budget=TRIS, cache_dir=None, device="cpu")


def test_bvh8_aliases_equal_jax():
    # the JAX package's aliases read M3T_* variables at import; none is set,
    # so its default layout is its dataclass defaults, as the port's is
    assert not [k for k in os.environ if k.startswith("M3T_")]
    assert jax_bvh8.DEFAULT_LAYOUT == jax_bvh8.BVHLayout()
    assert dataclasses.asdict(bvh8.DEFAULT_LAYOUT) == dataclasses.asdict(jax_bvh8.DEFAULT_LAYOUT)
    for name in ("WIDTH", "LEAF_CAP", "VERT_FLOATS", "FACE_OFF", "LEAF_ROW", "NODE_BASE",
                 "NODE_ROW", "COLLAPSE", "SBVH", "SBVH_ALPHA", "STACK_DEPTH"):
        assert getattr(bvh8, name) == getattr(jax_bvh8, name), name
