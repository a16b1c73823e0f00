"""The port's scene I/O against the JAX package, on the CPU: OBJ shapes,
bitmap textures and envmaps read from files, the XML loader and the
scene -> dict round trip.

Files are written to `tmp_path` from seeded numpy data.  Scene tables are
byte-equal between the packages (both build with the port's host library;
the CDFs allclose at rtol 1e-6, as in test_torch_scene.py); the native OBJ
loader equals the port's Python reference `_load_obj_py`.
"""
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import native as jax_native
from mitsuba3_experiments_tpu.scene.serialize import scene_to_dict as jax_scene_to_dict
from mitsuba3_experiments_tpu.scene.xml import load_xml_dict as jax_load_xml_dict
from mitsuba3_experiments_tpu.utils import image as jax_image
from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    load_dict,
    mesh as meshlib,
    native,
    scene_to_numpy,
)
from mitsuba3_experiments_tpu_torch.scene.obj import _load_obj_py, load_obj
from mitsuba3_experiments_tpu_torch.scene.serialize import scene_to_dict
from mitsuba3_experiments_tpu_torch.scene.xml import load_xml_dict
from mitsuba3_experiments_tpu_torch.utils import image

torch.set_num_threads(2)

CDF_KEYS = {
    "emitters.face_dist.cdf", "emitters.face_dist.total",
    "emitters.env_dist.row_cdf", "emitters.env_dist.col_cdf",
    "emitters.env_dist.total",
}


@pytest.fixture
def same_builder(monkeypatch):
    """The JAX package's native bridge finds the port's library."""
    monkeypatch.setattr(jax_native, "_find_lib", native.LIBRARY.load)


def _raw(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


def _assert_tables_equal(d):
    ref = scene_to_numpy(jax_load_dict(d)[0])
    got = scene_to_numpy(load_dict(d, device="cpu")[0])
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        g = got[key]
        if not isinstance(r, np.ndarray):
            assert g == r, key
        elif key in CDF_KEYS:
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=key)
        elif key == "emitters.em_face_packed":
            np.testing.assert_allclose(g[:, 11:13], r[:, 11:13], rtol=1e-6, err_msg=key)
            keep = np.r_[0:11, 13:16]
            assert np.array_equal(_raw(g[:, keep]), _raw(r[:, keep])), key
        else:
            assert g.dtype == r.dtype and np.array_equal(_raw(g), _raw(r)), key
    return got


def _write_obj(path, normals: bool, uvs: bool, relative: bool = False):
    """A sphere in v/vt/vn records, plus one quad polygon fanned into two
    triangles; face indices 1-based or, with `relative`, negative."""
    sph = meshlib.sphere(center=(0.1, -0.2, 0.3), radius=0.4, n_theta=10, n_phi=20)
    rng = np.random.default_rng(3)
    lines = [f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in sph.vertices]
    lines += ["v -1 -1 -0.9", "v 1 -1 -0.9", "v 1 1 -0.9", "v -1 1 -0.9"]
    nv = sph.vertices.shape[0] + 4
    if uvs:
        lines += [f"vt {u:.4f} {v:.4f}" for u, v in rng.random((nv, 2))]
    if normals:
        nrm = np.concatenate([sph.normals, np.tile([[0.0, 0.0, 1.0]], (4, 1))])
        lines += [f"vn {x:.5f} {y:.5f} {z:.5f}" for x, y, z in nrm]

    def corner(i):
        ref = i - nv if relative else i + 1
        return f"{ref}/{ref if uvs else ''}/{ref if normals else ''}".rstrip("/")

    for a, b, c in sph.faces:
        lines.append("f " + " ".join(corner(int(i)) for i in (a, b, c)))
    q = nv - 4
    lines.append("f " + " ".join(corner(i) for i in (q, q + 1, q + 2, q + 3)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("normals,uvs,relative", [(True, True, False), (False, False, True)],
                         ids=["vn_vt", "v_only_relative"])
def test_native_obj_loader_matches_python(tmp_path, normals, uvs, relative):
    path = _write_obj(tmp_path / "m.obj", normals, uvs, relative)
    v, n, uv, f = native.load_obj_native(path)
    rv, rn, ruv, rf = _load_obj_py(path)
    assert np.array_equal(v, rv) and np.array_equal(f, rf)
    assert (n is None) == (rn is None) == (not normals)
    assert (uv is None) == (ruv is None) == (not uvs)
    if normals:
        np.testing.assert_allclose(n, rn, rtol=1e-6, atol=1e-7)
    if uvs:
        assert np.array_equal(uv, ruv)
    mesh = load_obj(path)
    assert mesh.faces.shape[0] == f.shape[0] and mesh.normals is not None
    with pytest.raises(FileNotFoundError):
        native.load_obj_native(str(tmp_path / "missing.obj"))


def test_obj_scene_tables_byte_equal_jax(tmp_path, same_builder):
    path = _write_obj(tmp_path / "m.obj", True, True)
    d = cornell_box(res=16, spp=1)
    d["mesh"] = {"type": "obj", "filename": path, "bsdf": {"type": "ref", "id": "white"},
                 "to_world": np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32)}
    d["flat"] = {"type": "obj", "filename": path, "face_normals": True,
                 "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.3, 0.4]}}
    got = _assert_tables_equal(d)
    assert got["geometry.faces"].shape[0] > 2 * 10 * 20


def test_bitmap_and_envmap_files_load_like_jax(tmp_path, same_builder):
    rng = np.random.default_rng(4)
    tex = rng.random((8, 12, 3), dtype=np.float32)
    env = (rng.random((16, 32, 3), dtype=np.float32) * 2.0).astype(np.float32)
    image.write_exr(str(tmp_path / "tex.exr"), tex)
    image.write_exr(str(tmp_path / "env.exr"), env)
    # the port's writer writes the JAX package's bytes, and reads them back
    jax_image.write_exr(str(tmp_path / "tex_jax.exr"), tex)
    assert (tmp_path / "tex.exr").read_bytes() == (tmp_path / "tex_jax.exr").read_bytes()
    assert np.array_equal(image.read_image(str(tmp_path / "tex.exr")), tex)
    image.write_png(str(tmp_path / "tex.png"), tex)
    jax_image.write_png(str(tmp_path / "tex_jax.png"), tex)
    assert (tmp_path / "tex.png").read_bytes() == (tmp_path / "tex_jax.png").read_bytes()

    d = cornell_box(res=16, spp=1)
    d["white"] = {"type": "diffuse",
                  "reflectance": {"type": "bitmap", "filename": str(tmp_path / "tex.exr")}}
    d["env"] = {"type": "envmap", "filename": str(tmp_path / "env.exr"), "scale": 0.5}
    got = _assert_tables_equal(d)
    assert got["textures.data"].size >= tex.size
    assert got["emitters.env_map"].shape == env.shape


def test_port_scene_round_trip():
    """scene_to_dict equals the JAX package's on the same scene, and
    compiles back into the same geometry and a like render (the JAX test
    test_scene_round_trip's checks)."""
    scene, _ = load_dict(cornell_box(res=32, spp=1), device="cpu")
    jscene, _ = jax_load_dict(cornell_box(res=32, spp=1))
    d2 = scene_to_dict(scene)
    jd2 = jax_scene_to_dict(jscene)
    assert d2.keys() == jd2.keys()
    assert repr(d2["mesh_0_-1"]["bsdf"]) == repr(jd2["mesh_0_-1"]["bsdf"])
    for key, entry in d2.items():
        if key.startswith("mesh_"):
            for field in ("vertices", "faces", "uvs"):
                assert np.array_equal(entry[field], np.asarray(jd2[key][field])), (key, field)
    scene2, _ = load_dict(d2, device="cpu")
    assert scene2.n_faces == scene.n_faces
    np.testing.assert_allclose(float(scene2.emitters.face_dist.total),
                               float(scene.emitters.face_dist.total), rtol=1e-5)
    img1 = render(scene, PathIntegrator(max_depth=3), spp=32, seed=3).numpy()
    img2 = render(scene2, PathIntegrator(max_depth=3), spp=32, seed=3).numpy()
    mask = img1.mean(-1) > 0.02
    rel = np.abs(img1 - img2)[mask] / (img1[mask] + 0.1)
    assert rel.mean() < 0.15, rel.mean()


XML = """<scene version="3.0.0">
  <default name="spp" value="4"/>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="$spp"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="8"/>
      <integer name="height" value="8"/>
      <rfilter type="tent"/>
    </film>
  </sensor>
  <bsdf type="twosided" id="mat">
    <bsdf type="diffuse">
      <texture type="bitmap" name="reflectance">
        <string name="filename" value="tex.exr"/>
      </texture>
    </bsdf>
  </bsdf>
  <shape type="obj">
    <string name="filename" value="m.obj"/>
    <transform name="to_world">
      <scale value="0.5"/>
      <rotate y="1" angle="30"/>
      <translate x="0.1" y="0.2" z="0"/>
    </transform>
    <ref id="mat"/>
  </shape>
  <shape type="rectangle">
    <bsdf type="diffuse"/>
  </shape>
  <emitter type="constant">
    <rgb name="radiance" value="0.25 0.5 1.0"/>
  </emitter>
</scene>"""


def test_port_xml_scene_level_emitter(tmp_path, same_builder):
    """The JAX test test_xml_scene_level_emitter's checks, on a scene that
    also reads an OBJ and a bitmap: the port's dict equals the JAX
    package's, and both compile to the same tables."""
    _write_obj(tmp_path / "m.obj", True, True)
    image.write_exr(str(tmp_path / "tex.exr"), np.full((4, 4, 3), 0.5, np.float32))
    p = tmp_path / "s.xml"
    p.write_text(XML)
    d = load_xml_dict(str(p))
    jd = jax_load_xml_dict(str(p))
    assert repr(d) == repr(jd)
    ems = [v for v in d.values() if isinstance(v, dict) and v.get("type") == "constant"]
    assert len(ems) == 1
    got = _assert_tables_equal(d)
    np.testing.assert_allclose(got["emitters.env_radiance"], [0.25, 0.5, 1.0])
    assert got["emitters.env_map"].shape == (1, 1, 3)
    assert float(got["emitters.env_select_p"]) == 0.0   # constant: not sampled by NEE
