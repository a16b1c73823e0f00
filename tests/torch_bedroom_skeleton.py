"""A synthetic bedroom-class scene XML, written from numpy alone.

The bedroom's scene XML is not part of the repository.  `write_skeleton`
writes one of the same class for the flagship loader (`bedroom_dict`,
`load_flagship`) to read:

  * `<default>` substitution, an integrator of max_depth 65, a perspective
    sensor at the bedroom camera's position (3.456, 1.212, 3.299) with a
    tent film at 1280x720 and an independent sampler;
  * named BSDFs: a twosided diffuse whose reflectance is a bitmap behind an
    LFS pointer (`lfs_bitmap`), a plain diffuse, a rough conductor and a
    plastic;
  * `n_obj` obj shapes whose files are git-LFS pointer stubs, one of them
    holding ~75% of the `size` total (as the carpet OBJ does), the others
    sharing the rest; with `missing`, the last one's file does not exist;
  * two rectangle area emitters under the ceiling.

    python tests/torch_bedroom_skeleton.py DIR [N_OBJ]

Imports numpy only, so chip_smoke.py can use it on the card's machine.
"""
import os
import sys

import numpy as np

CAMERA_ORIGIN = (3.456, 1.212, 3.299)
CAMERA_TARGET = (-0.1, 1.2, -0.1)   # the centre of the furniture box
TOTAL_BYTES = 176_000_000           # the bedroom's LFS total, ~90 bytes a triangle
BIG_SHARE = 0.75

_POINTER = ("version https://git-lfs.github.com/spec/v1\n"
            "oid sha256:{oid:064x}\n"
            "size {size}\n")


def _transform(i: int) -> str:
    """Every fifth shape moved and scaled a little, the rest at identity."""
    if i % 5:
        m = np.eye(4)
    else:
        s = 1.0 + 0.02 * (i % 3)
        m = np.diag([s, s, s, 1.0])
        m[:3, 3] = (0.05 * (i % 7) - 0.15, 0.0, 0.03 * (i % 4))
    vals = " ".join(f"{x:g}" for x in m.reshape(-1))
    return f'<transform name="to_world"><matrix value="{vals}"/></transform>'


def write_skeleton(out_dir: str, n_obj: int = 70, missing: bool = True,
                   lfs_bitmap: bool = True, seed: int = 0) -> str:
    """Writes DIR/scene.xml and its LFS stubs under DIR/models and
    DIR/textures; returns the XML's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "models"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "textures"), exist_ok=True)

    # sizes: the first mesh ~75% of the total, the rest uneven shares of 25%
    rest = rng.uniform(0.2, 1.8, n_obj - 1)
    sizes = [int(TOTAL_BYTES * BIG_SHARE)] + [
        int(x) for x in TOTAL_BYTES * (1 - BIG_SHARE) * rest / rest.sum()]

    def stub(rel, size):
        with open(os.path.join(out_dir, rel), "w") as f:
            f.write(_POINTER.format(oid=int(rng.integers(1 << 62)), size=size))

    tex = '<rgb name="reflectance" value="0.6, 0.55, 0.5"/>'
    if lfs_bitmap:
        stub("textures/wood.jpg", 2_345_678)
        tex = ('<texture type="bitmap" name="reflectance">'
               '<string name="filename" value="textures/wood.jpg"/></texture>')
    bsdfs = ["Fabric", "Wood", "Metal", "Plastic"]
    lines = [
        '<scene version="3.0.0">',
        '  <default name="spp" value="64"/>',
        '  <default name="resx" value="1280"/>',
        '  <default name="resy" value="720"/>',
        '  <integrator type="path"><integer name="max_depth" value="65"/></integrator>',
        '  <sensor type="perspective">',
        '    <string name="fov_axis" value="x"/>',
        '    <float name="fov" value="65"/>',
        '    <transform name="to_world"><lookat origin="{}" target="{}" up="0, 1, 0"/>'
        '</transform>'.format(", ".join(map(str, CAMERA_ORIGIN)),
                              ", ".join(map(str, CAMERA_TARGET))),
        '    <sampler type="independent"><integer name="sample_count" value="$spp"/></sampler>',
        '    <film type="hdrfilm"><integer name="width" value="$resx"/>'
        '<integer name="height" value="$resy"/><rfilter type="tent"/></film>',
        '  </sensor>',
        f'  <bsdf type="twosided" id="Wood"><bsdf type="diffuse">{tex}</bsdf></bsdf>',
        '  <bsdf type="diffuse" id="Fabric"><rgb name="reflectance" value="0.5, 0.4, 0.35"/>'
        '</bsdf>',
        '  <bsdf type="roughconductor" id="Metal"><float name="alpha" value="0.2"/></bsdf>',
        '  <bsdf type="plastic" id="Plastic"><rgb name="diffuse_reflectance" '
        'value="0.2, 0.3, 0.5"/></bsdf>',
    ]
    for i, size in enumerate(sizes):
        rel = f"models/Mesh{i:03d}.obj"
        if not (missing and i == n_obj - 1):
            stub(rel, size)
        lines.append(f'  <shape type="obj" id="Mesh{i:03d}"><string name="filename" '
                     f'value="{rel}"/>{_transform(i)}<ref id="{bsdfs[i % len(bsdfs)]}"/>'
                     '</shape>')
    for k, (x, z) in enumerate(((0.5, 0.8), (-1.4, -1.2))):
        lines.append(
            f'  <shape type="rectangle" id="Light{k}"><transform name="to_world">'
            '<scale x="0.4" y="0.4" z="1"/><rotate x="1" angle="90"/>'
            f'<translate x="{x}" y="2.9" z="{z}"/></transform>'
            '<bsdf type="diffuse"><rgb name="reflectance" value="0, 0, 0"/></bsdf>'
            '<emitter type="area"><rgb name="radiance" value="16, 14, 11"/></emitter></shape>')
    lines.append("</scene>")
    path = os.path.join(out_dir, "scene.xml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


if __name__ == "__main__":
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 70
    print(write_skeleton(sys.argv[1], n_obj=n))
