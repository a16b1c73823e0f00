"""Mitsuba 3 scene-XML loader -> scene dict (then compiled by build.load_dict).

Counterpart of ``mitsuba3_experiments_tpu.scene.xml``, host numpy: the
subset of mi.load_file that the reference scenes use — <default>
substitution, integrator/sensor/film/sampler, named <bsdf> with <ref>,
nested twosided/mask, bitmap textures, obj/rectangle/cube/sphere shapes
with <transform>s, area emitters and scene-level constant/envmap emitters.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from ..core import math as cm


def _subst(value: str, defaults: dict) -> str:
    for k, v in defaults.items():
        value = value.replace(f"${k}", v)
    return value


def _parse_transform(elem) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    for child in elem:
        if child.tag == "matrix":
            vals = [float(x) for x in child.get("value").split()]
            m = (np.asarray(vals, np.float32).reshape(4, 4)) @ m
        elif child.tag == "translate":
            m = cm.translate(_vec3_attr(child)) @ m
        elif child.tag == "scale":
            if child.get("value") is not None:
                m = cm.scale_mat(float(child.get("value"))) @ m
            else:
                m = cm.scale_mat(_vec3_attr(child, default=1.0)) @ m
        elif child.tag == "rotate":
            axis = _vec3_attr(child, default=0.0)
            m = cm.rotate(axis, float(child.get("angle", 0))) @ m
        elif child.tag == "lookat":
            origin = [float(x) for x in re.split(r"[ ,]+", child.get("origin"))]
            target = [float(x) for x in re.split(r"[ ,]+", child.get("target"))]
            up = [float(x) for x in re.split(r"[ ,]+", child.get("up", "0,1,0"))]
            m = cm.look_at(origin, target, up) @ m
    return m


def _vec3_attr(child, default=0.0):
    if child.get("value") is not None:
        v = [float(x) for x in re.split(r"[ ,]+", child.get("value").strip())]
        if len(v) == 1:
            v = v * 3
        return v
    return [
        float(child.get("x", default)),
        float(child.get("y", default)),
        float(child.get("z", default)),
    ]


def _props(elem, defaults):
    """Collect typed child properties into a flat dict."""
    out = {}
    for c in elem:
        name = c.get("name")
        if c.tag in ("integer", "float"):
            val = _subst(c.get("value"), defaults)
            out[name] = float(val) if c.tag == "float" else int(float(val))
        elif c.tag == "string":
            out[name] = _subst(c.get("value"), defaults)
        elif c.tag == "boolean":
            out[name] = c.get("value").lower() == "true"
        elif c.tag == "rgb":
            v = [float(x) for x in re.split(r"[ ,]+", c.get("value").strip())]
            out[name] = v if len(v) == 3 else v * 3
        elif c.tag == "transform":
            out[name] = _parse_transform(c)
    return out


def _parse_bsdf(elem, defaults, base_dir):
    t = elem.get("type")
    d = {"type": t}
    d.update(_props(elem, defaults))
    for c in elem:
        if c.tag == "bsdf":
            d["bsdf"] = _parse_bsdf(c, defaults, base_dir)
        elif c.tag == "ref":
            d["bsdf"] = {"type": "ref", "id": c.get("id")}
        elif c.tag == "texture":
            name = c.get("name", "reflectance")
            tp = _props(c, defaults)
            tex = {"type": c.get("type", "bitmap")}
            tex.update(tp)
            if "filename" in tex:
                tex["filename"] = os.path.join(base_dir, tex["filename"])
            d[name] = tex
    return d


def load_xml_dict(path: str) -> dict:
    """Parse scene XML into a build.load_dict-compatible dict."""
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    defaults: dict[str, str] = {}
    for c in root.findall("default"):
        defaults[c.get("name")] = c.get("value")

    out: dict = {"type": "scene"}
    shape_count = 0
    for elem in root:
        tag = elem.tag
        if tag == "integrator":
            t = _subst(elem.get("type"), defaults)
            d = {"type": t}
            d.update(_props(elem, defaults))
            out["integrator"] = d
        elif tag == "sensor":
            d = {"type": elem.get("type")}
            d.update(_props(elem, defaults))
            for c in elem:
                if c.tag == "film":
                    film = _props(c, defaults)
                    for rf in c.findall("rfilter"):
                        film["rfilter"] = rf.get("type")
                    d["film"] = film
                elif c.tag == "sampler":
                    d["sampler"] = _props(c, defaults)
            out["sensor"] = d
        elif tag == "bsdf":
            bid = elem.get("id") or f"_bsdf_{len(out)}"
            out[bid] = _parse_bsdf(elem, defaults, base_dir)
        elif tag == "shape":
            sid = elem.get("id") or f"_shape_{shape_count}"
            shape_count += 1
            d = {"type": elem.get("type")}
            d.update(_props(elem, defaults))
            if "filename" in d:
                d["filename"] = os.path.join(base_dir, d["filename"])
            for c in elem:
                if c.tag == "ref":
                    d["bsdf"] = {"type": "ref", "id": c.get("id")}
                elif c.tag == "bsdf":
                    d["bsdf"] = _parse_bsdf(c, defaults, base_dir)
                elif c.tag == "emitter":
                    em = {"type": c.get("type")}
                    em.update(_props(c, defaults))
                    d["emitter"] = em
            out[sid] = d
        elif tag == "emitter":
            # scene-level emitter: constant / envmap
            em = {"type": elem.get("type")}
            em.update(_props(elem, defaults))
            if "filename" in em:
                em["filename"] = os.path.join(base_dir, em["filename"])
            out[elem.get("id") or "_env"] = em
    return out
