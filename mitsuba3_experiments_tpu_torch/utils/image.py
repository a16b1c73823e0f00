"""Host-side image I/O (counterpart of
``mitsuba3_experiments_tpu.utils.image``, numpy only): a minimal EXR writer
and reader (uncompressed fp32 scanlines), an 8-bit PNG writer (zlib), and
PNG/JPG reading through PIL where it is installed; the images' MSE and
relative MSE.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


# --------------------------- EXR (fp32, no compression) ---------------------

def write_exr(path: str, img: np.ndarray):
    """img: (H, W, 3) float32 -> minimal scanline EXR (NO_COMPRESSION)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    channels = b""
    for name in (b"B", b"G", b"R"):
        channels += name + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    channels += b"\x00"

    def attr(name, typ, data):
        return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data

    header = b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
    header += attr(b"channels", b"chlist", channels)
    header += attr(b"compression", b"compression", b"\x00")
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += attr(b"dataWindow", b"box2i", box)
    header += attr(b"displayWindow", b"box2i", box)
    header += attr(b"lineOrder", b"lineOrder", b"\x00")
    header += attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    offset_table_pos = len(header) + 8 * h
    offsets = []
    scanline_size = 8 + w * 4 * 3
    for y in range(h):
        offsets.append(offset_table_pos + y * scanline_size)
    body = b"".join(struct.pack("<Q", o) for o in offsets)
    lines = []
    for y in range(h):
        data = (
            img[y, :, 2].tobytes() + img[y, :, 1].tobytes() + img[y, :, 0].tobytes()
        )
        lines.append(struct.pack("<ii", y, len(data)) + data)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header + body + b"".join(lines))


# ------------------------------- PNG (8-bit) --------------------------------

def write_png(path: str, img: np.ndarray, gamma: float = 2.2):
    """img: (H, W, 3) float -> sRGB-ish 8-bit PNG."""
    img = np.asarray(img, np.float32)
    u8 = np.clip(np.power(np.clip(img, 0, 1), 1.0 / gamma) * 255 + 0.5, 0, 255)
    u8 = u8.astype(np.uint8)
    h, w, _ = u8.shape
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def read_image(path: str) -> np.ndarray:
    """Read PNG/JPG/EXR -> (H, W, 3) float32 (linear).  Gated: uses PIL if
    available, else raises for formats we can't decode natively."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    try:
        from PIL import Image  # optional

        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        return np.power(img, 2.2)
    except ImportError as e:
        raise RuntimeError(
            f"cannot decode {path}: PIL unavailable in this environment"
        ) from e


def read_exr(path: str) -> np.ndarray:
    """Minimal EXR reader for files written by write_exr (and other
    uncompressed fp32/half scanline RGB files)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError(f"{path} is not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp != 0:
        raise ValueError(f"{path}: only uncompressed EXR is read (compression {comp})")
    # parse channel list
    chl = attrs["channels"][1]
    cpos = 0
    chans = []
    while chl[cpos] != 0:
        e = chl.index(b"\x00", cpos)
        cname = chl[cpos:e].decode()
        (ptype,) = struct.unpack_from("<i", chl, e + 1)
        chans.append((cname, ptype))
        cpos = e + 1 + 16
    chans_sorted = chans  # EXR stores alphabetically
    pos += 8 * h  # skip offset table
    out = {c: np.zeros((h, w), np.float32) for c, _ in chans}
    for _ in range(h):
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        line = data[pos : pos + size]
        pos += size
        off = 0
        for cname, ptype in chans_sorted:
            if ptype == 2:  # float
                arr = np.frombuffer(line, np.float32, w, off)
                off += 4 * w
            else:  # half
                arr = np.frombuffer(line, np.float16, w, off).astype(np.float32)
                off += 2 * w
            out[cname][y - y0] = arr
    r = out.get("R", next(iter(out.values())))
    g = out.get("G", r)
    b = out.get("B", r)
    return np.stack([r, g, b], axis=-1)


# ------------------------------- error metrics ------------------------------

def mse(a, b) -> float:
    """Mean squared error of two images (array-likes on the host), in
    float32."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.mean((a - b) ** 2))


def relative_mse(a, ref) -> float:
    """Mean of (a - ref)^2 / (ref^2 + 0.01), in float32."""
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.mean((a - ref) ** 2 / (ref * ref + 1e-2)))
