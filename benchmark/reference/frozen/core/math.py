# Frozen copy of mitsuba3_experiments_tpu_torch/core/math.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Vector math, frames and numeric helpers on torch tensors.

Counterpart of ``mitsuba3_experiments_tpu.core.math``.  Vectors are float32
tensors of shape ``(..., 3)``.  Dot and cross products are written out
component by component instead of ``sum``/``torch.cross``: that fixes the
order of the float operations, so the plain torch code, the CUDA kernel
(built without FMA contraction) and the CPU give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

Float = torch.float32

EPS = 1e-6
RAY_EPS = 1e-4          # spawn-ray offset along the normal (shadow-acne guard)
INF = float("inf")
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
INV_TWO_PI = 1.0 / TWO_PI
INV_FOUR_PI = 1.0 / (4.0 * PI)


def vec3(x, y, z):
    """Stack three same-shaped tensors into a (..., 3) vector."""
    return torch.stack([x, y, z], dim=-1)


def vec2(x, y):
    return torch.stack([x, y], dim=-1)


def dot(a, b):
    if a.shape[-1] == 3 and b.shape[-1] == 3:
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return torch.sum(a * b, dim=-1)


def abs_dot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return vec3(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def squared_norm(a):
    return dot(a, a)


def norm(a):
    return torch.sqrt(squared_norm(a))


def rsqrt_safe(x):
    """1/sqrt(x) that returns 0 for x == 0 instead of inf."""
    pos = x > 0
    r = torch.where(pos, x, 1.0)
    return torch.where(pos, 1.0 / torch.sqrt(r), 0.0)


def normalize(a):
    return a * rsqrt_safe(squared_norm(a)).unsqueeze(-1)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b, fill=0.0):
    """a/b with `fill` where b == 0."""
    nz = b != 0
    denom = torch.where(nz, b, 1.0)
    return torch.where(nz, a / denom, fill)


def safe_rcp(x):
    return safe_div(1.0, x)


def to_int32(x):
    """float -> int32 values toward zero (held in int64) as XLA converts:
    saturating at the int32 range, NaN -> 0 (a plain cast of an
    out-of-range float is undefined)."""
    f = torch.clamp(torch.nan_to_num(torch.trunc(x), nan=0.0), -2.0**31, 2.0**31)  # exact in f32
    return torch.clamp(f.to(torch.int64), -(1 << 31), (1 << 31) - 1)


def lerp(a, b, t):
    return a + (b - a) * t


def sign_not_zero(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def luminance(rgb):
    """ITU-R BT.709 luminance."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def max_component(rgb):
    return torch.amax(rgb, dim=-1)


def coordinate_system(n):
    """Orthonormal basis (s, t) around unit normal n (Duff et al. 2017);
    s x t = n."""
    z = n[..., 2]
    sign = sign_not_zero(z)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = vec3(1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0])
    t = vec3(b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return s, t


def to_local(s, t, n, v_world):
    return vec3(dot(v_world, s), dot(v_world, t), dot(v_world, n))


def to_world(s, t, n, v_local):
    return s * v_local[..., 0:1] + t * v_local[..., 1:2] + n * v_local[..., 2:3]


# --- frame-local trig helpers ----------------------------------------------

def cos_theta(v):
    return v[..., 2]


def cos2_theta(v):
    return v[..., 2] * v[..., 2]


def abs_cos_theta(v):
    return torch.abs(v[..., 2])


def sin2_theta(v):
    return torch.clamp(1.0 - cos2_theta(v), min=0.0)


def sin_theta(v):
    return torch.sqrt(sin2_theta(v))


def tan2_theta(v):
    return safe_div(sin2_theta(v), cos2_theta(v), fill=INF)


def tan_theta(v):
    return safe_div(sin_theta(v), cos_theta(v), fill=INF)


def phi(v):
    return torch.atan2(v[..., 1], v[..., 0])


def reflect(wi):
    """Specular reflection about the local +z normal: (-x, -y, z)."""
    return vec3(-wi[..., 0], -wi[..., 1], wi[..., 2])


def reflect_about(wi, m):
    """Reflection of wi about the unit vector m (half-vector)."""
    return 2.0 * dot(wi, m).unsqueeze(-1) * m - wi


def refract(wi, cos_theta_t, eta_ti):
    """Refraction through the local +z interface (mi.refract)."""
    return vec3(-eta_ti * wi[..., 0], -eta_ti * wi[..., 1], cos_theta_t)


# --- 4x4 homogeneous transforms --------------------------------------------

def transform_point(m, p):
    """Apply a (4, 4) matrix to points (..., 3)."""
    return transform_vector(m, p) + m[:3, 3]


def transform_vector(m, v):
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return m[:3, 0] * x + m[:3, 1] * y + m[:3, 2] * z


def transform_normal(m, n):
    """Normals transform by the inverse-transpose of the upper 3x3."""
    inv = torch.linalg.inv(m[..., :3, :3])
    return torch.einsum("...ji,...j->...i", inv, n)


# Host-side (numpy) matrix builders for scene dicts; identical to the JAX
# package's, so both compilers see the same float32 matrices.

def look_at(origin, target, up):
    """Camera-to-world matrix with Mitsuba's convention (+Z = view
    direction, +Y = up, +X = left)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    dirv = target - origin
    dirv = dirv / np.linalg.norm(dirv)
    left = np.cross(up / np.linalg.norm(up), dirv)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dirv, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dirv
    m[:3, 3] = origin
    return m.astype(np.float32)


def translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale_mat(v):
    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg):
    """Rotation matrix about `axis` by `angle_deg` degrees."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    m = np.eye(4)
    m[:3, :3] = R
    return m.astype(np.float32)


def matmul4(*ms):
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ m
    return out


def erfinv(x):
    """Inverse error function (``torch.erfinv``).  Within 0.55 ulp of the
    float64 value over [-0.999999, 0.999999]; the JAX package's float32
    ``jax.scipy.special.erfinv`` is off by up to 64 ulp near +-0.9998."""
    return torch.erfinv(x)
