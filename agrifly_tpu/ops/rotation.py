"""Quaternion attitude ops ("Euler-Rodrigues symmetric parameters").

Pure jnp functions over `(..., 4)` arrays, w-first, with the convention
    <vector in world frame> = q * <vector in body frame>
matching the reference implementation (Common/Common/Math/Rotation.hpp:27-321):
  - composition `qmul(q2, q1)` = rotation q1 followed by q2 (Hamilton product)
  - `from_rotation_vector` is the exp map with a small-angle guard at
    MIN_ANGLE = 4.84813681e-6 rad (< 1 arc second), Rotation.hpp:39,84-89
  - `from_euler_ypr` is the 3-2-1 yaw/pitch/roll ctor, Rotation.hpp:99-110
  - `to_rotation_vector` uses asin of the vector-part norm, Rotation.hpp:144-153

All functions broadcast over leading axes so they vmap trivially.
"""

from __future__ import annotations

import jax.numpy as jnp

from agrifly_tpu.ops import trig

MIN_ANGLE = 4.84813681e-6  # less than one arc second


def identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def qinv(q):
    """Inverse (conjugate) of a unit quaternion."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qnormalize(q, eps=1e-6):
    """Renormalize; falls back to identity for degenerate (near-zero) input."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    safe = jnp.where(n < eps, jnp.ones_like(n), n)
    out = q / safe
    ident = jnp.broadcast_to(identity(q.dtype), q.shape)
    return jnp.where(n < eps, ident, out)


def qmul(q2, q1):
    """Hamilton product: rotation q1 followed by rotation q2."""
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            x1 * w2 + w1 * x2 + z1 * y2 - y1 * z2,
            y1 * w2 - z1 * x2 + w1 * y2 + x1 * z2,
            z1 * w2 + y1 * x2 - x1 * y2 + w1 * z2,
        ],
        axis=-1,
    )


def from_axis_angle(unit_axis, angle):
    """Axis must be unit length (no check, like the reference)."""
    angle = jnp.asarray(angle)
    half = angle * 0.5
    s = jnp.sin(half)[..., None]
    c = jnp.cos(half)[..., None]
    return jnp.concatenate([c, s * unit_axis], axis=-1)


def from_rotation_vector(rotvec):
    """Exp map with the reference's small-angle guard (returns identity)."""
    theta = jnp.linalg.norm(rotvec, axis=-1, keepdims=True)
    small = theta < MIN_ANGLE
    safe_theta = jnp.where(small, jnp.ones_like(theta), theta)
    axis = rotvec / safe_theta
    q = from_axis_angle(axis, safe_theta[..., 0])
    ident = jnp.broadcast_to(identity(q.dtype), q.shape)
    return jnp.where(small, ident, q)


def from_euler_ypr(y, p, r):
    """3-2-1 yaw, pitch, roll (Rotation.hpp:99-110)."""
    y, p, r = jnp.asarray(y), jnp.asarray(p), jnp.asarray(r)
    cy, sy = jnp.cos(0.5 * y), jnp.sin(0.5 * y)
    cp, sp = jnp.cos(0.5 * p), jnp.sin(0.5 * p)
    cr, sr = jnp.cos(0.5 * r), jnp.sin(0.5 * r)
    return jnp.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        axis=-1,
    )


def to_euler_ypr(q):
    """Returns (yaw, pitch, roll), Rotation.hpp:166-176."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    # ops/trig polynomials, not jnp arc*: the same values on every
    # backend (the golden traces pin them)
    yaw = trig.atan2(2 * x * y + 2 * w * z, x * x + w * w - z * z - y * y)
    pitch = -trig.asin(jnp.clip(2 * x * z - 2 * w * y, -1.0, 1.0))
    roll = trig.atan2(2 * y * z + 2 * w * x, z * z - y * y - x * x + w * w)
    return yaw, pitch, roll


def from_vector_part(v):
    """Unit quaternion from its vector part, w = sqrt(1 - |v|^2) >= 0
    (Rotation.hpp FromVectorPartOfQuaternion — used to rebuild attitude
    from the telemetry wire format, which sends only x, y, z)."""
    v = jnp.asarray(v)
    w2 = 1.0 - (v * v).sum(-1, keepdims=True)
    w = jnp.sqrt(jnp.maximum(w2, 0.0))
    return jnp.concatenate([w, v], axis=-1)


def to_vector_part(q):
    """Vector part with the sign flipped so the scalar part is positive."""
    sign = jnp.where(q[..., 0:1] > 0, 1.0, -1.0).astype(q.dtype)
    return sign * q[..., 1:4]


def to_rotation_vector(q):
    """Log map via asin of the vector-part norm (Rotation.hpp:144-153)."""
    n = to_vector_part(q)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    angle = trig.asin(jnp.clip(norm, 0.0, 1.0)) * 2.0
    small = angle < MIN_ANGLE
    safe_norm = jnp.where(small, jnp.ones_like(norm), norm)
    return jnp.where(small, jnp.zeros_like(n), n * (angle / safe_norm))


def to_matrix(q):
    """3x3 rotation matrix R with R @ v_body = v_world (Rotation.hpp:196-220)."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    r0, r1, r2, r3 = w * w, x * x, y * y, z * z
    row0 = jnp.stack([r0 + r1 - r2 - r3, 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    row1 = jnp.stack([2 * (x * y + w * z), r0 - r1 + r2 - r3, 2 * (y * z - w * x)], axis=-1)
    row2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), r0 - r1 - r2 + r3], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate(q, v):
    """Rotate v from body to world frame: R(q) @ v.

    Fully scalar-expanded (ops/lin3.mv3 rationale): tiny dot_generals may
    run in reduced precision on matrix units."""
    from agrifly_tpu.ops import lin3

    return lin3.mv3(to_matrix(q), v)


def rotate_back(q, v):
    """Rotate v from world to body frame: R(q)^T @ v."""
    from agrifly_tpu.ops import lin3

    return lin3.mv3t(to_matrix(q), v)


def get_angle(q):
    """Total rotation angle, 2*acos(|w|) (Rotation.hpp:138-142)."""
    return 2.0 * trig.acos(jnp.clip(jnp.abs(q[..., 0]), 0.0, 1.0))
