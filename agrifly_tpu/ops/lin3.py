"""Closed-form small-matrix linear algebra.

jnp.linalg.det/inv on 3x3 matrices lower to LU factorizations with
data-dependent pivoting; under vmap over thousands of envs that path is
much slower than the cofactor closed form (pure elementwise math, fuses
into the surrounding kernel). The estimators' 3x3 innovation
covariances use these instead (Offboard/GPSIMUStateEstimator.cpp:230-244
uses Eigen's closed-form .inverse() for fixed 3x3 too).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mv3(m, v):
    """3x3 (or Nx3) matvec m @ v, fully scalar-expanded.

    Tiny dot_generals may run in reduced precision on matrix units (TF32
    on a GPU), and their summation order is the library's. Static scalar
    extracts + left-associated sums + a stack stay full f32 and are
    bit-identical to the reduce form (3-element sums share the
    association order), which the golden traces pin."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [m[..., i, 0] * v0 + m[..., i, 1] * v1 + m[..., i, 2] * v2
         for i in range(m.shape[-2])], axis=-1)


def mv3t(m, v):
    """Transposed matvec m.T @ v (same fully-scalar form as mv3)."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [m[..., 0, i] * v0 + m[..., 1, i] * v1 + m[..., 2, i] * v2
         for i in range(m.shape[-1])], axis=-1)


# constant one-hot rows for assembling (..., 3) outputs column-by-column
# (a value-identical spelling the golden traces pin)
_E0 = jnp.array([1.0, 0.0, 0.0], jnp.float32)
_E1 = jnp.array([0.0, 1.0, 0.0], jnp.float32)
_E2 = jnp.array([0.0, 0.0, 1.0], jnp.float32)


def assemble_cols3(c0, c1, c2):
    """Build (..., 3) from three (...,) columns via masked-sum placement
    (exact: each slot sums one live term and two 0.0s)."""
    return (c0[..., None] * _E0 + c1[..., None] * _E1 + c2[..., None] * _E2)


def cross_rows(a, b):
    """Row-wise cross product of (..., 3) x (..., 3), assembled with
    assemble_cols3 (the spelling the golden traces pin)."""
    c0 = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    c1 = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    c2 = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return assemble_cols3(c0, c1, c2)


def det3(m):
    """Determinant of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(m, det=None):
    """Cofactor inverse of (..., 3, 3). Caller guarantees invertibility
    (the estimators pre-substitute identity for singular S)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    if det is None:
        det = det3(m)
    inv_det = 1.0 / det
    cof = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return cof * inv_det[..., None, None]


def diag_from(d):
    """diag(d) as an iota-compare mask times the broadcast vector
    (value-identical to jnp.diag)."""
    n = d.shape[-1]
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return jnp.where(rows == cols, d[..., None, :], 0.0)
