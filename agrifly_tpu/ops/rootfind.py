"""Branch-free closed-form cubic / quartic real-root solvers.

JAX rewrite of the reference's RootFinder (Common/Common/Math/
RootFinder.hpp:60-177, the Milenkovic/Jalan/Bucki closed-form solvers).
The C++ version returns a variable root count; under XLA we return fixed-size
root arrays plus boolean validity masks so everything vmaps and fuses.
These are *the* inner kernels of RAPPIDS collision checking.

Conventions match the reference:
  solve_cubic(a, b, c)       solves x^3 + a x^2 + b x + c = 0
  solve_quartic(a, b, c, d)  solves x^4 + a x^3 + b x^2 + c x + d = 0
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12
_2PI = 6.283185307179586


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def solve_cubic(a, b, c):
    """Real roots of x^3 + a x^2 + b x + c.

    Returns (roots, valid): roots shape (..., 3), valid shape (..., 3) bool.
    Invalid lanes hold finite garbage (never NaN) so downstream masked math
    stays clean.
    """
    a = jnp.asarray(a, jnp.result_type(a, b, c, 1.0))
    b = jnp.asarray(b, a.dtype)
    c = jnp.asarray(c, a.dtype)

    a2 = a * a
    q = (a2 - 3.0 * b) / 9.0
    r = (a * (2.0 * a2 - 9.0 * b) + 27.0 * c) / 54.0
    r2 = r * r
    q3 = q * q * q
    three_real = r2 < q3

    # --- branch 1: three real roots (trigonometric form) ---
    q3_safe = jnp.where(three_real, q3, 1.0)
    t = jnp.clip(r / _safe_sqrt(q3_safe), -1.0, 1.0)
    t = jnp.arccos(t)
    a3 = a / 3.0
    qq = -2.0 * _safe_sqrt(jnp.maximum(q, 0.0))
    x0_t = qq * jnp.cos(t / 3.0) - a3
    x1_t = qq * jnp.cos((t + _2PI) / 3.0) - a3
    x2_t = qq * jnp.cos((t - _2PI) / 3.0) - a3

    # --- branch 2: one or two real roots (Cardano) ---
    disc = _safe_sqrt(jnp.maximum(r2 - q3, 0.0))
    mag = jnp.abs(r) + disc
    A = -jnp.cbrt(mag)
    A = jnp.where(r < 0, -A, A)
    B = jnp.where(jnp.abs(A) < _EPS, 0.0, q / jnp.where(jnp.abs(A) < _EPS, 1.0, A))
    x0_c = (A + B) - a3
    x1_c = -0.5 * (A + B) - a3
    x2_im = 0.5 * jnp.sqrt(3.0) * (A - B)  # imaginary part of the pair
    double_root = jnp.abs(x2_im) < _EPS  # => x1 is a real (double) root

    roots = jnp.stack(
        [
            jnp.where(three_real, x0_t, x0_c),
            jnp.where(three_real, x1_t, x1_c),
            jnp.where(three_real, x2_t, x1_c),
        ],
        axis=-1,
    )
    valid = jnp.stack(
        [
            jnp.ones_like(three_real),
            three_real | double_root,
            three_real,
        ],
        axis=-1,
    )
    return roots, valid


def solve_quartic(a, b, c, d):
    """Real roots of x^4 + a x^3 + b x^2 + c x + d.

    Returns (roots, valid): roots shape (..., 4), valid shape (..., 4) bool.
    Mirrors RootFinder.hpp:105-177 (resolvent cubic + two quadratics), with
    the same "pick resolvent root of maximal |y|" rule.
    """
    a = jnp.asarray(a, jnp.result_type(a, b, c, d, 1.0))
    b = jnp.asarray(b, a.dtype)
    c = jnp.asarray(c, a.dtype)
    d = jnp.asarray(d, a.dtype)

    # resolvent cubic y^3 - b y^2 + (ac - 4d) y - (a^2 d + c^2 - 4 b d) = 0
    a3 = -b
    b3 = a * c - 4.0 * d
    c3 = -a * a * d - c * c + 4.0 * b * d
    x3, v3 = solve_cubic(a3, b3, c3)

    # choose y = valid root with maximal |y| (the reference scans x3[1], x3[2]
    # only when there are 3 real roots; with a double root x3[1]==x3[2] so
    # including masked lanes at -inf is equivalent)
    absx = jnp.where(v3, jnp.abs(x3), -jnp.inf)
    idx = jnp.argmax(absx, axis=-1)
    y = jnp.take_along_axis(x3, idx[..., None], axis=-1)[..., 0]

    # h^2 - y h + d = 0  (h = q1, q2)
    D1 = y * y - 4.0 * d
    D1_zero = jnp.abs(D1) < _EPS
    sqD1 = _safe_sqrt(D1)
    q1_a = q2_a = y * 0.5
    q1_b = (y + sqD1) * 0.5
    q2_b = (y - sqD1) * 0.5

    # when D1 == 0: g^2 - a g + (b - y) = 0
    D2 = a * a - 4.0 * (b - y)
    D2_zero = jnp.abs(D2) < _EPS
    sqD2 = _safe_sqrt(jnp.maximum(D2, 0.0))
    p1_a = jnp.where(D2_zero, a * 0.5, (a + sqD2) * 0.5)
    p2_a = jnp.where(D2_zero, a * 0.5, (a - sqD2) * 0.5)

    # when D1 != 0: Cramer  p1 = (a q1 - c)/(q1 - q2), p2 = (c - a q2)/(q1 - q2)
    denom = q1_b - q2_b
    denom_safe = jnp.where(jnp.abs(denom) < 1e-300, 1.0, denom)
    p1_b = (a * q1_b - c) / denom_safe
    p2_b = (c - a * q2_b) / denom_safe

    q1 = jnp.where(D1_zero, q1_a, q1_b)
    q2 = jnp.where(D1_zero, q2_a, q2_b)
    p1 = jnp.where(D1_zero, p1_a, p1_b)
    p2 = jnp.where(D1_zero, p2_a, p2_b)

    # x^2 + p1 x + q1 = 0
    Da = p1 * p1 - 4.0 * q1
    va = ~(Da < 0.0)
    sqDa = _safe_sqrt(Da)
    ra0 = (-p1 + sqDa) * 0.5
    ra1 = (-p1 - sqDa) * 0.5

    # x^2 + p2 x + q2 = 0
    Db = p2 * p2 - 4.0 * q2
    vb = ~(Db < 0.0)
    sqDb = _safe_sqrt(Db)
    rb0 = (-p2 + sqDb) * 0.5
    rb1 = (-p2 - sqDb) * 0.5

    roots = jnp.stack([ra0, ra1, rb0, rb1], axis=-1)
    valid = jnp.stack([va, va, vb, vb], axis=-1)
    return roots, valid


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c (a may be ~0 => linear fallback).

    Returns (roots, valid) with shape (..., 2).
    """
    a = jnp.asarray(a, jnp.result_type(a, b, c, 1.0))
    b = jnp.asarray(b, a.dtype)
    c = jnp.asarray(c, a.dtype)
    lin = jnp.abs(a) < 1e-12
    # quadratic branch
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    sq = _safe_sqrt(disc)
    a_safe = jnp.where(lin, 1.0, a)
    r0 = (-b + sq) / (2.0 * a_safe)
    r1 = (-b - sq) / (2.0 * a_safe)
    # linear branch: b x + c = 0
    b_safe = jnp.where(jnp.abs(b) < 1e-12, 1.0, b)
    rl = -c / b_safe
    lin_valid = lin & (jnp.abs(b) >= 1e-12)
    roots = jnp.stack([jnp.where(lin, rl, r0), jnp.where(lin, rl, r1)], axis=-1)
    valid = jnp.stack([jnp.where(lin, lin_valid, has), jnp.where(lin, jnp.zeros_like(lin), has)], axis=-1)
    return roots, valid
