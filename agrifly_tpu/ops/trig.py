"""Inverse trigonometry as elementwise polynomials.

The classic Cephes single-precision range reductions + minimax polynomials
(standard public-domain numerical recipes, peak error ~1 ulp f32), built
only from mul/add, sqrt and where, so every backend computes the same
values. Used on the whole tick path (ops/rotation.py,
models/controllers.py, models/ekf.py, planner/traj.py omega); the golden
traces pin its values. Accuracy pinned against numpy in
tests/test_ops_trig.py.
"""

from __future__ import annotations

import jax.numpy as jnp

_PI = 3.14159265358979323846
_PIO2 = 1.5707963267948966
_PIO4 = 0.7853981633974483
_TAN3PIO8 = 2.414213562373095  # tan(3*pi/8)
_TAN_PIO8 = 0.4142135623730950  # tan(pi/8)


def atan(x):
    """Elementwise arctangent (Cephes atanf reduction + degree-9 minimax)."""
    x = jnp.asarray(x)
    sign = jnp.sign(x)
    a = jnp.abs(x)

    big = a > _TAN3PIO8
    mid = (a > _TAN_PIO8) & ~big
    safe_a = jnp.where(a == 0.0, 1.0, a)
    xr = jnp.where(big, -1.0 / safe_a, jnp.where(mid, (a - 1.0) / (a + 1.0), a))
    y0 = jnp.where(big, _PIO2, jnp.where(mid, _PIO4, 0.0))

    z = xr * xr
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * xr + xr
    return sign * (y0 + p)


def atan2(y, x):
    """Elementwise arctan2 with numpy's quadrant/zero conventions."""
    y = jnp.asarray(y)
    x = jnp.asarray(x)
    safe_x = jnp.where(x == 0.0, 1.0, x)
    base = atan(y / safe_x)

    # quadrant corrections for x < 0
    corr = jnp.where(y < 0, -_PI, _PI)
    out = jnp.where(x < 0, base + corr, base)

    # x == 0: +-pi/2 by sign of y; y == 0 too -> 0 (x >= +0) or pi (x < 0)
    out = jnp.where((x == 0.0) & (y != 0.0),
                    jnp.where(y > 0, _PIO2, -_PIO2), out)
    out = jnp.where((x == 0.0) & (y == 0.0), 0.0, out)
    return out


def _asin_core(a):
    """asin on [0, 1] (Cephes asinf)."""
    gt_half = a > 0.5
    z = jnp.where(gt_half, 0.5 * (1.0 - a), a * a)
    xr = jnp.where(gt_half, jnp.sqrt(z), a)
    p = ((((4.2163199048e-2 * z + 2.4181311049e-2) * z
           + 4.5470025998e-2) * z + 7.4953002686e-2) * z
         + 1.6666752422e-1) * z * xr + xr
    return jnp.where(gt_half, _PIO2 - 2.0 * p, p)


def asin(x):
    """Elementwise arcsine on [-1, 1] (NaN outside, like numpy)."""
    x = jnp.asarray(x)
    a = jnp.abs(x)
    out = jnp.sign(x) * _asin_core(jnp.minimum(a, 1.0))
    return jnp.where(a > 1.0, jnp.nan, out)


def acos(x):
    """Elementwise arccosine on [-1, 1] (Cephes acosf branch structure:
    full accuracy at both endpoints, unlike pi/2 - asin)."""
    x = jnp.asarray(x)
    a = jnp.abs(x)
    flank = 2.0 * _asin_core(jnp.sqrt(jnp.maximum(0.5 * (1.0 - a), 0.0)))
    out = jnp.where(
        x < -0.5, _PI - flank,
        jnp.where(x > 0.5, flank, _PIO2 - asin(x)),
    )
    return jnp.where(a > 1.0, jnp.nan, out)
