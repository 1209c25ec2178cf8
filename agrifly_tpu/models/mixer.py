"""Thrust/torque -> per-propeller force allocation and force -> speed map.

"x" layout with motor 0 front-right, numbered clockwise when viewed from
above (x forward, y left); lever arm d = armLength/sqrt(2)
(QuadcopterMixer.hpp:20-114). The 4x4 allocation is written out explicitly
(it is its own inverse structure); saturation order matches the reference:
total-thrust cap first (leaving margin for attitude control), then per-prop
min/max clamps.
"""

from __future__ import annotations

import jax.numpy as jnp

from agrifly_tpu.ops import lin3

# allocation signs for (tx/d, ty/d, tz/kt) per motor 0..3
_SIGNS = jnp.array(
    [
        [-1.0, -1.0, -1.0],
        [-1.0, +1.0, +1.0],
        [+1.0, +1.0, -1.0],
        [+1.0, -1.0, +1.0],
    ],
    jnp.float32,
)


def motor_forces(params, total_thrust, torque):
    """Per-prop forces [N] from total thrust [N] and body torque [N m].

    params needs: arm_length, prop_torque_from_thrust, prop0_spin_dir,
    max_cmd_total_thrust, min/max_thrust_per_prop.
    """
    d = params.arm_length / jnp.sqrt(2.0)
    kt = params.prop0_spin_dir * params.prop_torque_from_thrust
    des_f = jnp.minimum(total_thrust, params.max_cmd_total_thrust)
    terms = jnp.stack([torque[..., 0] / d, torque[..., 1] / d, torque[..., 2] / kt], axis=-1)
    # scalar-expanded matvec (lin3.mv3 rationale: full f32 on every backend)
    f = (lin3.mv3(_SIGNS, terms) + des_f[..., None]) / 4.0
    return jnp.clip(f, params.min_thrust_per_prop, params.max_thrust_per_prop)


def speeds_from_forces(params, forces, corr_factors):
    """omega_i = sqrt(f_i / (corr_i * kf)), zero for non-positive thrust."""
    kf = params.prop_thrust_from_speed_sqr
    pos = forces > 0
    safe = jnp.where(pos, forces, 1.0)
    w = jnp.sqrt(safe / (corr_factors * kf))
    return jnp.where(pos, w, 0.0)


def uncorrected_force(params, speed):
    """kf * w^2 (used by propeller calibration)."""
    return params.prop_thrust_from_speed_sqr * speed * speed
