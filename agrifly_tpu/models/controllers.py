"""Cascaded controller stages as pure jnp functions.

Position -> acceleration (QuadcopterPositionController.hpp:22-27),
attitude -> body rates with tilt-prioritized reduced attitude
(QuadcopterAttitudeController.hpp:39-68), body rates -> torques with
gyroscopic feedforward (QuadcopterAngularVelocityController.hpp:26-39),
plus the thrust-direction -> attitude construction shared by the onboard
controllers and the offboard wrapper (QuadcopterLogic.cpp:414-446,
Offboard/QuadcopterController.cpp:49-66).
"""

from __future__ import annotations

import jax.numpy as jnp

from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.ops import trig

E3 = jnp.array([0.0, 0.0, 1.0], jnp.float32)


def position_control(nat_freq, damping, est_pos, est_vel, des_pos,
                     des_vel=None, des_acc=None):
    """P-D on position/velocity with acceleration feedforward."""
    if des_vel is None:
        des_vel = jnp.zeros_like(est_pos)
    if des_acc is None:
        des_acc = jnp.zeros_like(est_pos)
    return (
        (des_pos - est_pos) * nat_freq * nat_freq
        + (des_vel - est_vel) * 2.0 * nat_freq * damping
        + des_acc
    )


def attitude_control(tc_xy, tc_z, des_att, est_att):
    """Tilt-prioritized attitude control: separate xy / z time constants.

    Decomposes the attitude error into a full rotation vector plus a
    reduced-attitude (thrust-axis) component so tilt errors are corrected
    at 1/tc_xy while yaw errors relax at 1/tc_z.
    """
    err_att = rot.qmul(rot.qinv(des_att), est_att)
    des_rot_vec = rot.to_rotation_vector(err_att)

    e_b = rot.rotate_back(err_att, E3)  # errAtt^-1 * e3
    red_ax = jnp.cross(e_b, E3)
    red_cos = jnp.clip((e_b * E3).sum(-1), -1.0, 1.0)
    red_angle = trig.acos(red_cos)

    n = jnp.linalg.norm(red_ax)
    safe_n = jnp.where(n < 1e-12, 1.0, n)
    red_ax = jnp.where(n < 1e-12, jnp.zeros_like(red_ax), red_ax / safe_n)

    k3 = 1.0 / tc_z
    k12 = 1.0 / tc_xy
    return -k3 * des_rot_vec - (k12 - k3) * red_angle * red_ax


def angvel_control(tc_xy, tc_z, inertia, des_angvel, est_angvel):
    """tau = J * (err / tc) + w x (J w)."""
    err = des_angvel - est_angvel
    des_ang_accel = jnp.stack([err[..., 0] / tc_xy, err[..., 1] / tc_xy, err[..., 2] / tc_z], axis=-1)
    # broadcast-sum matvecs: tiny dot_generals may run in reduced
    # precision on matrix units
    nonlin = jnp.cross(est_angvel, (inertia * est_angvel[..., None, :]).sum(-1))
    return (inertia * des_ang_accel[..., None, :]).sum(-1) + nonlin


def thrust_dir_to_attitude(thrust_dir):
    """Smallest rotation taking e3 to thrust_dir (shared construction)."""
    cos_angle = jnp.clip((thrust_dir * E3).sum(-1), -1.0, 1.0)
    angle = trig.acos(cos_angle)
    ax = jnp.cross(E3, thrust_dir)
    n = jnp.linalg.norm(ax)
    small = n < 1e-6
    safe_n = jnp.where(small, 1.0, n)
    q = rot.from_rotation_vector(ax * (angle / safe_n))
    return jnp.where(small, rot.identity(q.dtype), q)
