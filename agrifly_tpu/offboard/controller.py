"""Offboard cascaded controller (ground-station side).

jnp rewrite of Components/Components/Offboard/QuadcopterController.{hpp,cpp}:
a *static* (memoryless) wrapper around the onboard position/attitude
controllers producing (thrust, body-rate) commands.

`run` = full feedback to a setpoint (cpp:11-74): position PD -> proper
acceleration, norm saturation + max-tilt floor on the vertical component,
tilt-compensated thrust projection, thrust-direction attitude + yaw, then
attitude control.

`run_tracking` = trajectory tracking (cpp:76-131): thrust = refThrust +
accErr projected on the body z axis, attitude from (refAcc + accErr + g),
cmd rates = refAngVel + attitude-feedback rates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from agrifly_tpu.models import controllers
from agrifly_tpu.ops import rotation as rot

E3 = jnp.array([0.0, 0.0, 1.0], jnp.float32)


class OffboardCtrlParams(NamedTuple):
    pos_nat_freq: jnp.ndarray
    pos_damping: jnp.ndarray
    att_tc_xy: jnp.ndarray
    att_tc_z: jnp.ndarray
    min_vertical_proper_acc: jnp.ndarray  # max-tilt floor [m/s^2]
    max_proper_acc: jnp.ndarray
    min_proper_acc: jnp.ndarray


def make_params(v, min_vertical_proper_acc=0.5 * 9.81, max_proper_acc=20.0,
                min_proper_acc=-1.0) -> OffboardCtrlParams:
    f32 = jnp.float32
    return OffboardCtrlParams(
        pos_nat_freq=f32(v.pos_control_nat_freq),
        pos_damping=f32(v.pos_control_damping),
        att_tc_xy=f32(v.att_control_tc_xy),
        att_tc_z=f32(max(v.att_control_tc_z, v.att_control_tc_xy)),
        min_vertical_proper_acc=f32(min_vertical_proper_acc),
        max_proper_acc=f32(max_proper_acc),
        min_proper_acc=f32(min_proper_acc),
    )


def run(p: OffboardCtrlParams, cur_pos, cur_vel, cur_att, des_pos,
        des_vel=None, des_acc=None, des_yaw=0.0):
    """Full feedback to a position setpoint. Returns (cmd_angvel, cmd_thrust)."""
    cmd_acc = controllers.position_control(
        p.pos_nat_freq, p.pos_damping, cur_pos, cur_vel, des_pos, des_vel, des_acc
    )
    proper = cmd_acc + jnp.array([0.0, 0.0, 9.81], jnp.float32)

    norm = jnp.linalg.norm(proper)
    proper = jnp.where(norm > p.max_proper_acc, proper * (p.max_proper_acc / norm), proper)
    # scalar-stack rebuild of the clamped z component
    proper = jnp.stack([proper[..., 0], proper[..., 1],
                        jnp.maximum(proper[..., 2], p.min_vertical_proper_acc)],
                       axis=-1)

    norm = jnp.linalg.norm(proper)
    thrust_dir = proper / jnp.where(norm < 1e-12, 1.0, norm)
    cmd_thrust = norm * (rot.rotate(cur_att, E3) * thrust_dir).sum(-1)
    cmd_thrust = jnp.maximum(cmd_thrust, p.min_proper_acc)

    cmd_att = controllers.thrust_dir_to_attitude(thrust_dir)
    cmd_att = rot.qmul(cmd_att, rot.from_rotation_vector(
        jnp.stack([jnp.float32(0.0), jnp.float32(0.0), jnp.asarray(des_yaw, jnp.float32)])))
    cmd_angvel = controllers.attitude_control(p.att_tc_xy, p.att_tc_z, cmd_att, cur_att)
    return cmd_angvel, cmd_thrust


def run_tracking(p: OffboardCtrlParams, cur_pos, cur_vel, cur_att,
                 ref_pos, ref_vel, ref_acc, des_yaw, ref_thrust, ref_angvel):
    """Trajectory tracking. Returns (cmd_angvel, cmd_thrust, cmd_att)."""
    acc_err = controllers.position_control(
        p.pos_nat_freq, p.pos_damping, cur_pos, cur_vel, ref_pos, ref_vel
    )
    cmd_thrust = ref_thrust + (acc_err * rot.rotate(cur_att, E3)).sum(-1)

    total = ref_acc + acc_err + jnp.array([0.0, 0.0, 9.81], jnp.float32)
    norm = jnp.linalg.norm(total)
    thrust_dir = total / jnp.where(norm < 1e-12, 1.0, norm)
    ref_att = controllers.thrust_dir_to_attitude(thrust_dir)
    ref_att = rot.qmul(ref_att, rot.from_rotation_vector(
        jnp.stack([jnp.float32(0.0), jnp.float32(0.0), jnp.asarray(des_yaw, jnp.float32)])))
    angvel_err = controllers.attitude_control(p.att_tc_xy, p.att_tc_z, ref_att, cur_att)
    return ref_angvel + angvel_err, cmd_thrust, ref_att
