"""6-DOF quadcopter plant with first-order motor dynamics.

JAX redesign of the reference vehicle model (Components/Components/
Simulation/Quadcopter_T.cpp:86-156 and Motor.cpp:40-84): the four motors are
a single (4,)-vector state, all forces/torques are computed as batched vector
math, and one call advances the rigid body by dt with the reference's
integrator (p += v dt + 0.5 a dt^2; v += a dt; q <- q * exp(w dt);
w += alpha dt) and ground-plane clamp at z = 0.

Motor model per step (Motor.cpp:55-84):
  w <- c w + (1-c) max(cmd, 0), c = exp(-dt/tau) (0 if tau == 0); clamp
  thrust_i  = kf w|w| e3                     (both handedness thrust up)
  torque_i  = -kt_sqr w|w| s_i e3 + r_i x f_i - dw/dt J_m s_i e3
  ang mom_i = w J_m s_i e3
with s = (+1,-1,+1,-1) the rotation-axis signs ("x" layout, alternating
handedness, Quadcopter_T.cpp:45-65).

IMU fabrication (accelerometer = proper acceleration in body frame + noise,
gyro = angular velocity + noise, sigma 0.2 / 0.1, Quadcopter_T.cpp:5-6,
159-183) lives here too so the whole plant vmaps per env with a per-env
PRNG key.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.ops import lin3
from agrifly_tpu.ops import rotation as rot

GRAVITY = jnp.array([0.0, 0.0, -9.81], jnp.float32)
E3 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
EZ_MASK = jnp.array([False, False, True])
ACC_NOISE_STD = 0.2  # [m/s^2]
GYRO_NOISE_STD = 0.1  # [rad/s]

# rotation-axis z signs per motor (front-right spins "up")
MOTOR_SPIN_SIGNS = jnp.array([1.0, -1.0, 1.0, -1.0], jnp.float32)
# motor position pattern (x, y) / (armLength/sqrt(2))
MOTOR_XY = jnp.array(
    [[+1.0, -1.0], [-1.0, -1.0], [-1.0, +1.0], [+1.0, +1.0]], jnp.float32
)


class PlantParams(NamedTuple):
    mass: jnp.ndarray
    inertia: jnp.ndarray  # (3,3)
    inertia_inv: jnp.ndarray  # (3,3)
    motor_positions: jnp.ndarray  # (4,3) incl. center-of-mass error
    kf: jnp.ndarray  # thrust from speed^2
    kt_sqr: jnp.ndarray  # torque from speed^2
    motor_time_const: jnp.ndarray
    motor_inertia: jnp.ndarray
    motor_min_speed: jnp.ndarray
    motor_max_speed: jnp.ndarray
    lin_drag_b: jnp.ndarray  # (3,)
    imu_rot_inv: jnp.ndarray  # (3,3), world IMU mounting rotation inverse


class PlantState(NamedTuple):
    pos: jnp.ndarray  # (3,)
    vel: jnp.ndarray  # (3,)
    att: jnp.ndarray  # (4,)
    angvel: jnp.ndarray  # (3,)
    motor_speeds: jnp.ndarray  # (4,)


def make_params(v, centre_of_mass_error=(0.0, 0.0, 0.0)) -> PlantParams:
    """Build PlantParams from a VehicleParams preset."""
    import numpy as np

    d = v.arm_length / np.sqrt(2.0)
    com = np.asarray(centre_of_mass_error, np.float32)
    positions = np.concatenate(
        [np.asarray(MOTOR_XY) * d, np.zeros((4, 1), np.float32)], axis=1
    ) + com
    inertia = v.inertia_matrix
    imu_rot = rot.from_euler_ypr(v.imu_yaw, v.imu_pitch, v.imu_roll)
    f32 = jnp.float32
    return PlantParams(
        mass=f32(v.mass),
        inertia=jnp.asarray(inertia, jnp.float32),
        inertia_inv=jnp.asarray(np.linalg.inv(inertia), jnp.float32),
        motor_positions=jnp.asarray(positions, jnp.float32),
        kf=f32(v.prop_thrust_from_speed_sqr),
        kt_sqr=f32(v.prop_torque_from_speed_sqr),
        motor_time_const=f32(v.motor_time_const),
        motor_inertia=f32(v.motor_inertia),
        motor_min_speed=f32(v.motor_min_speed),
        motor_max_speed=f32(v.motor_max_speed),
        lin_drag_b=jnp.asarray(v.lin_drag_coeff_b, jnp.float32),
        imu_rot_inv=rot.to_matrix(rot.qinv(imu_rot)).astype(jnp.float32),
    )


def init_state(pos=(0.0, 0.0, 0.0), att=None) -> PlantState:
    return PlantState(
        pos=jnp.asarray(pos, jnp.float32),
        vel=jnp.zeros(3, jnp.float32),
        att=rot.identity() if att is None else jnp.asarray(att, jnp.float32),
        angvel=jnp.zeros(3, jnp.float32),
        motor_speeds=jnp.zeros(4, jnp.float32),
    )


def step(p: PlantParams, s: PlantState, motor_cmds, ext_force, ext_torque, dt):
    """Advance plant by dt. Returns (new_state, acc_world_for_imu).

    acc_world_for_imu is the world-frame acceleration including gravity, with
    its z zeroed on ground contact — exactly the value the reference feeds the
    accelerometer model (Quadcopter_T.cpp:131-151,170-177).
    """
    dt = jnp.float32(dt)

    # --- motors ---
    cmds = jnp.maximum(motor_cmds, 0.0)
    c = jnp.where(
        p.motor_time_const == 0.0, 0.0, jnp.exp(-dt / jnp.where(p.motor_time_const == 0.0, 1.0, p.motor_time_const))
    )
    new_speeds = c * s.motor_speeds + (1.0 - c) * cmds
    new_speeds = jnp.clip(new_speeds, p.motor_min_speed, p.motor_max_speed)
    dspeed = (new_speeds - s.motor_speeds) / dt

    w_abs_w = new_speeds * jnp.abs(new_speeds)  # (4,)
    thrusts = p.kf * w_abs_w  # (4,) along +z body
    # masked-column assembly (the spelling the golden traces pin)
    forces_b = thrusts[:, None] * E3  # (4,3): thrust along +z body

    # torque: aero drag, thrust moment, rotor acceleration reaction
    tz_aero = -p.kt_sqr * w_abs_w * MOTOR_SPIN_SIGNS
    tz_react = -dspeed * p.motor_inertia * MOTOR_SPIN_SIGNS
    torque_b = lin3.cross_rows(p.motor_positions, forces_b)  # (4,3)
    torque_b = torque_b + (tz_aero + tz_react)[:, None] * E3

    total_force_b = forces_b.sum(axis=0)
    total_torque_b = torque_b.sum(axis=0)

    # motor angular momentum (along +-z body)
    h_motor_z = (new_speeds * p.motor_inertia * MOTOR_SPIN_SIGNS).sum()

    # --- rigid body ---
    total_torque_b = total_torque_b + rot.rotate_back(s.att, ext_torque)

    ang_mom = lin3.mv3(p.inertia, s.angvel)
    ang_mom = ang_mom + h_motor_z * E3
    ang_acc = lin3.mv3(p.inertia_inv, total_torque_b - jnp.cross(s.angvel, ang_mom))

    vel_b = rot.rotate_back(s.att, s.vel)
    total_force_b = total_force_b - p.lin_drag_b * vel_b

    acc = GRAVITY + (rot.rotate(s.att, total_force_b) + ext_force) / p.mass

    new_pos = s.pos + s.vel * dt + 0.5 * acc * dt * dt
    new_vel = s.vel + acc * dt
    new_att = rot.qmul(s.att, rot.from_rotation_vector(s.angvel * dt))
    new_angvel = s.angvel + ang_acc * dt

    # ground contact (z-masked where, not .at[2]: see stack/where note above)
    grounded = (new_pos[2] <= 0.0) & (new_vel[2] < 0.0)
    zero_z = grounded & EZ_MASK
    new_pos = jnp.where(zero_z, 0.0, new_pos)
    new_vel = jnp.where(zero_z, 0.0, new_vel)
    acc_imu = jnp.where(zero_z, 0.0, acc)
    new_angvel = jnp.where(grounded, jnp.zeros_like(new_angvel), new_angvel)

    new_state = PlantState(
        pos=new_pos, vel=new_vel, att=new_att, angvel=new_angvel,
        motor_speeds=new_speeds,
    )
    return new_state, acc_imu


def imu_measurements(p: PlantParams, s: PlantState, acc_world, key=None,
                     noise=None):
    """Fabricate noisy IMU readings from the post-step plant state.

    Mirrors Quadcopter_T.cpp:159-183: gyro = R_imu^-1 angvel + noise;
    accel = R_imu^-1 (att^-1 (acc + g)) + noise. Uses the *new* attitude and
    angular velocity (the reference reads them after integration).

    noise: optional pre-drawn unit normals (gyro_n (3,), acc_n (3,)) — used
    by the fused orchard frame (one batched draw per frame instead of two
    threefry chains per tick).
    When None, draws from `key` as before.
    """
    if noise is None:
        k1, k2 = jax.random.split(key)
        gyro_n = jax.random.normal(k1, (3,), jnp.float32)
        acc_n = jax.random.normal(k2, (3,), jnp.float32)
    else:
        gyro_n, acc_n = noise
    gyro = lin3.mv3(p.imu_rot_inv, s.angvel) + gyro_n * GYRO_NOISE_STD
    acc_b = rot.rotate_back(s.att, acc_world - GRAVITY)
    acc_b = lin3.mv3(p.imu_rot_inv, acc_b) + acc_n * ACC_NOISE_STD
    return gyro, acc_b
