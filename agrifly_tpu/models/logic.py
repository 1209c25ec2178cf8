"""Onboard flight-controller logic as one pure jitted step.

JAX redesign of the reference's 500 Hz onboard main loop
(Components/Components/Logic/QuadcopterLogic.{hpp,cpp}): the class-with-
timers becomes `logic_step(params, state, inputs) -> (state, motor_cmds)`
over an immutable LogicState pytree. Flight-state machine, IMU filtering,
EKF, warnings, panic rules, the three controllers, propeller calibration
and gyro-bias calibration are all preserved; all timers are integer
microsecond counters advanced by the fixed onboard period.

Branching strategy: every controller branch is computed every tick and the
result is selected by flight-state code. Under vmap over thousands of
vehicles lax.switch would execute all branches anyway; computing them
unconditionally keeps the program straight-line for XLA fusion.

Flight states (QuadcopterLogic.hpp:148-157) and panic codes
(PanicReason.hpp:5-40) keep the reference's numbering.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from agrifly_tpu.io import radio
from agrifly_tpu.models import constants as qconst
from agrifly_tpu.models import controllers, ekf, mixer
from agrifly_tpu.ops import filters, lin3
from agrifly_tpu.ops import rotation as rot

# flight states
FS_UNINITIALIZED = 0
FS_IDLE = 1
FS_FULLY_AUTONOMOUS = 2
FS_PANIC = 3
FS_KILLED = 4
FS_EXTERNAL_ACCELERATION_CONTROL = 5
FS_EXTERNAL_RATES_CONTROL = 6

# panic reasons
PANIC_NO_PANIC = 0
PANIC_ONBOARD_ESTIMATE_CRAZY = 1
PANIC_UWB_TIMEOUT = 2
PANIC_UPSIDE_DOWN = 3
PANIC_RADIO_CMD_TIMEOUT = 4
PANIC_LOW_BATTERY = 5
PANIC_KILLED_INTERNALLY = 6
PANIC_KILLED_EXTERNALLY = 7

PANIC_REASON_NAMES = {
    PANIC_NO_PANIC: "NO_PANIC",
    PANIC_ONBOARD_ESTIMATE_CRAZY: "ONBOARD_ESTIMATE_CRAZY",
    PANIC_UWB_TIMEOUT: "UWB_TIMEOUT",
    PANIC_UPSIDE_DOWN: "UPSIDE_DOWN",
    PANIC_RADIO_CMD_TIMEOUT: "RADIO_CMD_TIMEOUT",
    PANIC_LOW_BATTERY: "LOW_BATTERY",
    PANIC_KILLED_INTERNALLY: "KILLED_INTERNALLY",
    PANIC_KILLED_EXTERNALLY: "KILLED_EXTERNALLY",
}

# telemetry warning bits (TelemetryPacket.hpp:21-30)
WARN_LOW_BATT = 0x01
WARN_CMD_RATE = 0x02
WARN_UWB_RESET = 0x04
WARN_ONBOARD_FREQ = 0x08
WARN_CMD_BATCH_DROP = 0x10

# timeouts / thresholds (QuadcopterLogic.cpp:305-391)
NO_UWB_PANIC_TIMEOUT_US = 1_500_000
NO_RADIO_PANIC_TIMEOUT_US = 1_500_000
MIN_SANE_ESTIMATOR_HEIGHT = -2.0
WARN_BATCH_CMD_DROP_NUM = 3
WARNING_WINDOW_EST_RESET_US = 20_000

RADIO_CMD_PERIOD = 0.02  # [s] expected command period (QuadcopterLogic.cpp:10)

MAX_RANGING_TARGETS = 32

_US_SAT = 100_000_000  # saturate timers at 100 s to avoid int32 overflow


class LogicParams(NamedTuple):
    """Static per-vehicle constants used by the onboard logic."""

    valid: jnp.ndarray  # bool
    mass: jnp.ndarray
    # mixer fields (names shared with models.mixer)
    arm_length: jnp.ndarray
    prop_thrust_from_speed_sqr: jnp.ndarray
    prop_torque_from_thrust: jnp.ndarray
    prop0_spin_dir: jnp.ndarray
    max_thrust_per_prop: jnp.ndarray
    min_thrust_per_prop: jnp.ndarray
    max_cmd_total_thrust: jnp.ndarray
    # controller gains
    pos_nat_freq: jnp.ndarray
    pos_damping: jnp.ndarray
    att_tc_xy: jnp.ndarray
    att_tc_z: jnp.ndarray
    angvel_tc_xy: jnp.ndarray
    angvel_tc_z: jnp.ndarray
    inertia: jnp.ndarray  # (3,3)
    # IMU mounting rotation matrix (_R, QuadcopterLogic.cpp:115-119)
    imu_rot: jnp.ndarray  # (3,3)
    # battery
    batt_critical: jnp.ndarray
    batt_warning: jnp.ndarray
    # timing
    onboard_period: jnp.ndarray  # [s]
    onboard_period_us: jnp.ndarray  # int32
    # filter coefficients
    acc_lp: filters.Lp2Coeffs
    gyro_lp: filters.Lp2Coeffs
    temp_lp: filters.Lp2Coeffs
    batt_lp: filters.Lp2Coeffs
    cmd_rate_lp_coeff: jnp.ndarray  # 1st-order coeff for cmd-rate monitor
    loop_lp_coeff: jnp.ndarray
    # UWB ranging targets
    target_positions: jnp.ndarray  # (MAX_RANGING_TARGETS, 3)
    target_ids: jnp.ndarray  # (MAX_RANGING_TARGETS,) int32
    num_targets: jnp.ndarray  # int32


class LogicState(NamedTuple):
    fs: jnp.ndarray  # int32 flight state
    cycle_count: jnp.ndarray  # int32
    kf: ekf.EkfState
    # IMU filters
    acc_lp: filters.Lp2State
    gyro_lp: filters.Lp2State
    temp_lp: filters.Lp2State
    batt_lp: filters.Lp2State
    gyro_raw: jnp.ndarray  # (3,) after mounting rotation, pre-bias
    # gyro calibration
    gyro_bias: jnp.ndarray  # (3,)
    gyro_cal_enabled: jnp.ndarray  # bool
    gyro_cal_accum: jnp.ndarray  # (3,)
    gyro_cal_count: jnp.ndarray  # int32
    # radio
    radio_new: jnp.ndarray  # bool
    radio_type: jnp.ndarray  # int32
    radio_flags: jnp.ndarray  # int32
    radio_floats: jnp.ndarray  # (10,) decoded
    radio_count: jnp.ndarray  # int32
    us_since_radio: jnp.ndarray  # int32
    # uwb
    us_since_uwb: jnp.ndarray  # int32
    next_target_idx: jnp.ndarray  # int32
    uwb_meas_count: jnp.ndarray  # int32
    # monitors
    cmd_rate_lpdt: jnp.ndarray  # f32 [s]
    loop_lpdt: jnp.ndarray  # f32 [s]
    us_since_est_reset: jnp.ndarray  # int32
    last_check_num_resets: jnp.ndarray  # int32
    warnings: jnp.ndarray  # int32 bitfield
    panic_reason: jnp.ndarray  # int32
    # outputs
    des_motor_speeds: jnp.ndarray  # (4,)
    des_motor_forces: jnp.ndarray  # (4,)
    # propeller calibration
    prop_cal_running: jnp.ndarray  # bool
    prop_cal_factors: jnp.ndarray  # (4,)
    prop_cal_accum: jnp.ndarray  # (4,)
    prop_cal_count: jnp.ndarray  # int32
    should_write_params: jnp.ndarray  # bool
    # battery
    batt_voltage: jnp.ndarray
    batt_current: jnp.ndarray
    # motor test mode (TestMotors, QuadcopterLogic.hpp:236-239)
    test_motors_on: jnp.ndarray  # bool
    test_motors_frac: jnp.ndarray  # f32 thrust fraction of hover weight
    # misc
    tel_counter: jnp.ndarray  # int32
    debug: jnp.ndarray  # (6,)


class LogicInputs(NamedTuple):
    gyro: jnp.ndarray  # (3,) raw rate gyro [rad/s] (IMU frame)
    acc: jnp.ndarray  # (3,) raw accelerometer [m/s^2] (IMU frame)
    temperature: jnp.ndarray
    batt_voltage: jnp.ndarray
    batt_current: jnp.ndarray
    radio_new: jnp.ndarray  # bool
    radio_type: jnp.ndarray  # int32
    radio_flags: jnp.ndarray  # int32
    radio_fields: jnp.ndarray  # (10,) int32 wire codes
    uwb_new: jnp.ndarray  # bool
    uwb_range: jnp.ndarray  # f32
    uwb_responder_id: jnp.ndarray  # int32
    uwb_failure: jnp.ndarray  # bool


def null_inputs() -> LogicInputs:
    z3 = jnp.zeros(3, jnp.float32)
    return LogicInputs(
        gyro=z3, acc=z3, temperature=jnp.float32(25.0),
        batt_voltage=jnp.float32(0.0), batt_current=jnp.float32(-1.0),
        radio_new=jnp.bool_(False), radio_type=jnp.int32(0),
        radio_flags=jnp.int32(0), radio_fields=jnp.zeros(10, jnp.int32),
        uwb_new=jnp.bool_(False), uwb_range=jnp.float32(0.0),
        uwb_responder_id=jnp.int32(0), uwb_failure=jnp.bool_(False),
    )


def make_params(v: qconst.VehicleParams, onboard_period=1.0 / 500.0) -> LogicParams:
    """Build LogicParams from a VehicleParams preset (QuadcopterLogic.cpp:98-162)."""
    import math

    f32 = jnp.float32
    imu_rot = rot.to_matrix(
        rot.from_euler_ypr(v.imu_yaw, v.imu_pitch, v.imu_roll)
    ).astype(jnp.float32)
    tpos = jnp.zeros((MAX_RANGING_TARGETS, 3), jnp.float32)
    tids = jnp.zeros((MAX_RANGING_TARGETS,), jnp.int32)
    return LogicParams(
        valid=jnp.bool_(v.valid),
        mass=f32(v.mass),
        arm_length=f32(v.arm_length),
        prop_thrust_from_speed_sqr=f32(v.prop_thrust_from_speed_sqr),
        prop_torque_from_thrust=f32(v.prop_torque_from_thrust),
        prop0_spin_dir=f32(v.prop0_spin_dir),
        max_thrust_per_prop=f32(v.max_thrust_per_prop),
        min_thrust_per_prop=f32(v.min_thrust_per_prop),
        max_cmd_total_thrust=f32(v.max_cmd_total_thrust),
        pos_nat_freq=f32(v.pos_control_nat_freq),
        pos_damping=f32(v.pos_control_damping),
        att_tc_xy=f32(v.att_control_tc_xy),
        att_tc_z=f32(max(v.att_control_tc_z, v.att_control_tc_xy)),
        angvel_tc_xy=f32(v.angvel_control_tc_xy),
        angvel_tc_z=f32(v.angvel_control_tc_z),
        inertia=jnp.asarray(v.inertia_matrix, jnp.float32),
        imu_rot=imu_rot,
        batt_critical=f32(v.low_battery_threshold),
        batt_warning=f32(1.05 * v.low_battery_threshold),
        onboard_period=f32(onboard_period),
        onboard_period_us=jnp.int32(round(onboard_period * 1e6)),
        acc_lp=filters.lp2_coeffs(onboard_period, 100.0),
        gyro_lp=filters.lp2_coeffs(onboard_period, 200.0),
        temp_lp=filters.lp2_coeffs(onboard_period, 0.5 * 2 * math.pi),
        batt_lp=filters.lp2_coeffs(onboard_period, 0.5 * 2 * math.pi),
        cmd_rate_lp_coeff=f32(math.exp(-RADIO_CMD_PERIOD * 1.0)),
        loop_lp_coeff=f32(math.exp(-onboard_period * 50.0)),
        target_positions=tpos,
        target_ids=tids,
        num_targets=jnp.int32(0),
    )


def with_ranging_targets(p: LogicParams, ids, positions) -> LogicParams:
    """Install UWB anchor targets (AddRangingTargetId equivalent)."""
    import numpy as np

    n = len(ids)
    tpos = np.zeros((MAX_RANGING_TARGETS, 3), np.float32)
    tids = np.zeros((MAX_RANGING_TARGETS,), np.int32)
    tpos[:n] = np.asarray(positions, np.float32)
    tids[:n] = np.asarray(ids, np.int32)
    return p._replace(
        target_positions=jnp.asarray(tpos),
        target_ids=jnp.asarray(tids),
        num_targets=jnp.int32(n),
    )


def init_state(p: LogicParams) -> LogicState:
    """Post-Initialise state: IDLE if the vehicle type is valid, else KILLED."""
    z3 = jnp.zeros(3, jnp.float32)
    fs = jnp.where(p.valid, jnp.int32(FS_IDLE), jnp.int32(FS_KILLED))
    panic = jnp.where(p.valid, jnp.int32(PANIC_NO_PANIC), jnp.int32(PANIC_KILLED_INTERNALLY))
    return LogicState(
        fs=fs,
        cycle_count=jnp.int32(0),
        kf=ekf.init_state(),
        acc_lp=filters.lp2_init(z3),
        gyro_lp=filters.lp2_init(z3),
        temp_lp=filters.lp2_init(jnp.float32(25.0)),
        batt_lp=filters.lp2_init(p.batt_critical * 1.2),
        gyro_raw=z3,
        gyro_bias=z3,
        gyro_cal_enabled=jnp.bool_(False),
        gyro_cal_accum=z3,
        gyro_cal_count=jnp.int32(0),
        radio_new=jnp.bool_(False),
        radio_type=jnp.int32(0),
        radio_flags=jnp.int32(0),
        radio_floats=jnp.zeros(10, jnp.float32),
        radio_count=jnp.int32(0),
        us_since_radio=jnp.int32(0),
        us_since_uwb=jnp.int32(0),
        next_target_idx=jnp.int32(0),
        uwb_meas_count=jnp.int32(0),
        cmd_rate_lpdt=jnp.float32(RADIO_CMD_PERIOD),
        loop_lpdt=p.onboard_period,
        us_since_est_reset=jnp.int32(_US_SAT),
        last_check_num_resets=jnp.int32(0),
        warnings=jnp.int32(0),
        panic_reason=panic,
        des_motor_speeds=jnp.zeros(4, jnp.float32),
        des_motor_forces=jnp.zeros(4, jnp.float32),
        prop_cal_running=jnp.bool_(False),
        prop_cal_factors=jnp.ones(4, jnp.float32),
        prop_cal_accum=jnp.zeros(4, jnp.float32),
        prop_cal_count=jnp.int32(0),
        should_write_params=jnp.bool_(False),
        batt_voltage=jnp.float32(0.0),
        batt_current=jnp.float32(-1.0),
        test_motors_on=jnp.bool_(False),
        test_motors_frac=jnp.float32(0.0),
        tel_counter=jnp.int32(0),
        debug=jnp.zeros(6, jnp.float32),
    )


def _advance_timer(us, period_us):
    return jnp.minimum(us + period_us, _US_SAT).astype(jnp.int32)


def _lookup_target(p: LogicParams, responder_id):
    """Anchor position for a responder id; (pos, known).

    One-hot masked reduction instead of a gather (vmap-friendly)."""
    idx_arr = jnp.arange(MAX_RANGING_TARGETS)
    match = (p.target_ids == responder_id) & (idx_arr < p.num_targets)
    known = jnp.any(match)
    pos = jnp.where(match[:, None], p.target_positions, 0.0).sum(axis=0)
    return pos, known


def logic_step(p: LogicParams, s: LogicState, u: LogicInputs):
    """One onboard tick. Returns (new_state, motor_speed_cmds (4,))."""
    per_us = p.onboard_period_us

    # ---------------- sensor ingestion (the Set* methods) ----------------
    gyro_raw = lin3.mv3(p.imu_rot, u.gyro)
    gyro_lp, _ = filters.lp2_apply(p.gyro_lp, s.gyro_lp, gyro_raw - s.gyro_bias)
    acc_raw = lin3.mv3(p.imu_rot, u.acc)
    acc_lp, _ = filters.lp2_apply(p.acc_lp, s.acc_lp, acc_raw)
    temp_lp, _ = filters.lp2_apply(p.temp_lp, s.temp_lp, u.temperature)
    batt_lp, _ = filters.lp2_apply(p.batt_lp, s.batt_lp, u.batt_voltage)

    # radio delivery: decoded floats + cmd-rate monitor update
    us_since_radio = _advance_timer(s.us_since_radio, per_us)
    cmd_dt = us_since_radio.astype(jnp.float32) * 1e-6
    new_lpdt = p.cmd_rate_lp_coeff * s.cmd_rate_lpdt + (1.0 - p.cmd_rate_lp_coeff) * cmd_dt
    cmd_rate_lpdt = jnp.where(u.radio_new, new_lpdt, s.cmd_rate_lpdt)
    radio_floats = jnp.where(
        u.radio_new, radio.decode_message(u.radio_type, u.radio_fields), s.radio_floats
    )
    radio_type = jnp.where(u.radio_new, u.radio_type, s.radio_type)
    radio_flags = jnp.where(u.radio_new, u.radio_flags, s.radio_flags)
    radio_count = s.radio_count + u.radio_new.astype(jnp.int32)
    us_since_radio = jnp.where(u.radio_new, jnp.int32(0), us_since_radio)

    us_since_uwb = _advance_timer(s.us_since_uwb, per_us)
    us_since_uwb = jnp.where(u.uwb_new, jnp.int32(0), us_since_uwb)

    s = s._replace(
        gyro_lp=gyro_lp, acc_lp=acc_lp, temp_lp=temp_lp, batt_lp=batt_lp,
        gyro_raw=gyro_raw,
        cmd_rate_lpdt=cmd_rate_lpdt, us_since_radio=us_since_radio,
        us_since_uwb=us_since_uwb,
        radio_new=s.radio_new | u.radio_new,
        radio_type=radio_type, radio_flags=radio_flags,
        radio_floats=radio_floats, radio_count=radio_count,
        batt_voltage=u.batt_voltage, batt_current=u.batt_current,
    )

    # ---------------- Run() ----------------
    cycle = s.cycle_count + 1
    loop_lpdt = p.loop_lp_coeff * s.loop_lpdt + (1.0 - p.loop_lp_coeff) * p.onboard_period

    gyro_f = filters.lp2_value(gyro_lp)
    acc_f = filters.lp2_value(acc_lp)

    # --- UpdateEstimator ---
    kf = ekf.predict(s.kf, gyro_f, acc_f, p.onboard_period)
    cal_on = s.gyro_cal_enabled
    gyro_cal_accum = jnp.where(cal_on, s.gyro_cal_accum + gyro_raw, s.gyro_cal_accum)
    gyro_cal_count = s.gyro_cal_count + cal_on.astype(jnp.int32)

    if isinstance(u.uwb_new, bool) and not u.uwb_new:
        # statically no UWB in this configuration: skip the whole range
        # update at trace time (with apply=False it is a no-op anyway, but
        # XLA does not fully fold away its masked covariance work)
        uwb_meas_count = s.uwb_meas_count
        next_target_idx = s.next_target_idx
    else:
        uwb_success = u.uwb_new & ~u.uwb_failure
        target_pos, target_known = _lookup_target(p, u.uwb_responder_id)
        kf = ekf.update_range(kf, target_pos, u.uwb_range, uwb_success & target_known)
        uwb_meas_count = s.uwb_meas_count + uwb_success.astype(jnp.int32)
        next_target_idx = jnp.where(
            u.uwb_new & (p.num_targets > 0),
            (s.next_target_idx + 1) % jnp.maximum(p.num_targets, 1),
            s.next_target_idx,
        )

    # --- ParseIncomingCommunications ---
    sticky = (s.fs == FS_PANIC) | (s.fs == FS_KILLED)
    fs = s.fs
    panic_reason = s.panic_reason
    take = s.radio_new & ~sticky
    fs = jnp.where(take & (radio_type == radio.TYPE_EMERGENCY_KILL), FS_KILLED, fs)
    panic_reason = jnp.where(
        take & (radio_type == radio.TYPE_EMERGENCY_KILL) & (panic_reason == 0),
        PANIC_KILLED_EXTERNALLY, panic_reason,
    )
    fs = jnp.where(take & (radio_type == radio.TYPE_POSITION_CMD), FS_FULLY_AUTONOMOUS, fs)
    fs = jnp.where(take & (radio_type == radio.TYPE_EXTERNAL_ACC_CMD), FS_EXTERNAL_ACCELERATION_CONTROL, fs)
    fs = jnp.where(take & (radio_type == radio.TYPE_EXTERNAL_RATES_CMD), FS_EXTERNAL_RATES_CONTROL, fs)
    fs = jnp.where(take & (radio_type == radio.TYPE_IDLE_CMD), FS_IDLE, fs)
    radio_new = jnp.bool_(False)

    # --- UpdateWarnings ---
    warnings = s.warnings
    batt_filt = filters.lp2_value(batt_lp)
    warnings = warnings | jnp.where(batt_filt <= p.batt_warning, WARN_LOW_BATT, 0)
    warnings = warnings | jnp.where(
        jnp.abs(cmd_rate_lpdt - RADIO_CMD_PERIOD) > 0.1 * RADIO_CMD_PERIOD, WARN_CMD_RATE, 0
    )
    warnings = warnings | jnp.where(
        us_since_radio.astype(jnp.float32) * 1e-6 > WARN_BATCH_CMD_DROP_NUM * RADIO_CMD_PERIOD,
        WARN_CMD_BATCH_DROP, 0,
    )
    warnings = warnings | jnp.where(
        jnp.abs(loop_lpdt - p.onboard_period) > 0.05 * p.onboard_period, WARN_ONBOARD_FREQ, 0
    )
    was_reset = kf.num_resets != s.last_check_num_resets
    us_since_est_reset = jnp.where(
        was_reset, jnp.int32(0), _advance_timer(s.us_since_est_reset, per_us)
    )
    warnings = warnings | jnp.where(
        us_since_est_reset < WARNING_WINDOW_EST_RESET_US, WARN_UWB_RESET, 0
    )

    # --- CheckPanicReasons ---
    motors_running = jnp.any(s.des_motor_speeds > 0)
    checks_disabled = (radio_flags & radio.FLAG_DISABLE_SAFETY_CHECKS) != 0
    unsafe = jnp.int32(0)
    unsafe = jnp.where(
        (kf.pos[2] < MIN_SANE_ESTIMATOR_HEIGHT) & ~checks_disabled,
        PANIC_ONBOARD_ESTIMATE_CRAZY, unsafe,
    )
    unsafe = jnp.where(
        (us_since_uwb > NO_UWB_PANIC_TIMEOUT_US) & (fs == FS_FULLY_AUTONOMOUS),
        PANIC_UWB_TIMEOUT, unsafe,
    )
    upside_down = rot.rotate(kf.att, jnp.array([0.0, 0.0, 1.0], jnp.float32))[2] < 0
    unsafe = jnp.where(upside_down & ~checks_disabled, PANIC_UPSIDE_DOWN, unsafe)
    unsafe = jnp.where(us_since_radio > NO_RADIO_PANIC_TIMEOUT_US, PANIC_RADIO_CMD_TIMEOUT, unsafe)
    unsafe = jnp.where(batt_filt <= p.batt_critical, PANIC_LOW_BATTERY, unsafe)
    unsafe = jnp.where(motors_running, unsafe, jnp.int32(0))

    in_critical = (
        (fs == FS_FULLY_AUTONOMOUS)
        | (fs == FS_EXTERNAL_ACCELERATION_CONTROL)
        | (fs == FS_EXTERNAL_RATES_CONTROL)
    )
    go_panic = (unsafe != 0) & in_critical & (fs != FS_PANIC)
    panic_reason = jnp.where(go_panic, unsafe, panic_reason)
    fs = jnp.where(go_panic, FS_PANIC, fs)

    # scalar-stack rebuild of the debug vector
    d = s.debug
    debug = jnp.stack([filters.lp2_value(temp_lp), d[..., 1], d[..., 2],
                       d[..., 3], d[..., 4], d[..., 5]], axis=-1)

    # ---------------- controllers ----------------
    est_pos, est_vel, est_att, est_angvel = kf.pos, kf.vel, kf.att, kf.angvel
    g_vec = jnp.array([0.0, 0.0, 9.81], jnp.float32)

    # FULLY_AUTONOMOUS (QuadcopterLogic.cpp:393-457)
    des_pos = radio_floats[0:3]
    des_acc = controllers.position_control(
        p.pos_nat_freq, p.pos_damping, est_pos, est_vel, des_pos
    )
    proper_acc = des_acc + g_vec
    norm_pa = jnp.linalg.norm(proper_acc)
    thrust_dir = proper_acc / jnp.where(norm_pa < 1e-12, 1.0, norm_pa)
    corr = rot.rotate(est_att, jnp.array([0.0, 0.0, 1.0], jnp.float32))[2]
    corr_sat = jnp.maximum(corr, 1.0)  # MIN_THRUST_CORR_FAC = 1.0
    thrust_auto = norm_pa / corr_sat
    des_att_auto = controllers.thrust_dir_to_attitude(thrust_dir)
    angvel_auto = controllers.attitude_control(p.att_tc_xy, p.att_tc_z, des_att_auto, est_att)
    torque_auto = controllers.angvel_control(
        p.angvel_tc_xy, p.angvel_tc_z, p.inertia, angvel_auto, est_angvel
    )
    forces_auto = mixer.motor_forces(p, thrust_auto * p.mass, torque_auto)

    # EXTERNAL_ACCELERATION (cpp:459-526)
    cmd_acc = radio_floats[0:3]
    yaw_rate = radio_floats[3]
    pa2 = cmd_acc + g_vec
    thrust_acc = jnp.linalg.norm(pa2)
    dir2 = pa2 / jnp.where(thrust_acc < 1e-12, 1.0, thrust_acc)
    des_att2 = controllers.thrust_dir_to_attitude(dir2)
    _, pitch, roll = rot.to_euler_ypr(est_att)
    att_no_yaw = rot.from_euler_ypr(jnp.float32(0.0), pitch, roll)
    angvel2 = controllers.attitude_control(p.att_tc_xy, p.att_tc_z, des_att2, att_no_yaw)
    angvel2 = jnp.where(jnp.arange(3) == 2, yaw_rate, angvel2)
    torque2 = controllers.angvel_control(
        p.angvel_tc_xy, p.angvel_tc_z, p.inertia, angvel2, est_angvel
    )
    forces_acc = mixer.motor_forces(p, thrust_acc * p.mass, torque2)
    acc_cutoff = cmd_acc[2] < (-9.81 / 2)  # "magic number" kill-switch
    forces_acc = jnp.where(acc_cutoff, jnp.zeros(4, jnp.float32), forces_acc)

    # EXTERNAL_RATES (cpp:528-541)
    thrust_rates = radio_floats[0]
    angvel3 = radio_floats[1:4]
    torque3 = controllers.angvel_control(
        p.angvel_tc_xy, p.angvel_tc_z, p.inertia, angvel3, est_angvel
    )
    forces_rates = mixer.motor_forces(p, thrust_rates * p.mass, torque3)

    forces = jnp.zeros(4, jnp.float32)
    forces = jnp.where(fs == FS_FULLY_AUTONOMOUS, forces_auto, forces)
    forces = jnp.where(fs == FS_EXTERNAL_ACCELERATION_CONTROL, forces_acc, forces)
    forces = jnp.where(fs == FS_EXTERNAL_RATES_CONTROL, forces_rates, forces)

    speeds = mixer.speeds_from_forces(p, forces, s.prop_cal_factors)
    zero_out = (
        (fs == FS_IDLE) | (fs == FS_PANIC) | (fs == FS_KILLED) | (fs == FS_UNINITIALIZED)
        | ((fs == FS_EXTERNAL_ACCELERATION_CONTROL) & acc_cutoff)
    )
    speeds = jnp.where(zero_out, jnp.zeros(4, jnp.float32), speeds)
    forces = jnp.where(zero_out, jnp.zeros(4, jnp.float32), forces)

    # motor test mode overrides the state machine (QuadcopterLogic.cpp:181-191)
    torque_test = controllers.angvel_control(
        p.angvel_tc_xy, p.angvel_tc_z, p.inertia, jnp.zeros(3, jnp.float32), est_angvel
    )
    forces_test = mixer.motor_forces(p, s.test_motors_frac * 9.81 * p.mass, torque_test)
    speeds_test = mixer.speeds_from_forces(p, forces_test, s.prop_cal_factors)
    forces = jnp.where(s.test_motors_on, forces_test, forces)
    speeds = jnp.where(s.test_motors_on, speeds_test, speeds)

    # ---------------- propeller calibration (cpp:543-588) ----------------
    in_rates = fs == FS_EXTERNAL_RATES_CONTROL
    cal_flag = in_rates & ((radio_flags & radio.FLAG_CALIBRATE_MOTORS) != 0)
    starting = cal_flag & ~s.prop_cal_running
    accum = jnp.where(starting, jnp.zeros(4, jnp.float32), s.prop_cal_accum)
    count = jnp.where(starting, jnp.int32(0), s.prop_cal_count)
    accum = jnp.where(cal_flag, accum + mixer.uncorrected_force(p, speeds), accum)
    count = jnp.where(cal_flag, count + 1, count)

    finishing = in_rates & ~cal_flag & s.prop_cal_running
    enough = count >= 750
    per_prop = p.mass * 9.81 / 4.0
    safe_accum = jnp.where(accum != 0, accum, 1.0)
    new_factors = jnp.clip(
        count.astype(jnp.float32) * per_prop / safe_accum, 0.7, 1.0 / 0.7
    )
    factors = jnp.where(finishing & enough, new_factors, s.prop_cal_factors)
    should_write = s.should_write_params | (finishing & enough)
    running = jnp.where(cal_flag, jnp.bool_(True), jnp.where(finishing, jnp.bool_(False), s.prop_cal_running))

    new_state = s._replace(
        fs=fs.astype(jnp.int32),
        cycle_count=cycle,
        kf=kf,
        gyro_cal_accum=gyro_cal_accum,
        gyro_cal_count=gyro_cal_count,
        radio_new=radio_new,
        us_since_uwb=us_since_uwb,
        next_target_idx=next_target_idx,
        uwb_meas_count=uwb_meas_count,
        loop_lpdt=loop_lpdt,
        us_since_est_reset=us_since_est_reset,
        last_check_num_resets=kf.num_resets,
        warnings=warnings.astype(jnp.int32),
        panic_reason=panic_reason.astype(jnp.int32),
        des_motor_speeds=speeds,
        des_motor_forces=forces,
        prop_cal_running=running,
        prop_cal_factors=factors,
        prop_cal_accum=accum,
        prop_cal_count=count,
        should_write_params=should_write,
        debug=debug,
    )
    return new_state, speeds


def set_gyro_calibration(s: LogicState, enable: bool) -> LogicState:
    """Start/stop gyro-bias calibration (QuadcopterLogic.hpp:118-146)."""
    enable = jnp.bool_(enable)
    ending = s.gyro_cal_enabled & ~enable
    n = jnp.maximum(s.gyro_cal_count, 1).astype(jnp.float32)
    bias = jnp.where(
        ending & (s.gyro_cal_count > 0), s.gyro_cal_accum / n, s.gyro_bias
    )
    return s._replace(gyro_cal_enabled=enable, gyro_bias=bias)


FS_NAMES = {
    FS_UNINITIALIZED: "FS_UNINITIALIZED",
    FS_IDLE: "FS_IDLE",
    FS_FULLY_AUTONOMOUS: "FS_FULLY_AUTONOMOUS",
    FS_PANIC: "FS_PANIC",
    FS_KILLED: "FS_KILLED",
    FS_EXTERNAL_ACCELERATION_CONTROL: "FS_EXTERNAL_ACCELERATION_CONTROL",
    FS_EXTERNAL_RATES_CONTROL: "FS_EXTERNAL_RATES_CONTROL",
}


def format_status(p: LogicParams, s: LogicState, vehicle_id=0) -> str:
    """Host-side debug dump of one vehicle's onboard state — the
    PrintStatus() report (QuadcopterLogic.cpp:681-826) as a string."""
    import numpy as np

    from agrifly_tpu.ops import filters, rotation as rot_ops

    acc = np.asarray(filters.lp2_value(s.acc_lp))
    gyro = np.asarray(filters.lp2_value(s.gyro_lp))
    y, pch, r = (float(x) for x in rot_ops.to_euler_ypr(s.kf.att))
    lines = [
        f"Quad logic status over {int(s.cycle_count)} cycles "
        f"(avg dt = {float(s.loop_lpdt):.5f}, expected = {float(p.onboard_period):.5f})",
        f"Vehicle id = {vehicle_id}",
        f"\tState = {FS_NAMES.get(int(s.fs), int(s.fs))}",
        f"\tBattery: {float(s.batt_voltage):.3f}V "
        f"(filtered {float(filters.lp2_value(s.batt_lp)):.3f}V), {float(s.batt_current):.3f}A",
        f"\tAccelerometer = ({acc[0]:.3f}, {acc[1]:.3f}, {acc[2]:.3f}) m/s^2",
        f"\tRate gyro     = ({gyro[0]:.3f}, {gyro[1]:.3f}, {gyro[2]:.3f}) rad/s",
        f"\tGyro bias     = {np.asarray(s.gyro_bias).round(4).tolist()}",
        f"\tEstimator: init imu={bool(s.kf.imu_init)} uwb={bool(s.kf.uwb_init)}",
        f"\t\tpos = {np.asarray(s.kf.pos).round(3).tolist()} m",
        f"\t\tvel = {np.asarray(s.kf.vel).round(3).tolist()} m/s",
        f"\t\tatt YPR = ({y:.3f}, {pch:.3f}, {r:.3f}) rad",
        f"\t\tangVel = {np.asarray(s.kf.angvel).round(3).tolist()} rad/s",
        f"\t\trejected = {int(s.kf.num_rejected)}, resets = {int(s.kf.num_resets)}",
        f"\tUWB: meas = {int(s.uwb_meas_count)}, next target idx = {int(s.next_target_idx)}",
        f"\tDesired motor speeds = {np.asarray(s.des_motor_speeds).round(2).tolist()}",
        f"\tPropeller correction = {np.asarray(s.prop_cal_factors).round(3).tolist()}",
        f"\tRadio: count = {int(s.radio_count)}, type = {int(s.radio_type)}, "
        f"flags = {int(s.radio_flags)}, cmd dt = {float(s.cmd_rate_lpdt):.5f}s",
        f"\tTelemetry sent = {int(s.tel_counter)}",
        f"\tDebug = {np.asarray(s.debug).round(3).tolist()}",
        f"\tPanic = {PANIC_REASON_NAMES.get(int(s.panic_reason), int(s.panic_reason))}",
        f"\tWarnings = {int(s.warnings):#04x}",
    ]
    return "\n".join(lines)
