"""Offboard state estimators (ground-station side).

Mocap estimator: jnp rewrite of Components/Components/Offboard/
MocapStateEstimator.{hpp,cpp}. Position and attitude are decoupled 2x2
Kalman filters per axis group; between measurements the estimate is
replayed forward using the *commanded* (acceleration, angular velocity)
stream delayed by the radio latency (the PredictionPipe, PredictionPipe.hpp
:33-70), which compensates the control loop's transport delay. Angular
velocity tracks commands through a first-order model with tau = 0.04 s.
Measurements are gated at 6 sigma; after 10 consecutive rejections the
filter force-resets and accepts.

The deque-based pipe becomes a fixed ring of commands with integer-us
activation times; the variable-length replay loop becomes a fixed sweep
over the ring slots with masked zero-length segments (every slot either
contributes its [activation, next-boundary) segment or integrates 0 s).
Faithfully kept quirks: the process noise enters the 2x2 Q un-squared
(sigma, not sigma^2 — cpp:208-216), and the attitude transition keeps
A = [[1, dt], [0, 1]] rather than the first-order-track discretization
(comment at cpp:211).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.ops import lin3
from agrifly_tpu.ops import rotation as rot


def _col(mask):
    """mask[..., None] as an int round-trip (value-identical spelling the
    golden traces pin)."""
    return mask.astype(jnp.int32)[..., None] != 0


def _pick(x, i):
    """x[i], with bool arrays picked through int32 (as _col)."""
    if x.dtype == jnp.bool_:
        return x.astype(jnp.int32)[i] != 0
    return x[i]


def _sweep(seg, carry, xs):
    """scan(seg, carry, xs) over the ring slots. unroll=2: a full unroll
    explodes CPU compile time."""
    return jax.lax.scan(seg, carry, xs, unroll=2)

# Steady-state pipe occupancy is ~(delay + horizon) * cmd_rate ~ 5 entries
# (clears run on every measurement update; push evicts the oldest when
# full), so 8 slots keep the replay sweep short. The reference's deque is
# unbounded but never holds more than this either.
PIPE_CAPACITY = 8
MAX_CONSECUTIVE_REJECT = 10
MEAS_REJECT_DIST = 6.0

# noise defaults (MocapStateEstimator.cpp:23-31)
MEAS_STD_POS = 0.02
MEAS_STD_ATT = 5.0 * jnp.pi / 180.0
PROC_STD_POS = 1.0 * 9.81
PROC_STD_ATT = 200.0
TAU_TRACK_ANGVEL = 0.04


class PredictionPipe(NamedTuple):
    """Ring of delayed (acc, angvel, ballistic) commands, ordered by time."""

    active_us: jnp.ndarray  # (K,) int32 activation time, monotone in ring order
    acc: jnp.ndarray  # (K, 3)
    angvel: jnp.ndarray  # (K, 3)
    ballistic: jnp.ndarray  # (K,) int32 0/1 (scalars stay bool)
    head: jnp.ndarray  # int32
    count: jnp.ndarray  # int32


def pipe_init() -> PredictionPipe:
    return PredictionPipe(
        active_us=jnp.zeros(PIPE_CAPACITY, jnp.int32),
        acc=jnp.zeros((PIPE_CAPACITY, 3), jnp.float32),
        angvel=jnp.zeros((PIPE_CAPACITY, 3), jnp.float32),
        ballistic=jnp.ones(PIPE_CAPACITY, jnp.int32),
        head=jnp.int32(0),
        count=jnp.int32(0),
    )


def pipe_push(p: PredictionPipe, now_us, delay_us, acc, angvel, ballistic, do_push):
    """AddMessage: activation = now + delay. Oldest entry is evicted if full
    (the reference deque grows unboundedly until ClearExpiredMessages; a
    PIPE_CAPACITY-deep ring covers > 70 ms of 100 Hz commands, beyond the replay
    horizon)."""
    full = p.count >= PIPE_CAPACITY
    # evict one from the head if full
    head = jnp.where(do_push & full, (p.head + 1) % PIPE_CAPACITY, p.head)
    count = jnp.where(do_push & full, p.count - 1, p.count)
    slot = (head + count) % PIPE_CAPACITY
    si = ((jnp.arange(PIPE_CAPACITY, dtype=jnp.int32) == slot).astype(jnp.int32)
          * jnp.asarray(do_push).astype(jnp.int32))  # one-hot, gather-free
    return PredictionPipe(
        active_us=p.active_us + si * ((now_us + delay_us) - p.active_us),
        acc=jnp.where(si[:, None] != 0,
                      jnp.asarray(acc, jnp.float32)[None, :], p.acc),
        angvel=jnp.where(si[:, None] != 0,
                         jnp.asarray(angvel, jnp.float32)[None, :], p.angvel),
        ballistic=p.ballistic + si * (jnp.asarray(ballistic).astype(jnp.int32)
                                      - p.ballistic),
        head=head,
        count=count + jnp.asarray(do_push).astype(jnp.int32),
    )


def _pipe_ordered(p: PredictionPipe):
    """Pipe contents in logical (push) order, gather-free.

    Uses a one-hot permutation matmul instead of index gathers: under vmap
    over thousands of envs, per-env gathers lower to scatter/gather ops
    that dominate the fused step, while the (K, K) masked sums stay
    elementwise. Returns (act_us (K,), acc (K,3), angvel (K,3),
    ballistic (K,)) with slots >= count pushed to act = 2^30.
    """
    idx = jnp.arange(PIPE_CAPACITY, dtype=jnp.int32)
    src = (p.head + idx) % PIPE_CAPACITY  # logical i comes from slot src[i]
    M = idx[None, :] == src[:, None]  # (K, K) one-hot rows
    Mi = M.astype(jnp.int32)
    act = (Mi * p.active_us[None, :]).sum(axis=1, dtype=jnp.int32)
    # masked sums, not matmuls (no reduced-precision matrix-unit passes)
    acc = jnp.where(_col(M), p.acc[None, :, :], 0.0).sum(1)
    angvel = jnp.where(_col(M), p.angvel[None, :, :], 0.0).sum(1)
    ball = (Mi * p.ballistic[None, :]).sum(axis=1, dtype=jnp.int32)  # int 0/1
    used = idx < p.count
    act = jnp.where(used, act, jnp.int32(2**30))
    return act, acc, angvel, ball


def pipe_clear_expired(p: PredictionPipe, t_us):
    """Drop leading entries whose successor is already active at t_us
    (ClearExpiredMessages: the newest active message always stays).

    Entries are pushed in increasing activation time, so the number of
    droppable leading entries is a masked max — no loop needed."""
    act, _, _, _ = _pipe_ordered(p)
    idx = jnp.arange(PIPE_CAPACITY, dtype=jnp.int32)
    # entry j-1 is droppable if entry j (its successor) is already active
    droppable = (idx >= 1) & (idx < p.count) & (act <= t_us)
    advance = jnp.where(droppable, idx, 0).max()
    return p._replace(
        head=((p.head + advance) % PIPE_CAPACITY).astype(jnp.int32),
        count=(p.count - advance).astype(jnp.int32),
    )


class MocapEstState(NamedTuple):
    initialized: jnp.ndarray  # bool
    pos: jnp.ndarray  # (3,)
    vel: jnp.ndarray  # (3,)
    att: jnp.ndarray  # (4,)
    angvel: jnp.ndarray  # (3,)
    var_pos: jnp.ndarray  # (2,2)
    var_att: jnp.ndarray  # (2,2)
    estimate_us: jnp.ndarray  # int32: time at which the estimate is valid
    us_since_good_meas: jnp.ndarray  # int32
    num_rejected: jnp.ndarray  # int32
    num_rejected_consec: jnp.ndarray  # int32
    pipe: PredictionPipe


def _reset_variance():
    return (
        jnp.array([[25.0, 0.0], [0.0, 25.0]], jnp.float32),
        jnp.array([[1.0, 0.0], [0.0, 400.0]], jnp.float32),
    )


def mocap_init(now_us=0) -> MocapEstState:
    vp, va = _reset_variance()
    return MocapEstState(
        initialized=jnp.bool_(False),
        pos=jnp.zeros(3, jnp.float32),
        vel=jnp.zeros(3, jnp.float32),
        att=rot.identity(),
        angvel=jnp.zeros(3, jnp.float32),
        var_pos=vp,
        var_att=va,
        estimate_us=jnp.int32(now_us),
        us_since_good_meas=jnp.int32(0),
        num_rejected=jnp.int32(0),
        num_rejected_consec=jnp.int32(0),
        pipe=pipe_init(),
    )


def _integrate_segment(pos, vel, att, angvel, acc, cmd_angvel, ballistic, dt,
                       v0=None, w0=None):
    """One piecewise-constant-command integration segment.

    Two reference flavors, kept bug-compatible:
      * prediction (GetPrediction, MocapStateEstimator.cpp:98-100): pos
        integrates with the FROZEN start-of-replay velocity `v0` (the
        member `_vel`, not the evolving est.vel) plus a half-acc term,
        and att with the FROZEN start angvel `w0` (`_angVel`);
      * update replay (UpdateWithMeasurement, cpp:165-175): pos
        integrates with the evolving velocity and NO acc term, att with
        the evolving angvel.  Pass v0=w0=None for this flavor.
    In both, vel integrates the commanded acc and angvel first-order
    tracks the commanded angvel with tau=0.04 s (frozen at 1 when the
    segment is ballistic).
    """
    if v0 is not None:
        new_pos = pos + v0 * dt + acc * (dt * dt * 0.5)
        new_att = rot.qmul(att, rot.from_rotation_vector(w0 * dt))
    else:
        new_pos = pos + vel * dt
        new_att = rot.qmul(att, rot.from_rotation_vector(angvel * dt))
    new_vel = vel + acc * dt
    c = jnp.exp(-dt / TAU_TRACK_ANGVEL)
    c = jnp.where(ballistic, 1.0, c)
    new_angvel = c * angvel + (1.0 - c) * cmd_angvel
    return new_pos, new_vel, new_att, new_angvel


def _replay(s: MocapEstState, t0_us, t1_us, update_variance, frozen=False):
    """Integrate the command stream from t0 to t1 (fixed sweep over slots),
    bug-compatible with the reference's segmentation.

    The C++ loop (MocapStateEstimator.cpp:80-118 / 139-196) asks the pipe
    for the newest message active at t; PredictionPipe::GetActiveMessage
    (PredictionPipe.hpp:33-52) returns that message's FULL window length
    (next activation - its own activation) as the valid prediction time —
    measured from its *activation*, not from t.  Consequences faithfully
    reproduced here: segments overshoot the next activation by the phase
    offset (t - activation) and keep integrating the stale command; when
    no message is active yet the replay runs ballistically ALL the way to
    t1 (predictionTime = 1e10), ignoring messages that activate inside
    (t, t1).  frozen=True selects the GetPrediction integration flavor
    (see _integrate_segment).

    The variance is carried as (p00, p01, p11) scalars, so each of the K
    short dependent segments is a few elementwise ops. Returns (pos, vel,
    att, angvel, var_pos, var_att).
    """
    pipe = s.pipe
    pos, vel, att, angvel = s.pos, s.vel, s.att, s.angvel
    var_pos, var_att = s.var_pos, s.var_att
    v0 = s.vel if frozen else None
    w0 = s.angvel if frozen else None

    act, accs, angvels, balls = _pipe_ordered(pipe)

    # variance carried as scalar (p00, p01, p11) triples: building 2x2
    # matrices per segment (eye().at.set, jnp.diag) lowers to scatters under
    # vmap and dominated the whole fused step; the closed form
    # A P A^T + Q for A = [[1, dt], [0, 1]], symmetric P is elementwise.
    def step_var(p00, p01, p11, proc, dt):
        # NB: reference uses sigma (not sigma^2) in Q — kept bug-compatible
        n00 = p00 + dt * (p01 + p01) + (dt * dt) * p11 + dt**4 * proc / 4.0
        n01 = p01 + dt * p11
        n11 = p11 + dt**2 * proc
        return n00, n01, n11

    vp = (var_pos[0, 0], var_pos[0, 1], var_pos[1, 1])
    va = (var_att[0, 0], var_att[0, 1], var_att[1, 1])

    t = jnp.maximum(t0_us, jnp.int32(0))
    t1 = t1_us
    HUGE = jnp.int32(2**30)

    # Sweep slots in push order.  Carry: has = a message window is live
    # (int 0/1), a_cur = its activation.  Per slot: if its
    # activation is still ahead, integrate the live window (full length
    # from a_cur, clipped to the remaining time — or ballistic to t1 when
    # nothing is live), then adopt the slot if t has now passed it.
    def seg(carry, x):
        act_i, acc_i, angvel_i, ball_i = x
        t, has, a_cur, pos, vel, att, angvel, cur, vp, va = carry
        cur_acc, cur_angvel, cur_ball = cur
        remaining = jnp.maximum(t1 - t, 0)
        window = jnp.where(has != 0, act_i - a_cur, HUGE)
        dt_us = jnp.where(act_i <= t, 0, jnp.minimum(remaining, window))
        dt = dt_us.astype(jnp.float32) * 1e-6
        pos, vel, att, angvel = _integrate_segment(
            pos, vel, att, angvel, cur_acc, cur_angvel, cur_ball, dt, v0, w0
        )
        if update_variance:
            vp = step_var(*vp, PROC_STD_POS, dt)
            va = step_var(*va, PROC_STD_ATT, dt)
        t = t + dt_us
        adopt = act_i <= t
        cur_acc = jnp.where(adopt, acc_i, cur_acc)
        cur_angvel = jnp.where(adopt, angvel_i, cur_angvel)
        cur_ball = jnp.where(adopt, ball_i != 0, cur_ball)
        a_cur = jnp.where(adopt, act_i, a_cur)
        has = jnp.maximum(has, adopt.astype(jnp.int32))
        return (t, has, a_cur, pos, vel, att, angvel,
                (cur_acc, cur_angvel, cur_ball), vp, va), None

    cur = (jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32), jnp.bool_(True))
    carry = (t, jnp.int32(0), jnp.int32(0), pos, vel, att, angvel, cur, vp, va)
    carry, _ = _sweep(seg, carry, (act, accs, angvels, balls))
    t, _, _, pos, vel, att, angvel, cur, vp, va = carry
    cur_acc, cur_angvel, cur_ball = cur

    # final segment to t1 (the live window's prediction time is unbounded
    # once it is the newest message: tLastMsg = 1e10, PredictionPipe.hpp:38)
    dt = jnp.maximum(t1 - t, 0).astype(jnp.float32) * 1e-6
    pos, vel, att, angvel = _integrate_segment(
        pos, vel, att, angvel, cur_acc, cur_angvel, cur_ball, dt, v0, w0
    )
    if update_variance:
        vp = step_var(*vp, PROC_STD_POS, dt)
        va = step_var(*va, PROC_STD_ATT, dt)
    var_pos = jnp.stack(
        [jnp.stack([vp[0], vp[1]]), jnp.stack([vp[1], vp[2]])]
    )
    var_att = jnp.stack(
        [jnp.stack([va[0], va[1]]), jnp.stack([va[1], va[2]])]
    )
    return pos, vel, att, angvel, var_pos, var_att


def mocap_set_predicted_values(s: MocapEstState, now_us, delay_us, cmd_angvel,
                               cmd_acc, do_push=True) -> MocapEstState:
    pipe = pipe_push(
        s.pipe, now_us, delay_us, cmd_acc, cmd_angvel, jnp.bool_(False),
        jnp.bool_(do_push),
    )
    return s._replace(pipe=pipe)


def mocap_get_prediction(s: MocapEstState, now_us, latency_us):
    """Forward-simulate the latency: estimate at now + latency (cpp:61-118)."""
    t1 = now_us + latency_us
    pos, vel, att, angvel, _, _ = _replay(s, s.estimate_us, t1,
                                          update_variance=False, frozen=True)
    return pos, vel, att, angvel


def mocap_update(s: MocapEstState, now_us, meas_pos, meas_att, dt_advance_us) -> MocapEstState:
    """UpdateWithMeasurement: replay pipe to `now`, 6-sigma gate, 2x2 KF
    corrections, force-accept+reset after 10 straight rejections.

    dt_advance_us: microseconds since the previous call (advances the
    "time since good measurement" clock).
    """
    meas_pos = jnp.asarray(meas_pos, jnp.float32)
    meas_att = jnp.asarray(meas_att, jnp.float32)
    # ---------- uninitialized: adopt the measurement ----------
    # NB the adoption branch does NOT touch the estimate timestamp
    # (UpdateWithMeasurement's init path never resets _estimateTimer,
    # cpp:120-133 — only Reset() does), so the next update replays from
    # the construction/Reset time, integrating extra variance. Bug-
    # compatible: setting estimate_us=now_us here leaves a ~1e-3-relative
    # variance wake that shows up as mrad-level command divergence vs the
    # C++ golden traces.
    vp0, va0 = _reset_variance()
    s_uninit = s._replace(
        initialized=jnp.bool_(True),
        pos=meas_pos, vel=jnp.zeros(3, jnp.float32),
        att=meas_att, angvel=jnp.zeros(3, jnp.float32),
        var_pos=vp0, var_att=va0,
        us_since_good_meas=jnp.int32(0),
    )

    # ---------- replay to now ----------
    pos, vel, att, angvel, var_pos, var_att = _replay(
        s, s.estimate_us, now_us, update_variance=True
    )

    innov_pos = var_pos[0, 0] + MEAS_STD_POS**2
    innov_att = var_att[0, 0] + MEAS_STD_ATT**2
    dist_pos = jnp.linalg.norm(meas_pos - pos) / jnp.sqrt(3.0 * innov_pos)
    dist_att = rot.get_angle(rot.qmul(rot.qinv(meas_att), att)) / jnp.sqrt(innov_att)
    should_reject = (dist_pos > MEAS_REJECT_DIST) | (dist_att > MEAS_REJECT_DIST)
    force_accept = s.num_rejected_consec >= MAX_CONSECUTIVE_REJECT
    reject = should_reject & ~force_accept

    # force-accept resets variance (and pos/vel/att via Reset + re-init path);
    # reference Reset() zeroes the state then the gain update pulls it to the
    # measurement from zero. Keep that: state zeroed pre-update on force-accept.
    vp_r, va_r = _reset_variance()
    pos_u = jnp.where(force_accept, jnp.zeros(3, jnp.float32), pos)
    vel_u = jnp.where(force_accept, jnp.zeros(3, jnp.float32), vel)
    att_u = jnp.where(force_accept, rot.identity(), att)
    angvel_u = jnp.where(force_accept, jnp.zeros(3, jnp.float32), angvel)
    var_pos_u = jnp.where(force_accept, vp_r, var_pos)
    var_att_u = jnp.where(force_accept, va_r, var_att)
    innov_pos = var_pos_u[0, 0] + MEAS_STD_POS**2
    innov_att = var_att_u[0, 0] + MEAS_STD_ATT**2

    gain_pos = var_pos_u[:, 0] / innov_pos  # (2,)
    gain_att = var_att_u[:, 0] / innov_att

    err_pos = meas_pos - pos_u
    new_pos = pos_u + gain_pos[0] * err_pos
    new_vel = vel_u + gain_pos[1] * err_pos

    err_att = rot.to_rotation_vector(rot.qmul(rot.qinv(att_u), meas_att))
    new_att = rot.qmul(att_u, rot.from_rotation_vector(gain_att[0] * err_att))
    new_angvel = angvel_u + gain_att[1] * err_att

    IKH_pos = jnp.eye(2, dtype=jnp.float32) - jnp.outer(gain_pos, jnp.array([1.0, 0.0], jnp.float32))
    IKH_att = jnp.eye(2, dtype=jnp.float32) - jnp.outer(gain_att, jnp.array([1.0, 0.0], jnp.float32))
    # 2x2 products as broadcast-sums (full f32: tiny dot_generals may run
    # in reduced precision on matrix units)
    new_var_pos = (IKH_pos[:, :, None] * var_pos_u[None, :, :]).sum(1)
    new_var_att = (IKH_att[:, :, None] * var_att_u[None, :, :]).sum(1)

    # select accept vs reject branch
    pick = lambda a, r: jnp.where(reject, r, a)
    pos_f = pick(new_pos, pos)
    vel_f = pick(new_vel, vel)
    att_f = pick(new_att, att)
    angvel_f = pick(new_angvel, angvel)
    var_pos_f = pick(new_var_pos, var_pos)
    var_att_f = pick(new_var_att, var_att)
    num_rej = s.num_rejected + reject.astype(jnp.int32)
    num_consec = jnp.where(reject, s.num_rejected_consec + 1, jnp.int32(0))
    since_good = jnp.where(
        reject,
        jnp.minimum(s.us_since_good_meas + dt_advance_us, 2**30).astype(jnp.int32),
        jnp.int32(0),
    )

    # symmetrize
    var_pos_f = 0.5 * (var_pos_f + var_pos_f.T)
    var_att_f = 0.5 * (var_att_f + var_att_f.T)

    pipe = pipe_clear_expired(s.pipe, now_us)
    # Force-accept calls Reset(), which leaves _initialized = false — so the
    # NEXT measurement re-initializes by adoption (cpp:218-227 + Reset()).
    s_init = MocapEstState(
        initialized=~force_accept,
        pos=pos_f, vel=vel_f, att=att_f, angvel=angvel_f,
        var_pos=var_pos_f, var_att=var_att_f,
        estimate_us=now_us, us_since_good_meas=since_good,
        num_rejected=num_rej, num_rejected_consec=num_consec,
        pipe=pipe,
    )
    return jax.tree_util.tree_map(
        lambda i, u: jnp.where(s.initialized, i, u), s_init, s_uninit
    )


# =============================================================================
# GPS-IMU estimator (Offboard/GPSIMUStateEstimator.{hpp,cpp})
# =============================================================================
#
# Structurally the onboard EKF driven by IMU Predict() plus a 3-D GPS
# position update; no complementary-filter phase (full EKF from the second
# Predict on). Constants: init std 3 m / 3 m/s / 10 deg, accel noise 5,
# gyro noise 0.1, GPS position noise 0.25 m. A singular or non-finite 3x3
# innovation covariance bails out by adopting the measurement and resetting
# the variance (cpp:230-244).

from agrifly_tpu.models import ekf as _ekf

GPSIMU_INIT_STD = (3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
                   10.0 * jnp.pi / 180.0, 10.0 * jnp.pi / 180.0, 10.0 * jnp.pi / 180.0)
GPSIMU_NOISE_ACC = 5.0
GPSIMU_NOISE_GYRO = 0.1
GPS_MEAS_STD_POS = 0.25


def gpsimu_init() -> _ekf.EkfState:
    s = _ekf.init_state()
    return s._replace(cov=jnp.diag(jnp.asarray(GPSIMU_INIT_STD, jnp.float32) ** 2))


def gpsimu_predict(s: _ekf.EkfState, acc, gyro, dt) -> _ekf.EkfState:
    return _ekf.predict(
        s, gyro, acc, dt,
        noise_std_acc=GPSIMU_NOISE_ACC, noise_std_gyro=GPSIMU_NOISE_GYRO,
        init_cov_diag=GPSIMU_INIT_STD, uwb_init_at_reset=True,
    )


def gps_position_update(s: _ekf.EkfState, meas_pos, apply,
                        meas_std=GPS_MEAS_STD_POS,
                        init_std=GPSIMU_INIT_STD) -> _ekf.EkfState:
    """3-D position measurement update shared by GPSIMU/GPS estimators.

    H = [I3 0 0]; on singular/non-finite innovation covariance the filter
    adopts the measurement and resets the variance (reference bailout).
    """
    apply = jnp.asarray(apply)
    meas_pos = jnp.asarray(meas_pos, jnp.float32)

    P = s.cov
    S = P[0:3, 0:3] + (meas_std**2) * jnp.eye(3, dtype=jnp.float32)
    det = lin3.det3(S)
    bad = (jnp.abs(det) < 1e-10) | ~jnp.all(jnp.isfinite(S))

    S_safe = jnp.where(bad, jnp.eye(3, dtype=jnp.float32), S)
    # (9,3)/(3,3)/(3,9) products as broadcast-sums: batched tiny matmuls
    # may run in reduced precision on matrix units under vmap
    L = (P[:, 0:3, None] * lin3.inv3(S_safe)[None, :, :]).sum(1)  # (9,3)
    dx = (L * (meas_pos - s.pos)[None, :]).sum(1)
    att_corr = dx[6:9]
    # (I - L H) P with H = [I3 0 0] = P minus a rank-3 update:
    cov_new = P - (L[:, :, None] * P[None, 0:3, :]).sum(1)
    cov_new = 0.5 * (cov_new + cov_new.T)

    s_upd = s._replace(
        pos=s.pos + dx[0:3],
        vel=s.vel + dx[3:6],
        att=rot.qmul(s.att, rot.from_rotation_vector(att_corr)),
        last_att_corr=att_corr,
        cov=cov_new,
        uwb_init=jnp.bool_(True),
    )

    # singular bailout: adopt measurement, reset variance
    s_bail = s._replace(
        pos=meas_pos,
        vel=jnp.zeros(3, jnp.float32),
        att=rot.identity(),
        angvel=jnp.zeros(3, jnp.float32),
        cov=jnp.diag(jnp.asarray(init_std, jnp.float32) ** 2),
        last_att_corr=jnp.zeros(3, jnp.float32),
    )

    # first measurement while uninitialized: adopt it
    s_first = s_bail._replace(imu_init=jnp.bool_(True), uwb_init=jnp.bool_(True))

    out = jax.tree_util.tree_map(lambda u, b: jnp.where(bad, b, u), s_upd, s_bail)
    out = jax.tree_util.tree_map(lambda o, f: jnp.where(s.imu_init, o, f), out, s_first)
    return jax.tree_util.tree_map(lambda o, old: jnp.where(apply, o, old), out, s)


# =============================================================================
# GPS estimator (Offboard/GPSStateEstimator.{hpp,cpp})
# =============================================================================
#
# 9-state KF driven by the *commanded* accelerations from the prediction
# pipe (no IMU): replay segments propagate both the mean and the full 9x9
# covariance using the attitude-correction Jacobian evaluated at the
# nominal body-frame proper acceleration (cpp:146-270); position-only 3-D
# update with the same singular bailout. No Mahalanobis gating.

GPS_INIT_STD = (0.5, 0.5, 0.5, 0.2, 0.2, 0.2,
                5.0 * jnp.pi / 180.0, 5.0 * jnp.pi / 180.0, 5.0 * jnp.pi / 180.0)
GPS_PROC_STD_ACC = 1.06
GPS_PROC_STD_ANGVEL = 0.1


class GpsEstState(NamedTuple):
    initialized: jnp.ndarray
    pos: jnp.ndarray
    vel: jnp.ndarray
    att: jnp.ndarray
    angvel: jnp.ndarray
    cov: jnp.ndarray  # (9,9)
    last_att_corr: jnp.ndarray
    estimate_us: jnp.ndarray
    us_since_good_meas: jnp.ndarray
    pipe: PredictionPipe


def gps_init(now_us=0) -> GpsEstState:
    return GpsEstState(
        initialized=jnp.bool_(False),
        pos=jnp.zeros(3, jnp.float32),
        vel=jnp.zeros(3, jnp.float32),
        att=rot.identity(),
        angvel=jnp.zeros(3, jnp.float32),
        cov=jnp.diag(jnp.asarray(GPS_INIT_STD, jnp.float32) ** 2),
        last_att_corr=jnp.zeros(3, jnp.float32),
        estimate_us=jnp.int32(now_us),
        us_since_good_meas=jnp.int32(0),
        pipe=pipe_init(),
    )


def gps_set_predicted_values(s: GpsEstState, now_us, delay_us, cmd_angvel,
                             cmd_acc, do_push=True) -> GpsEstState:
    pipe = pipe_push(s.pipe, now_us, delay_us, cmd_acc, cmd_angvel,
                     jnp.bool_(False), jnp.bool_(do_push))
    return s._replace(pipe=pipe)


def _gps_cov_segment(cov, last_att_corr, att, angvel, cmd_acc, dt):
    """9x9 covariance propagation for one replay segment (cpp:187-268)."""
    nom_acc = rot.rotate_back(att, cmd_acc + jnp.array([0.0, 0.0, 9.81], jnp.float32))
    R = rot.to_matrix(att)
    ax, ay, az = nom_acc[0], nom_acc[1], nom_acc[2]
    dva = dt * lin3.assemble_cols3(
        ay * R[:, 2] - az * R[:, 1],
        -ax * R[:, 2] + az * R[:, 0],
        ax * R[:, 1] - ay * R[:, 0],
    )
    g = angvel * dt + last_att_corr / 2.0
    return _ekf.cov_predict_block(
        cov, dt, dva, g,
        GPS_PROC_STD_ACC**2 * dt * dt, GPS_PROC_STD_ANGVEL**2 * dt * dt,
    )


def _gps_replay(s: GpsEstState, t0_us, t1_us, update_cov, frozen=False):
    """Replay the command pipe from t0 to t1 for the GPS estimator.

    Same bug-compatible segmentation as the mocap `_replay` (the C++ GPS
    estimator shares PredictionPipe and the identical loop structure,
    GPSStateEstimator.cpp:60-128/143-196): segments run the active
    message's FULL window measured from its activation, and a replay with
    no active message runs ballistically to t1.  frozen=True selects the
    GetPrediction flavor (frozen `_vel`/`_angVel` in pos/att, cpp:108-110).
    """
    pipe = s.pipe
    act, accs, angvels, balls = _pipe_ordered(pipe)
    v0 = s.vel if frozen else None
    w0 = s.angvel if frozen else None
    HUGE = jnp.int32(2**30)
    t1 = t1_us

    def seg(carry, x):
        act_i, acc_i, angvel_i, ball_i = x
        t, has, a_cur, pos, vel, att, angvel, cur, cov, lac = carry
        cur_acc, cur_angvel, cur_ball = cur
        remaining = jnp.maximum(t1 - t, 0)
        window = jnp.where(has != 0, act_i - a_cur, HUGE)
        dt_us = jnp.where(act_i <= t, 0, jnp.minimum(remaining, window))
        dt = dt_us.astype(jnp.float32) * 1e-6
        pos, vel, att, angvel = _integrate_segment(
            pos, vel, att, angvel, cur_acc, cur_angvel, cur_ball, dt, v0, w0
        )
        if update_cov:
            # reference order: mean first, Jacobian from the NEW att/angvel
            # (GPSStateEstimator.cpp:167-187 update _att/_angVel, then
            # nomAcc/rotMat/f read the members)
            cov2 = _gps_cov_segment(cov, lac, att, angvel, cur_acc, dt)
            nz = dt > 0
            cov = jnp.where(nz, cov2, cov)
            lac = jnp.where(nz, jnp.zeros(3, jnp.float32), lac)
        t = t + dt_us
        adopt = act_i <= t
        cur = (
            jnp.where(adopt, acc_i, cur_acc),
            jnp.where(adopt, angvel_i, cur_angvel),
            jnp.where(adopt, ball_i != 0, cur_ball),
        )
        a_cur = jnp.where(adopt, act_i, a_cur)
        has = jnp.maximum(has, adopt.astype(jnp.int32))
        return (t, has, a_cur, pos, vel, att, angvel, cur, cov, lac), None

    cur = (jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32), jnp.bool_(True))
    carry = (jnp.maximum(t0_us, 0).astype(jnp.int32), jnp.int32(0), jnp.int32(0),
             s.pos, s.vel, s.att, s.angvel, cur, s.cov, s.last_att_corr)
    carry, _ = _sweep(seg, carry, (act, accs, angvels, balls))
    t, _, _, pos, vel, att, angvel, cur, cov, lac = carry
    cur_acc, cur_angvel, cur_ball = cur
    dt = jnp.maximum(t1_us - t, 0).astype(jnp.float32) * 1e-6
    pos, vel, att, angvel = _integrate_segment(
        pos, vel, att, angvel, cur_acc, cur_angvel, cur_ball, dt, v0, w0
    )
    if update_cov:
        cov2 = _gps_cov_segment(cov, lac, att, angvel, cur_acc, dt)
        nz = dt > 0
        cov = jnp.where(nz, cov2, cov)
        lac = jnp.where(nz, jnp.zeros(3, jnp.float32), lac)
    return pos, vel, att, angvel, cov, lac


def gps_get_prediction(s: GpsEstState, now_us, latency_us):
    t1 = now_us + latency_us
    pos, vel, att, angvel, _, _ = _gps_replay(s, s.estimate_us, t1,
                                              update_cov=False, frozen=True)
    return pos, vel, att, angvel


def gps_update(s: GpsEstState, now_us, meas_pos, dt_advance_us) -> GpsEstState:
    """GPS position update: replay + 3-D KF correction + singular bailout."""
    meas_pos = jnp.asarray(meas_pos, jnp.float32)
    # uninitialized: adopt measurement
    s_uninit = s._replace(
        initialized=jnp.bool_(True),
        pos=meas_pos, vel=jnp.zeros(3, jnp.float32),
        att=rot.identity(), angvel=jnp.zeros(3, jnp.float32),
        cov=jnp.diag(jnp.asarray(GPS_INIT_STD, jnp.float32) ** 2),
        estimate_us=now_us, us_since_good_meas=jnp.int32(0),
    )

    pos, vel, att, angvel, cov, lac = _gps_replay(s, s.estimate_us, now_us, update_cov=True)

    S = cov[0:3, 0:3] + (GPS_MEAS_STD_POS**2) * jnp.eye(3, dtype=jnp.float32)
    det = lin3.det3(S)
    bad = (jnp.abs(det) < 1e-10) | ~jnp.all(jnp.isfinite(S))
    S_safe = jnp.where(bad, jnp.eye(3, dtype=jnp.float32), S)
    L = (cov[:, 0:3, None] * lin3.inv3(S_safe)[None, :, :]).sum(1)
    dx = (L * (meas_pos - pos)[None, :]).sum(1)
    att_corr = dx[6:9]
    cov_new = cov - (L[:, :, None] * cov[None, 0:3, :]).sum(1)
    cov_new = 0.5 * (cov_new + cov_new.T)

    s_upd = s._replace(
        pos=pos + dx[0:3], vel=vel + dx[3:6],
        att=rot.qmul(att, rot.from_rotation_vector(att_corr)),
        angvel=angvel, cov=cov_new, last_att_corr=att_corr,
        estimate_us=now_us, us_since_good_meas=jnp.int32(0),
        pipe=pipe_clear_expired(s.pipe, now_us),
    )
    s_bail = s._replace(
        pos=meas_pos, vel=jnp.zeros(3, jnp.float32),
        att=rot.identity(), angvel=jnp.zeros(3, jnp.float32),
        cov=jnp.diag(jnp.asarray(GPS_INIT_STD, jnp.float32) ** 2),
        last_att_corr=jnp.zeros(3, jnp.float32),
        estimate_us=now_us, us_since_good_meas=jnp.int32(0),
    )
    out = jax.tree_util.tree_map(lambda u, b: jnp.where(bad, b, u), s_upd, s_bail)
    return jax.tree_util.tree_map(
        lambda i, u: jnp.where(s.initialized, i, u), out, s_uninit
    )
