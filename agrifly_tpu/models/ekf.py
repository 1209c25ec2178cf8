"""Onboard 9-state EKF (pos, vel, attitude-correction rotation vector).

JAX rewrite of the reference onboard filter (Components/Components/Logic/
KalmanFilter6DOF.{hpp,cpp}), which implements Mueller's "Covariance
correction step for Kalman filtering with an attitude". Behaviors kept:
  - accelerometer-aligned attitude init on the first Predict (cpp:71-108)
  - complementary-filter attitude mode until the first UWB fix, with a 4 s
    correction time constant (cpp:114-147)
  - full mean propagation + 9x9 Jacobian + process noise afterwards
  - scalar range update with 3-sigma Mahalanobis gating and a hard reset
    after 5 sequential rejections (cpp:243-301)
  - covariance symmetrization copying the lower triangle up (cpp:303-309)

All branches are computed and blended with `where` so the filter vmaps over
thousands of vehicles without divergence; the 9x9 covariance product is
block-sparse elementwise work (cov_predict_block).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.ops import lin3
from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.ops import trig

TIME_CONST_ATT_CORR = 4.0  # [s]

# filter constants (KalmanFilter6DOF.cpp:14-27)
INIT_STD_POS = 3.0
INIT_STD_VEL = 3.0
INIT_STD_ATT_PERP = 10.0 * jnp.pi / 180.0
INIT_STD_ATT_GRAV = 30.0 * jnp.pi / 180.0
NOISE_STD_ACC = 5.0
NOISE_STD_GYRO = 0.1
NOISE_STD_RANGE = 0.14
OUTLIER_STAT_DIST = 3.0
MAX_SEQ_REJECT = 5


class EkfState(NamedTuple):
    pos: jnp.ndarray  # (3,)
    vel: jnp.ndarray  # (3,)
    att: jnp.ndarray  # (4,) quaternion
    angvel: jnp.ndarray  # (3,)
    cov: jnp.ndarray  # (9, 9)
    imu_init: jnp.ndarray  # bool
    uwb_init: jnp.ndarray  # bool
    last_att_corr: jnp.ndarray  # (3,)
    num_rejected: jnp.ndarray  # int32
    num_rejected_seq: jnp.ndarray  # int32
    num_resets: jnp.ndarray  # int32


def _init_cov():
    d = jnp.array(
        [INIT_STD_POS] * 3 + [INIT_STD_VEL] * 3
        + [INIT_STD_ATT_PERP, INIT_STD_ATT_PERP, INIT_STD_ATT_GRAV],
        jnp.float32,
    )
    return lin3.diag_from(d * d)


def init_state() -> EkfState:
    return EkfState(
        pos=jnp.zeros(3, jnp.float32),
        vel=jnp.zeros(3, jnp.float32),
        att=rot.identity(),
        angvel=jnp.zeros(3, jnp.float32),
        cov=_init_cov(),
        imu_init=jnp.bool_(False),
        uwb_init=jnp.bool_(False),
        last_att_corr=jnp.zeros(3, jnp.float32),
        num_rejected=jnp.int32(0),
        num_rejected_seq=jnp.int32(0),
        num_resets=jnp.int32(0),
    )


def _reset(s: EkfState) -> EkfState:
    fresh = init_state()
    return fresh._replace(
        num_resets=s.num_resets + 1,
        num_rejected=s.num_rejected,
    )


def _mm3(M, N):
    """3x3 matmul as a broadcast-sum: keeps tiny per-env matrices in
    elementwise f32 instead of a batched dot_general under vmap (which
    may run in reduced precision on matrix units)."""
    return (M[..., :, :, None] * N[..., None, :, :]).sum(-2)


def _skew_mul(g, M):
    """skew(g) @ M for skew rows [0,g2,-g1; -g2,0,g0; g1,-g0,0], i.e.
    each column c -> c x g — pure elementwise cross products."""
    return jnp.cross(M, g[..., None, :], axisa=-2, axisb=-1, axisc=-2)


def cov_predict_block(P, dt, A, g, q_vel, q_att):
    """F P F^T + diag(0, q_vel, q_att) for the EKF transition
    F = [[I, dt I, 0], [0, I, A], [0, 0, I + skew(g)]] (9x9, 3x3 blocks).

    Exploits the block sparsity: the only true matmuls are four 3x3
    products with A; multiplication by D = I + skew(g) is cross products.
    Cheaper than the dense f @ P @ f.T at fleet sizes, and full f32
    without a precision pin (a dense batched 9x9 matmul may run in
    reduced precision on matrix units).
    Broadcasts over leading axes. q_vel/q_att are scalar diagonal noise
    entries (already including dt^2).
    """
    P11 = P[..., 0:3, 0:3]; P12 = P[..., 0:3, 3:6]; P13 = P[..., 0:3, 6:9]
    P22 = P[..., 3:6, 3:6]; P23 = P[..., 3:6, 6:9]; P33 = P[..., 6:9, 6:9]
    tr = lambda M: jnp.swapaxes(M, -1, -2)

    FP11 = P11 + dt * tr(P12)
    FP12 = P12 + dt * P22
    FP13 = P13 + dt * P23
    FP22 = P22 + _mm3(A, tr(P23))
    FP23 = P23 + _mm3(A, P33)
    DP33 = P33 + _skew_mul(g, P33)

    At = tr(A)
    mDt = lambda M: M + tr(_skew_mul(g, tr(M)))  # M @ D^T
    N11 = FP11 + dt * FP12
    N12 = FP12 + _mm3(FP13, At)
    N13 = mDt(FP13)
    N22 = FP22 + _mm3(FP23, At)
    N23 = mDt(FP23)
    N33 = mDt(DP33)

    eye3 = jnp.eye(3, dtype=P.dtype)
    top = jnp.concatenate([N11, N12, N13], axis=-1)
    mid = jnp.concatenate([tr(N12), N22 + q_vel * eye3, N23], axis=-1)
    bot = jnp.concatenate([tr(N13), tr(N23), N33 + q_att * eye3], axis=-1)
    return jnp.concatenate([top, mid, bot], axis=-2)


def _gravity_align_correction(att, meas_acc, gain=1.0):
    """Rotation nudging the attitude so predicted gravity matches measAcc."""
    exp_acc = rot.rotate_back(att, jnp.array([0.0, 0.0, 1.0], att.dtype))
    norm = jnp.linalg.norm(meas_acc)
    acc_unit = meas_acc / jnp.where(norm < 1e-12, 1.0, norm)
    ax = jnp.cross(acc_unit, exp_acc)
    n = jnp.linalg.norm(ax)
    ax = jnp.where(n > 1e-6, ax / jnp.where(n > 1e-6, n, 1.0),
                   jnp.array([1.0, 0.0, 0.0], att.dtype))
    cos_err = jnp.clip((exp_acc * acc_unit).sum(-1), -1.0, 1.0)
    angle = trig.acos(cos_err)
    return rot.qmul(att, rot.from_axis_angle(ax, gain * angle))


def predict(s: EkfState, gyro, acc, dt, *, noise_std_acc=NOISE_STD_ACC,
            noise_std_gyro=NOISE_STD_GYRO, init_cov_diag=None,
            uwb_init_at_reset=False) -> EkfState:
    """One prediction step; blends the three lifecycle phases with selects.

    The keyword knobs let the offboard GPS-IMU estimator (same structure,
    double-precision in the reference, different constants, no
    complementary phase) reuse this kernel.
    """
    dt = jnp.float32(dt)

    # --- phase A: first-ever IMU sample -> reset + gravity-aligned attitude
    sA = _reset(s)
    if init_cov_diag is not None:
        sA = sA._replace(cov=lin3.diag_from(jnp.asarray(init_cov_diag, jnp.float32) ** 2))
    if uwb_init_at_reset:
        sA = sA._replace(uwb_init=jnp.bool_(True))
    sA = sA._replace(imu_init=jnp.bool_(True), att=_gravity_align_correction(sA.att, acc))

    # --- phase B: complementary attitude until the first UWB fix
    attB = rot.qmul(s.att, rot.from_rotation_vector(gyro * dt))
    attB = _gravity_align_correction(attB, acc, gain=dt / TIME_CONST_ATT_CORR)
    sB = s._replace(att=attB, angvel=gyro)

    # --- phase C: full EKF prediction
    acc_w = rot.rotate(s.att, acc) + jnp.array([0.0, 0.0, -9.81], jnp.float32)
    posC = s.pos + s.vel * dt
    velC = s.vel + acc_w * dt
    attC = rot.qmul(s.att, rot.from_rotation_vector(gyro * dt))

    R = rot.to_matrix(s.att)
    ax, ay, az = acc[0], acc[1], acc[2]
    # d(vel)/d(att): dt * R [a]_x structure (KalmanFilter6DOF.cpp:176-204);
    # columns assembled by masked sum
    dva = dt * lin3.assemble_cols3(
        ay * R[:, 2] - az * R[:, 1],
        -ax * R[:, 2] + az * R[:, 0],
        ax * R[:, 1] - ay * R[:, 0],
    )  # (3 rows: vel) x (3 cols: att)
    g = gyro * dt + s.last_att_corr / 2.0
    covC = cov_predict_block(
        s.cov, dt, dva, g,
        noise_std_acc**2 * dt * dt, noise_std_gyro**2 * dt * dt,
    )
    sC = s._replace(
        pos=posC, vel=velC, att=attC, angvel=gyro, cov=covC,
        last_att_corr=jnp.zeros(3, jnp.float32),
    )

    # --- select phase
    def sel(b_or_c, a):
        return jax.tree_util.tree_map(
            lambda x, y: jnp.where(s.imu_init, x, y), b_or_c, a
        )

    sBC = jax.tree_util.tree_map(
        lambda b, c: jnp.where(s.uwb_init, c, b), sB, sC
    )
    return sel(sBC, sA)


def update_range(s: EkfState, target_pos, meas_range, apply) -> EkfState:
    """Scalar UWB range update with Mahalanobis gating.

    `apply` is a traced bool: when False the state passes through unchanged
    (used for steps without a fresh measurement).
    """
    apply = apply & s.imu_init & jnp.isfinite(meas_range)

    # the reference marks UWB as initialized before gating (cpp:252), so even
    # a rejected measurement flips the filter into full-EKF mode
    s = s._replace(uwb_init=s.uwb_init | apply)

    diff = s.pos - target_pos
    expected = jnp.linalg.norm(diff)
    safe_exp = jnp.where(expected < 1e-12, 1.0, expected)
    h = diff / safe_exp  # dR/dpos; zeros for vel/att

    H = jnp.concatenate([h, jnp.zeros(6, jnp.float32)])
    # matvec/dot as masked sums (full f32 on every backend)
    PHt = (s.cov * H[None, :]).sum(1)
    innov_cov = (H * PHt).sum() + NOISE_STD_RANGE**2
    L = PHt / innov_cov
    innov = meas_range - expected

    maha_sq = innov * innov / innov_cov
    reject = maha_sq > OUTLIER_STAT_DIST**2

    # accepted-update branch
    dx = L * innov
    att_corr = dx[6:9]
    s_acc = s._replace(
        pos=s.pos + dx[0:3],
        vel=s.vel + dx[3:6],
        att=rot.qmul(s.att, rot.from_rotation_vector(att_corr)),
        last_att_corr=att_corr,
        num_rejected_seq=jnp.int32(0),
    )
    # (I - L H) P = P - outer(L, H P); H P = (P H^T)^T = PHt^T (P symmetric)
    # — a rank-1 elementwise update, not a 9x9 matmul
    cov_new = s.cov - L[:, None] * PHt[None, :]
    # symmetrize by copying the lower triangle up (cpp:303-309)
    cov_new = jnp.tril(cov_new) + jnp.tril(cov_new, -1).T
    s_acc = s_acc._replace(cov=cov_new)

    # rejected branch: count, maybe hard-reset
    nseq = s.num_rejected_seq + 1
    s_rej = s._replace(num_rejected=s.num_rejected + 1, num_rejected_seq=nseq)
    do_reset = nseq >= MAX_SEQ_REJECT
    s_rej = jax.tree_util.tree_map(
        lambda r, f: jnp.where(do_reset, f, r), s_rej, _reset(s_rej)
    )

    out = jax.tree_util.tree_map(
        lambda a, r: jnp.where(reject, r, a), s_acc, s_rej
    )
    return jax.tree_util.tree_map(lambda o, old: jnp.where(apply, o, old), out, s)
