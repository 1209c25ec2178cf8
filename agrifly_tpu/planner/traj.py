"""Closed-form minimum-jerk motion primitives, fully batched.

JAX rewrite of the Mueller rapid-trajectory generator (Components/
TrajectoryGenerator/SingleAxisTrajectory.{hpp,cpp} and
RapidTrajectoryGenerator.{hpp,cpp}). A "trajectory" is a pytree of arrays
(alpha, beta, gamma, a0, v0, p0, tf) with arbitrary leading batch axes, so
thousands of RAPPIDS candidates are generated/checked in one fused pass.

Redesigns vs the C++:
  * the 8 goal-constraint cases are computed branch-free and selected by
    the (pos, vel, acc)-defined mask;
  * the recursive input-feasibility bisection (RapidTrajectoryGenerator
    .cpp:75-161) becomes a fixed-depth dyadic sweep: all 2^k sections at
    levels k = 0..L are tested in parallel and the adaptive tree's verdict
    is reproduced by propagating "needs split" masks level by level — a
    section splits only when its parent did, and a needed section narrower
    than minTimeSection reproduces the InputIndeterminable verdict.
  * velocity/position feasibility use the branch-free quartic/cubic root
    kernels with validity masks (ops.rootfind).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.ops import trig  # noqa: F401 (omega acos)
from agrifly_tpu.ops import rootfind

# feasibility verdict codes (RapidTrajectoryGenerator.hpp:74-86)
FEASIBLE = 0
INDETERMINABLE = 1
INFEASIBLE_THRUST_HIGH = 2
INFEASIBLE_THRUST_LOW = 3
STATE_FEASIBLE = 0
STATE_INFEASIBLE = 1


class Traj(NamedTuple):
    """Per-axis quintic: p(t) = p0 + v0 t + a0 t^2/2 + g t^3/6 + b t^4/24 + a t^5/120."""

    alpha: jnp.ndarray  # (..., 3)
    beta: jnp.ndarray  # (..., 3)
    gamma: jnp.ndarray  # (..., 3)
    a0: jnp.ndarray  # (..., 3)
    v0: jnp.ndarray  # (..., 3)
    p0: jnp.ndarray  # (..., 3)
    tf: jnp.ndarray  # (...)
    cost: jnp.ndarray  # (...)  sum of per-axis jerk-integral costs


def generate(p0, v0, a0, tf, goal_pos=None, goal_vel=None, goal_acc=None):
    """Solve the closed-form min-jerk primitive for the given end constraints.

    Any of goal_pos/vel/acc may be None (left free, like not calling
    SetGoal* in the reference) or an array broadcastable to (..., 3).
    Constraint case selection mirrors SingleAxisTrajectory.cpp:59-107.
    """
    p0, v0, a0 = (jnp.asarray(x, jnp.float32) for x in (p0, v0, a0))
    tf = jnp.asarray(tf, jnp.float32)
    T = tf[..., None]

    has_p = goal_pos is not None
    has_v = goal_vel is not None
    has_a = goal_acc is not None
    pf = jnp.asarray(goal_pos, jnp.float32) if has_p else jnp.zeros_like(p0)
    vf = jnp.asarray(goal_vel, jnp.float32) if has_v else jnp.zeros_like(v0)
    af = jnp.asarray(goal_acc, jnp.float32) if has_a else jnp.zeros_like(a0)

    da = af - a0
    dv = vf - v0 - a0 * T
    dp = pf - p0 - v0 * T - 0.5 * a0 * T * T

    T2, T3, T4, T5 = T * T, T**3, T**4, T**5

    if has_p and has_v and has_a:
        al = (60 * T2 * da - 360 * T * dv + 720 * dp) / T5
        be = (-24 * T3 * da + 168 * T2 * dv - 360 * T * dp) / T5
        ga = (3 * T4 * da - 24 * T3 * dv + 60 * T2 * dp) / T5
    elif has_p and has_v:
        al = (-120 * T * dv + 320 * dp) / T5
        be = (72 * T2 * dv - 200 * T * dp) / T5
        ga = (-12 * T3 * dv + 40 * T2 * dp) / T5
    elif has_p and has_a:
        al = (-15 * T2 * da + 90 * dp) / (2 * T5)
        be = (15 * T3 * da - 90 * T * dp) / (2 * T5)
        ga = (-3 * T4 * da + 30 * T2 * dp) / (2 * T5)
    elif has_v and has_a:
        al = jnp.zeros_like(da)
        be = (6 * T * da - 12 * dv) / T3
        ga = (-2 * T2 * da + 6 * T * dv) / T3
    elif has_p:
        al = 20 * dp / T5
        be = -20 * dp / T4
        ga = 10 * dp / T3
    elif has_v:
        al = jnp.zeros_like(dv)
        be = -3 * dv / T3
        ga = 3 * dv / T2
    elif has_a:
        al = jnp.zeros_like(da)
        be = jnp.zeros_like(da)
        ga = da / T
    else:
        al = be = ga = jnp.zeros_like(da)

    cost = (
        ga * ga + be * ga * T + be * be * T2 / 3.0 + al * ga * T2 / 3.0
        + al * be * T3 / 4.0 + al * al * T4 / 20.0
    ).sum(-1)
    return Traj(alpha=al, beta=be, gamma=ga, a0=a0, v0=v0, p0=p0, tf=tf, cost=cost)


def position(tr: Traj, t):
    t = jnp.asarray(t, jnp.float32)[..., None]
    return (
        tr.p0 + tr.v0 * t + tr.a0 * t**2 / 2.0 + tr.gamma * t**3 / 6.0
        + tr.beta * t**4 / 24.0 + tr.alpha * t**5 / 120.0
    )


def velocity(tr: Traj, t):
    t = jnp.asarray(t, jnp.float32)[..., None]
    return (
        tr.v0 + tr.a0 * t + tr.gamma * t**2 / 2.0 + tr.beta * t**3 / 6.0
        + tr.alpha * t**4 / 24.0
    )


def acceleration(tr: Traj, t):
    t = jnp.asarray(t, jnp.float32)[..., None]
    return tr.a0 + tr.gamma * t + tr.beta * t**2 / 2.0 + tr.alpha * t**3 / 6.0


def jerk(tr: Traj, t):
    t = jnp.asarray(t, jnp.float32)[..., None]
    return tr.gamma + tr.beta * t + tr.alpha * t**2 / 2.0


def normal_vector(tr: Traj, t, grav):
    n = acceleration(tr, t) - grav
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(norm < 1e-12, 1.0, norm)


def thrust(tr: Traj, t, grav):
    return jnp.linalg.norm(acceleration(tr, t) - grav, axis=-1)


def omega(tr: Traj, t, dt, grav):
    """Finite-difference world-frame body rates rotating the normal vector."""
    n0 = normal_vector(tr, t, grav)
    n1 = normal_vector(tr, jnp.asarray(t) + dt, grav)
    cr = jnp.cross(n0, n1)
    nrm = jnp.linalg.norm(cr, axis=-1, keepdims=True)
    ok = nrm[..., 0] > 1e-6
    unit = cr / jnp.where(nrm < 1e-12, 1.0, nrm)
    angle = trig.acos(jnp.clip((n0 * n1).sum(-1), -1.0, 1.0)) / dt
    return jnp.where(ok[..., None], unit * angle[..., None], jnp.zeros_like(cr))


def to_poly_coeffs(tr: Traj):
    """(..., 6, 3) quintic coefficients, highest power first (GetTrajectory)."""
    return jnp.stack(
        [tr.alpha / 120.0, tr.beta / 24.0, tr.gamma / 6.0, tr.a0 / 2.0, tr.v0, tr.p0],
        axis=-2,
    )


# -----------------------------------------------------------------------------
# input feasibility: fixed-depth dyadic bisection
# -----------------------------------------------------------------------------

def _axis_minmax_acc(tr: Traj, t1, t2):
    """Per-axis acceleration extrema on [t1, t2] (SingleAxisTrajectory.cpp:118-156).

    t1/t2: (...,) broadcastable to tr batch. Returns (amin, amax): (..., 3).
    """
    al, be, ga = tr.alpha, tr.beta, tr.gamma
    # critical times: roots of jerk = ga + be t + al t^2 / 2
    det = be * be - 2.0 * ga * al
    has_quad = jnp.abs(al) > 0
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    safe_al = jnp.where(has_quad, al, 1.0)
    tq0 = jnp.where(has_quad & (det >= 0), (-be + sq) / safe_al, 0.0)
    tq1 = jnp.where(has_quad & (det >= 0), (-be - sq) / safe_al, 0.0)
    safe_be = jnp.where(jnp.abs(be) > 0, be, 1.0)
    tl0 = jnp.where(jnp.abs(be) > 0, -ga / safe_be, 0.0)
    t_0 = jnp.where(has_quad, tq0, tl0)
    t_1 = jnp.where(has_quad, tq1, jnp.zeros_like(tq1))

    def acc_at(t):
        return tr.a0 + ga * t + be * t**2 / 2.0 + al * t**3 / 6.0

    t1b = jnp.asarray(t1, jnp.float32)[..., None]
    t2b = jnp.asarray(t2, jnp.float32)[..., None]
    a_lo = acc_at(t1b)
    a_hi = acc_at(t2b)
    amin = jnp.minimum(a_lo, a_hi)
    amax = jnp.maximum(a_lo, a_hi)
    for tc in (t_0, t_1):
        inside = (tc > t1b) & (tc < t2b)
        a_c = acc_at(jnp.clip(tc, t1b, t2b))
        amin = jnp.where(inside, jnp.minimum(amin, a_c), amin)
        amax = jnp.where(inside, jnp.maximum(amax, a_c), amax)
    return amin, amax


def _axis_max_jerk_sq(tr: Traj, t1, t2):
    """Per-axis max jerk^2 on [t1, t2] (cpp:165-177). Returns (..., 3)."""
    al, be = tr.alpha, tr.beta

    def jerk_at(t):
        return tr.gamma + be * t + al * t**2 / 2.0

    t1b = jnp.asarray(t1, jnp.float32)[..., None]
    t2b = jnp.asarray(t2, jnp.float32)[..., None]
    j2 = jnp.maximum(jerk_at(t1b) ** 2, jerk_at(t2b) ** 2)
    has = jnp.abs(al) > 0
    tmax = jnp.where(has, -be / jnp.where(has, al, 1.0), t1b - 1.0)
    inside = (tmax > t1b) & (tmax < t2b)
    j2 = jnp.where(inside, jnp.maximum(j2, jerk_at(jnp.clip(tmax, t1b, t2b)) ** 2), j2)
    return j2


def _section_verdict(tr: Traj, grav, t1, t2, fmin_allowed, fmax_allowed, wmax_allowed):
    """One section's test. Returns (feasible, infeasible, needs_split)."""
    thr1 = thrust(tr, t1, grav)
    thr2 = thrust(tr, t2, grav)
    hard_bad = (jnp.maximum(thr1, thr2) > fmax_allowed) | (
        jnp.minimum(thr1, thr2) < fmin_allowed
    )

    amin, amax = _axis_minmax_acc(tr, t1, t2)
    v1 = amin - grav
    v2 = amax - grav
    # per-axis "definitely infeasible" check (max(v1^2, v2^2) > fmax^2 per axis)
    hard_bad = hard_bad | jnp.any(
        jnp.maximum(v1 * v1, v2 * v2) > fmax_allowed * fmax_allowed, axis=-1
    )

    crosses_zero = (v1 * v2) < 0
    fmin_sq_axis = jnp.where(crosses_zero, 0.0, jnp.minimum(jnp.abs(v1), jnp.abs(v2)) ** 2)
    fmax_sq_axis = jnp.maximum(jnp.abs(v1), jnp.abs(v2)) ** 2
    fmin_sq = fmin_sq_axis.sum(-1)
    fmax_sq = fmax_sq_axis.sum(-1)
    jmax_sq = _axis_max_jerk_sq(tr, t1, t2).sum(-1)

    fmin = jnp.sqrt(fmin_sq)
    fmax = jnp.sqrt(fmax_sq)
    wbound = jnp.where(fmin_sq > 1e-6, jnp.sqrt(jmax_sq / jnp.maximum(fmin_sq, 1e-12)), jnp.inf)

    hard_bad = hard_bad | (fmax < fmin_allowed) | (fmin > fmax_allowed)
    uncertain = (fmin < fmin_allowed) | (fmax > fmax_allowed) | (wbound > wmax_allowed)

    infeasible = hard_bad
    needs_split = ~hard_bad & uncertain
    feasible = ~hard_bad & ~uncertain
    return feasible, infeasible, needs_split


def check_input_feasibility(tr: Traj, grav, fmin_allowed=5.0, fmax_allowed=30.0,
                            wmax_allowed=20.0, min_time_section=0.02,
                            max_depth=9, static_max_tf=None):
    """Interval-bisection proof that thrust in [fmin, fmax] and |w| <= wmax.

    Returns a boolean (True = InputFeasible). Verdict matches the reference
    recursion: a needed section narrower than min_time_section rejects
    (InputIndeterminable), hard thrust violations reject, and uncertain
    sections recurse into both halves (here: the next dyadic level).

    static_max_tf: optional static upper bound on every tf in the batch
    (e.g. the candidate sampler's max duration). Once a level's sections
    are provably narrower than min_time_section for ALL tf <= bound, every
    still-needed section rejects as InputIndeterminable without evaluating
    it — identical verdicts, but the deepest (widest) levels, ~75% of the
    section evaluations for the default sampler, are skipped at trace time.
    """
    grav = jnp.asarray(grav, jnp.float32)
    batch = tr.tf.shape
    ok = jnp.ones(batch, bool)

    needed = jnp.ones(batch + (1,), bool)  # level 0: one section
    for level in range(max_depth + 1):
        n = 1 << level
        if static_max_tf is not None and static_max_tf / n < min_time_section:
            # every section at this level is too narrow regardless of tf:
            # any still-needed one is InputIndeterminable
            ok = ok & ~jnp.any(needed, axis=-1)
            break
        idx = jnp.arange(n, dtype=jnp.float32)
        t1 = tr.tf[..., None] * (idx / n)  # (..., n)
        t2 = tr.tf[..., None] * ((idx + 1.0) / n)
        width = tr.tf[..., None] / n

        # sections too narrow to prove anything: InputIndeterminable
        # (the reference rejects at section entry, before any test)
        too_narrow = width < min_time_section
        # evaluate each section (extra trailing axis = section index)
        tr_b = jax.tree_util.tree_map(lambda x: x[..., None, :] if x.ndim == len(batch) + 1 else x[..., None], tr)
        feas, infeas, split = _section_verdict(
            tr_b, grav, t1, t2, fmin_allowed, fmax_allowed, wmax_allowed
        )
        ok = ok & ~jnp.any(needed & (too_narrow | infeas), axis=-1)
        if level == max_depth:
            # any still-unresolved section rejects
            ok = ok & ~jnp.any(needed & split, axis=-1)
            break
        # children needed where this section split
        child_needed = jnp.repeat(needed & split & ~too_narrow, 2, axis=-1)
        needed = child_needed
    return ok


def check_velocity_feasibility(tr: Traj, vmax, strict_degenerate: bool = True):
    """Per-axis |v| < vmax proof via cubic acceleration roots
    (RapidTrajectoryGenerator.cpp:163-208). Returns bool (True = feasible).

    strict_degenerate=True is bug-compatible with the reference: an axis
    whose acceleration cubic degenerates (|alpha| ~ 0) is declared
    infeasible (the reference's unimplemented branch). False evaluates
    degenerate axes correctly via the quadratic acceleration roots —
    useful because this framework's candidates can legitimately have
    straight-line constant-jerk axes.
    """
    c0 = tr.alpha / 6.0
    c1 = tr.beta / 2.0
    c2 = tr.gamma
    c3 = tr.a0
    degenerate = jnp.abs(c0) <= 1e-6  # (..., 3)

    safe_c0 = jnp.where(degenerate, 1.0, c0)
    roots, valid = rootfind.solve_cubic(c1 / safe_c0, c2 / safe_c0, c3 / safe_c0)
    if not strict_degenerate:
        # degenerate axis: acceleration = beta/2 t^2 + gamma t + a0
        qroots, qvalid = rootfind.solve_quadratic(c1, c2, c3)
        pad = jnp.zeros(qroots.shape[:-1] + (1,), qroots.dtype)
        qroots3 = jnp.concatenate([qroots, pad], axis=-1)
        qvalid3 = jnp.concatenate([qvalid, jnp.zeros(pad.shape, bool)], axis=-1)
        roots = jnp.where(degenerate[..., None], qroots3.astype(roots.dtype), roots)
        valid = jnp.where(degenerate[..., None], qvalid3, valid)
    # candidate times: 3 roots + endpoints 0, tf  -> (..., 3, 5)
    tf = tr.tf[..., None, None]
    zeros = jnp.zeros_like(tf)
    times = jnp.concatenate([roots, jnp.broadcast_to(zeros, roots.shape[:-1] + (1,)),
                             jnp.broadcast_to(tf, roots.shape[:-1] + (1,))], axis=-1)
    tvalid = jnp.concatenate([valid, jnp.ones(valid.shape[:-1] + (2,), bool)], axis=-1)
    tvalid = tvalid & (times >= 0) & (times <= tf)

    # evaluate the 3-D velocity at each candidate time of each axis
    t_flat = times[..., None]  # (..., 3axis, 5, 1)
    v = (
        tr.v0[..., None, None, :] + tr.a0[..., None, None, :] * t_flat
        + tr.gamma[..., None, None, :] * t_flat**2 / 2.0
        + tr.beta[..., None, None, :] * t_flat**3 / 6.0
        + tr.alpha[..., None, None, :] * t_flat**4 / 24.0
    )  # (..., 3, 5, 3)
    exceeded = jnp.any(jnp.abs(v) >= vmax, axis=-1) & tvalid  # (..., 3, 5)
    infeasible = jnp.any(exceeded, axis=(-2, -1))
    if strict_degenerate:
        infeasible = infeasible | jnp.any(degenerate, axis=-1)
    return ~infeasible


def check_position_feasibility(tr: Traj, boundary_point, boundary_normal):
    """Half-plane containment proof (cpp:210-262). True = stays strictly on
    the normal side of the plane through boundary_point."""
    n = jnp.asarray(boundary_normal, jnp.float32)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)

    # velocity along the normal: quartic in t
    c0 = (n * tr.alpha).sum(-1) / 24.0
    c1 = (n * tr.beta).sum(-1) / 6.0
    c2 = (n * tr.gamma).sum(-1) / 2.0
    c3 = (n * tr.a0).sum(-1)
    c4 = (n * tr.v0).sum(-1)

    quartic = jnp.abs(c0) > 1e-6
    safe_c0 = jnp.where(quartic, c0, 1.0)
    r4, v4 = rootfind.solve_quartic(c1 / safe_c0, c2 / safe_c0, c3 / safe_c0, c4 / safe_c0)
    safe_c1 = jnp.where(jnp.abs(c1) > 0, c1, 1.0)
    r3, v3 = rootfind.solve_cubic(c2 / safe_c1, c3 / safe_c1, c4 / safe_c1)
    r3 = jnp.concatenate([r3, jnp.zeros_like(r3[..., :1])], axis=-1)
    v3 = jnp.concatenate([v3, jnp.zeros_like(v3[..., :1])], axis=-1)
    roots = jnp.where(quartic[..., None], r4, r3)
    rvalid = jnp.where(quartic[..., None], v4, v3)

    tf = tr.tf[..., None]
    times = jnp.concatenate(
        [roots, jnp.zeros_like(tf), jnp.broadcast_to(tf, roots.shape[:-1] + (1,))],
        axis=-1,
    )
    tvalid = jnp.concatenate([rvalid, jnp.ones(rvalid.shape[:-1] + (2,), bool)], axis=-1)
    tvalid = tvalid & (times >= 0) & (times <= tf)

    pos = position(jax.tree_util.tree_map(lambda x: x[..., None, :] if x.ndim == tr.tf.ndim + 1 else x[..., None], tr), times)
    d = ((pos - jnp.asarray(boundary_point, jnp.float32)[..., None, :]) * n[..., None, :]).sum(-1)
    bad = jnp.any((d <= 0) & tvalid, axis=-1)
    return ~bad
