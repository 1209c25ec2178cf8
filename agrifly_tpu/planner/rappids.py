"""RAPPIDS — Rectangular Pyramid Partitioning using Integrated Depth Sensors.

JAX redesign of the reference planner (Components/Components/
DepthImagePlanner/DepthImagePlanner.{hpp,cpp}). The reference is an
*anytime* loop: sample one candidate at a time, gate by cost/feasibility,
lazily inflate pyramids around sample endpoints, track the best
collision-free candidate until the compute budget expires. Under XLA that
becomes a fixed-shape batch pipeline:

  1. sample N candidates at once (jax.random), generate min-jerk primitives
     and exploration costs in one fused pass;
  2. gate all candidates by input/velocity feasibility (planner/traj.py);
  3. build a fixed-capacity pyramid set in R rounds: round r inflates
     pyramids at the endpoint pixels of the best not-yet-coverable
     candidates, all seeds in parallel. Pyramid inflation — the reference's
     sequential spiral + shrink scans (cpp:456-970) — is reformulated as:
       * expansion: a bounded max-sweep fixpoint (each side jumps to the
         nearest blocked line within the current perpendicular extent,
         Gauss-Seidel half-steps keep the rect blocked-free) replaces the
         reference's O(max(W,H)) sequential 1-px spiral;
       * shrink: each image band contributes its edge constraint through a
         masked min/max reduction; corner obstacles pick an edge by the
         reference's smaller-area-loss rule evaluated at the pre-shrink
         edges. The result satisfies every obstacle constraint (each pixel
         binds at least one final edge), i.e. it is a valid — occasionally
         slightly smaller — RAPPIDS pyramid.
  4. collision-check every candidate against the pyramid set with the
     paper's monotone-section splitting, as a fixed-capacity section stack
     inside a bounded loop; a section that cannot find a containing pyramid
     marks the candidate colliding (conservative vs the reference, which
     would lazily inflate there — rounds in step 3 close most of that gap).
  5. best = argmin cost over candidates that pass everything.

The batch semantics dominate the anytime semantics: the reference inspects
candidates in random order and only collision-checks those cheaper than the
best-so-far; the batch checks all N and picks the global argmin, which is a
superset of what any time budget could have examined.

Defaults match the reference (DepthImagePlanner.cpp:43-59): thrust in
[5, 30] m/s^2, |omega| <= 20 rad/s, |v| <= 5 m/s, min section 0.02 s,
2-pixel pyramid search buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.ops import rootfind
from agrifly_tpu.planner import traj as traj_mod

PIXEL_BUFFER = 2  # _pyramidSearchPixelBuffer

# full-f32 products: a GPU may otherwise run f32 matmuls in TF32
HIGHEST = jax.lax.Precision.HIGHEST


class CameraModel(NamedTuple):
    focal: jnp.ndarray  # f32 [px]
    cx: jnp.ndarray
    cy: jnp.ndarray
    width: int  # static
    height: int  # static
    depth_scale: jnp.ndarray  # meters per depth unit


def make_camera(width=640, height=480, focal=None, depth_scale=10.0 / 256.0) -> CameraModel:
    if focal is None:
        focal = width / 2.0
    return CameraModel(
        focal=jnp.float32(focal), cx=jnp.float32(width / 2.0),
        cy=jnp.float32(height / 2.0), width=int(width), height=int(height),
        depth_scale=jnp.float32(depth_scale),
    )


class PlannerParams(NamedTuple):
    cam: CameraModel
    true_radius: jnp.ndarray  # physical vehicle radius [m]
    plan_radius: jnp.ndarray  # planning radius [m]
    min_check_dist: jnp.ndarray  # [m]
    fmin: jnp.ndarray
    fmax: jnp.ndarray
    wmax: jnp.ndarray
    vmax: jnp.ndarray
    min_section_time: jnp.ndarray


def make_params(cam: CameraModel, true_radius, plan_radius, min_check_dist=0.5,
                fmin=5.0, fmax=30.0, wmax=20.0, vmax=5.0,
                min_section_time=0.02) -> PlannerParams:
    f32 = jnp.float32
    return PlannerParams(
        cam=cam, true_radius=f32(true_radius), plan_radius=f32(plan_radius),
        min_check_dist=f32(min_check_dist), fmin=f32(fmin), fmax=f32(fmax),
        wmax=f32(wmax), vmax=f32(vmax), min_section_time=f32(min_section_time),
    )


def deproject(cam: CameraModel, px, py, depth):
    """Pixel + depth -> camera-frame point (DepthImagePlanner.hpp:275-279)."""
    return jnp.stack(
        [
            depth * (px - cam.cx) / cam.focal,
            depth * (py - cam.cy) / cam.focal,
            depth * jnp.ones_like(px),
        ],
        axis=-1,
    )


def project(cam: CameraModel, point):
    """Camera-frame point -> pixel (hpp:287-290). Returns (px, py)."""
    z = point[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    return (
        point[..., 0] * cam.focal / safe_z + cam.cx,
        point[..., 1] * cam.focal / safe_z + cam.cy,
    )


# =============================================================================
# candidate sampling + exploration cost
# =============================================================================


def sample_candidates(params: PlannerParams, key, n, vel0, acc0, grav,
                      min_depth=1.5, max_depth=3.0, min_time=2.0, max_time=3.0):
    """N random rest-to-rest candidates (hpp:334-427): pixel uniform in the
    central 80% of the image, depth U(1.5,3) m, duration U(2,3) s; start at
    the camera origin with the current velocity/acceleration."""
    cam = params.cam
    # ONE threefry invocation for all four streams: split(key, 4) plus four
    # separate uniform() calls cost five threefry passes
    u = jax.random.uniform(key, (4, n), jnp.float32)
    px = 0.1 * cam.width + u[0] * (0.8 * cam.width)
    py = 0.1 * cam.height + u[1] * (0.8 * cam.height)
    depth = min_depth + u[2] * (max_depth - min_depth)
    tf = min_time + u[3] * (max_time - min_time)

    goal = deproject(cam, px, py, depth)
    p0 = jnp.zeros((n, 3), jnp.float32)
    v0 = jnp.broadcast_to(jnp.asarray(vel0, jnp.float32), (n, 3))
    a0 = jnp.broadcast_to(jnp.asarray(acc0, jnp.float32), (n, 3))
    zero = jnp.zeros((n, 3), jnp.float32)
    tr = traj_mod.generate(p0, v0, a0, tf, goal_pos=goal, goal_vel=zero, goal_acc=zero)
    return tr


def exploration_cost(tr: traj_mod.Traj, goal_cam):
    """-(progress toward goal)/duration, goal in camera frame
    (Rappids_Simulator/main.cpp:95-109)."""
    end = traj_mod.position(tr, tr.tf)
    sg = jnp.linalg.norm(goal_cam, axis=-1)
    pig = jnp.linalg.norm(goal_cam - end, axis=-1)
    return -(sg - pig) / tr.tf


# =============================================================================
# pyramid set
# =============================================================================


class PyramidSet(NamedTuple):
    """Fixed-capacity set of depth-sorted pyramids."""

    depth: jnp.ndarray  # (P,) base-plane depth [m]; +inf for unused slots
    bounds: jnp.ndarray  # (P, 4) f32 pixel bounds [right, top, left, bottom]
    normals: jnp.ndarray  # (P, 4, 3) lateral-face unit normals
    valid: jnp.ndarray  # (P,) bool


def empty_pyramid_set(capacity) -> PyramidSet:
    return PyramidSet(
        depth=jnp.full((capacity,), jnp.inf, jnp.float32),
        bounds=jnp.zeros((capacity, 4), jnp.float32),
        normals=jnp.zeros((capacity, 4, 3), jnp.float32),
        valid=jnp.zeros((capacity,), bool),
    )


def _pyramid_from_edges(cam: CameraModel, right, top, left, bottom, depth):
    """Corners + lateral normals from pixel bounds (Pyramid.hpp:49-60)."""
    c0 = deproject(cam, right, top, depth)  # top right
    c1 = deproject(cam, left, top, depth)  # top left
    c2 = deproject(cam, left, bottom, depth)  # bottom left
    c3 = deproject(cam, right, bottom, depth)  # bottom right

    def unit_cross(a, b):
        c = jnp.cross(a, b)
        n = jnp.linalg.norm(c)
        return c / jnp.where(n < 1e-12, 1.0, n)

    normals = jnp.stack(
        [unit_cross(c0, c1), unit_cross(c1, c2), unit_cross(c2, c3), unit_cross(c3, c0)]
    )
    bounds = jnp.stack([right, top, left, bottom])
    return bounds, normals


def inflate_pyramid(params: PlannerParams, depth_u16, x0, y0, min_depth,
                    shrink_extra: int = 0):
    """Grow + shrink one pyramid around sample pixel (x0, y0) at depth
    min_depth. Returns (valid, depth, bounds(4,), normals(4,3)).

    depth_u16: (H, W) int32 depth codes. See module docstring for how the
    sequential spiral becomes a max-sweep fixpoint. shrink_extra adds a
    conservative pixel margin to every shrink/offset distance (used by the
    down-sampled inflation path to absorb pooled-coordinate rounding).
    """
    cam = params.cam
    W, H = cam.width, cam.height
    scale = cam.depth_scale

    x0i = jnp.asarray(x0, jnp.int32)
    y0i = jnp.asarray(y0, jnp.int32)
    img = depth_u16.astype(jnp.int32)

    edge_off = (cam.focal * params.true_radius / params.min_check_dist).astype(jnp.int32) + shrink_extra
    ok = ~(
        (x0i <= edge_off + PIXEL_BUFFER + 1)
        | (x0i > W - edge_off - PIXEL_BUFFER - 1)
        | (y0i <= edge_off + PIXEL_BUFFER + 1)
        | (y0i > H - edge_off - PIXEL_BUFFER - 1)
    )

    min_pyr_depth = ((min_depth + params.plan_radius) / scale).astype(jnp.int32)
    init_radius = (cam.focal * params.plan_radius / (scale * min_pyr_depth.astype(jnp.float32))).astype(jnp.int32)
    ok = ok & (2 * init_radius < jnp.minimum(W, H) - 2 * edge_off)

    ignore = (params.true_radius / scale).astype(jnp.int32)

    # initial rectangle (cpp:485-501)
    top0 = jnp.where(y0i - init_radius < edge_off, edge_off, jnp.minimum(H - edge_off - 1, y0i + init_radius) - 2 * init_radius)
    bottom0 = top0 + 2 * init_radius
    left0 = jnp.where(x0i - init_radius < edge_off, edge_off, jnp.minimum(W - edge_off - 1, x0i + init_radius) - 2 * init_radius)
    right0 = left0 + 2 * init_radius

    # int32 throughout (incl. under x64): the same integer semantics on
    # every backend
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    ys = jnp.arange(H, dtype=jnp.int32)[:, None]

    blocked = (img > ignore) & (img < min_pyr_depth)

    # initial rect must be free
    in_rect0 = (xs >= left0) & (xs <= right0) & (ys >= top0) & (ys <= bottom0)
    ok = ok & ~jnp.any(blocked & in_rect0)

    # --- max-sweep expansion (replaces cpp:522-604's 1-px spiral) ---
    # Each round: (1) push right/left to the nearest blocked column within
    # the current row extent [t, b]; (2) push bottom/top to the nearest
    # blocked row within the *updated* column extent [l2, r2]. The
    # Gauss-Seidel half-step ordering guarantees every pixel of the final
    # rect was covered by some side's check (columns checked against the
    # rows of their time; rows checked against the full updated columns),
    # so the rect is blocked-free — the same invariant as the reference's
    # spiral, reached in O(1) whole-image reductions per round instead of
    # O(max(W, H)) sequential 1-px steps. Typically converges in 2 rounds;
    # stopping early at the bound still yields a valid (smaller) pyramid.
    BIGI = jnp.int32(1 << 20)
    EXPAND_ROUNDS = 8

    def cond(st):
        l, r, t, b, rounds, changed = st
        return changed & (rounds < EXPAND_ROUNDS)

    def body(st):
        l, r, t, b, rounds, _ = st
        in_rows = blocked & (ys >= t) & (ys <= b)
        first_r = jnp.where(in_rows & (xs > r), xs, BIGI).min()
        r2 = jnp.maximum(r, jnp.minimum(first_r - 1, W - 1 - edge_off))
        last_l = jnp.where(in_rows & (xs < l), xs, -BIGI).max()
        l2 = jnp.minimum(l, jnp.maximum(last_l + 1, edge_off))
        in_cols = blocked & (xs >= l2) & (xs <= r2)
        first_b = jnp.where(in_cols & (ys > b), ys, BIGI).min()
        b2 = jnp.maximum(b, jnp.minimum(first_b - 1, H - 1 - edge_off))
        last_t = jnp.where(in_cols & (ys < t), ys, -BIGI).max()
        t2 = jnp.minimum(t, jnp.maximum(last_t + 1, edge_off))
        ch = (l2 != l) | (r2 != r) | (t2 != t) | (b2 != b)
        return (l2, r2, t2, b2, rounds + 1, ch)

    l, r, t, b, *_ = jax.lax.while_loop(
        cond, body,
        (left0, right0, top0, bottom0, jnp.int32(0), jnp.bool_(True)),
    )

    # base depth: min unmasked depth inside the expanded rect (conservative
    # vs the reference's frontier-scan minimum; see module docstring)
    in_rect = (xs >= l) & (xs <= r) & (ys >= t) & (ys <= b)
    masked = jnp.where((img > ignore) & in_rect, img, jnp.int32(2**20))
    max_depth_expanded = jnp.minimum(masked.min(), 65535)

    # --- shrink by vehicle radius (cpp:606-946) ---
    numer = (cam.focal * params.plan_radius / scale).astype(jnp.int32)
    relevant = (img > ignore) & (img < max_depth_expanded)
    safe_img = jnp.maximum(img, 1)
    shrink_px = numer // safe_img + shrink_extra  # int(numerator / pixDist), (H, W)

    BIG = jnp.int32(1 << 20)

    r_init = W - 1 - edge_off
    l_init = edge_off
    t_init = edge_off
    b_init = H - 1 - edge_off

    # edge bands
    right_band = relevant & (xs >= r) & (ys >= t) & (ys <= b)
    left_band = relevant & (xs <= l) & (ys >= t) & (ys <= b)
    top_band = relevant & (ys <= t) & (xs >= l) & (xs <= r)
    bottom_band = relevant & (ys >= b) & (xs >= l) & (xs <= r)

    s_right = xs - shrink_px  # candidate new right edge per pixel
    s_left = xs + shrink_px
    s_top = ys + shrink_px
    s_bottom = ys - shrink_px

    # for edge bands: pixel binds its own edge unless that would exclude the
    # seed; then it re-binds top/bottom (or left/right), or fails
    def band_reduce(band, primary, alt_hi, alt_lo, seed_main, seed_alt,
                    init_primary, is_min):
        """Resolve one edge band. primary: per-pixel candidate for the band's
        own edge. alt_hi/alt_lo: candidates for the two perpendicular edges
        (hi = max-type edge e.g. top, lo = min-type e.g. bottom).
        Returns (edge_value, alt_hi_value, alt_lo_value, failed)."""
        can_primary = jnp.where(
            is_min,
            seed_main < primary - PIXEL_BUFFER,
            seed_main > primary + PIXEL_BUFFER,
        )
        can_hi = seed_alt > alt_hi + PIXEL_BUFFER  # shrinking hi edge keeps seed
        can_lo = seed_alt < alt_lo - PIXEL_BUFFER
        fail = band & ~can_primary & ~can_hi & ~can_lo
        use_hi = band & ~can_primary & can_hi & ~can_lo
        use_lo = band & ~can_primary & can_lo & ~can_hi
        # both alternatives possible: pick smaller 1-D loss vs initial edges
        both = band & ~can_primary & can_hi & can_lo
        hi_loss = alt_hi - t_init
        lo_loss = b_init - alt_lo
        use_hi = use_hi | (both & (lo_loss > hi_loss))
        use_lo = use_lo | (both & ~(lo_loss > hi_loss))
        use_primary = band & can_primary

        if is_min:
            edge = jnp.where(use_primary, primary, BIG).min()
            edge = jnp.minimum(edge, init_primary)
        else:
            edge = jnp.where(use_primary, primary, -BIG).max()
            edge = jnp.maximum(edge, init_primary)
        hi_val = jnp.where(use_hi, alt_hi, -BIG).max()
        lo_val = jnp.where(use_lo, alt_lo, BIG).min()
        return edge, hi_val, lo_val, jnp.any(fail)

    right_e, rt_hi, rt_lo, f1 = band_reduce(
        right_band, s_right, s_top, s_bottom, x0i, y0i, r_init, is_min=True
    )
    left_e, lt_hi, lt_lo, f2 = band_reduce(
        left_band, s_left, s_top, s_bottom, x0i, y0i, l_init, is_min=False
    )
    top_e, tp_hi, tp_lo, f3 = band_reduce(
        top_band, s_top, s_left, s_right, y0i, x0i, t_init, is_min=False
    )
    bot_e, bt_hi, bt_lo, f4 = band_reduce(
        bottom_band, s_bottom, s_left, s_right, y0i, x0i, b_init, is_min=True
    )
    ok = ok & ~(f1 | f2 | f3 | f4)

    right_f = jnp.minimum(right_e, jnp.minimum(tp_lo, bt_lo))
    left_f = jnp.maximum(left_e, jnp.maximum(tp_hi, bt_hi))
    top_f = jnp.maximum(top_e, jnp.maximum(rt_hi, lt_hi))
    bottom_f = jnp.minimum(bot_e, jnp.minimum(rt_lo, lt_lo))

    # corner bands: obstacle binds whichever of its two edges loses less area
    def corner(band, s_a, a_is_min, a_seed_ok, s_b, b_is_min, b_seed_ok,
               a_loss, b_loss):
        both_bad = band & ~a_seed_ok & ~b_seed_ok
        use_a = band & a_seed_ok & (~b_seed_ok | (b_loss > a_loss))
        use_b = band & b_seed_ok & ~use_a
        a_val = jnp.where(use_a, s_a, BIG if a_is_min else -BIG)
        a_val = a_val.min() if a_is_min else a_val.max()
        b_val = jnp.where(use_b, s_b, BIG if b_is_min else -BIG)
        b_val = b_val.min() if b_is_min else b_val.max()
        return a_val, b_val, jnp.any(both_bad)

    tr_band = relevant & (xs >= r) & (ys <= t)
    br_band = relevant & (xs >= r) & (ys >= b)
    tl_band = relevant & (xs <= l) & (ys <= t)
    bl_band = relevant & (xs <= l) & (ys >= b)

    # pixel-level "does this corner pixel actually constrain both edges"
    def corner_constrains(band, da, db):
        return band & da & db

    h_span = jnp.maximum(bottom_f - top_f, 1)
    w_span = jnp.maximum(right_f - left_f, 1)

    # top-right: right edge (min-type) & top edge (max-type)
    tr_act = corner_constrains(tr_band, s_right < right_f, s_top > top_f)
    rv, tv, fbad = corner(
        tr_act,
        s_right, True, x0i < s_right - PIXEL_BUFFER,
        s_top, False, y0i > s_top + PIXEL_BUFFER,
        (right_f - s_right) * h_span, (s_top - top_f) * w_span,
    )
    right_f = jnp.minimum(right_f, rv)
    top_f = jnp.maximum(top_f, tv)
    ok = ok & ~fbad

    # bottom-right: right (min) & bottom (min)
    br_act = corner_constrains(br_band, s_right < right_f, s_bottom < bottom_f)
    rv, bv, fbad = corner(
        br_act,
        s_right, True, x0i < s_right - PIXEL_BUFFER,
        s_bottom, True, y0i < s_bottom - PIXEL_BUFFER,
        (right_f - s_right) * h_span, (bottom_f - s_bottom) * w_span,
    )
    right_f = jnp.minimum(right_f, rv)
    bottom_f = jnp.minimum(bottom_f, bv)
    ok = ok & ~fbad

    # top-left: left (max) & top (max)
    tl_act = corner_constrains(tl_band, s_left > left_f, s_top > top_f)
    lv, tv, fbad = corner(
        tl_act,
        s_left, False, x0i > s_left + PIXEL_BUFFER,
        s_top, False, y0i > s_top + PIXEL_BUFFER,
        (s_left - left_f) * h_span, (s_top - top_f) * w_span,
    )
    left_f = jnp.maximum(left_f, lv)
    top_f = jnp.maximum(top_f, tv)
    ok = ok & ~fbad

    # bottom-left: left (max) & bottom (min)
    bl_act = corner_constrains(bl_band, s_left > left_f, s_bottom < bottom_f)
    lv, bv, fbad = corner(
        bl_act,
        s_left, False, x0i > s_left + PIXEL_BUFFER,
        s_bottom, True, y0i < s_bottom - PIXEL_BUFFER,
        (s_left - left_f) * h_span, (bottom_f - s_bottom) * w_span,
    )
    left_f = jnp.maximum(left_f, lv)
    bottom_f = jnp.minimum(bottom_f, bv)
    ok = ok & ~fbad

    # final validity: seed strictly inside with buffer, non-degenerate
    ok = ok & (left_f + PIXEL_BUFFER < right_f - PIXEL_BUFFER)
    ok = ok & (top_f + PIXEL_BUFFER < bottom_f - PIXEL_BUFFER)
    ok = ok & (x0i > left_f + PIXEL_BUFFER) & (x0i < right_f - PIXEL_BUFFER)
    ok = ok & (y0i > top_f + PIXEL_BUFFER) & (y0i < bottom_f - PIXEL_BUFFER)

    base_depth = max_depth_expanded.astype(jnp.float32) * scale - params.plan_radius
    bounds, normals = _pyramid_from_edges(
        cam,
        right_f.astype(jnp.float32), top_f.astype(jnp.float32),
        left_f.astype(jnp.float32), bottom_f.astype(jnp.float32),
        base_depth,
    )
    depth_out = jnp.where(ok, base_depth, jnp.inf)
    return ok, depth_out, bounds, normals


def build_pyramid_set(params: PlannerParams, depth_u16, seed_px, seed_py,
                      seed_depth, seed_valid, capacity,
                      downsample: int = 1) -> PyramidSet:
    """Inflate pyramids at up to `capacity` seeds (vmapped), depth-sorted.

    downsample k > 1 runs the inflation on a k x k masked-min-pooled image
    with a scaled camera: any partially blocked pooled cell blocks, the
    base depth is the exact full-res minimum, and a +1-pooled-pixel margin
    absorbs coordinate rounding — strictly conservative, ~k^2 cheaper.
    Output pixel bounds are rescaled to full-resolution coordinates.
    """
    cam = params.cam
    img = depth_u16.astype(jnp.int32)
    work_params = params
    k = int(downsample)
    if k > 1:
        H, W = cam.height, cam.width
        BIGD = jnp.int32(1 << 17)
        ignore = (params.true_radius / cam.depth_scale).astype(jnp.int32)
        masked = jnp.where(img > ignore, img, BIGD)
        pooled = masked.reshape(H // k, k, W // k, k).min(axis=(1, 3))
        img = pooled
        cam_small = CameraModel(
            focal=cam.focal / k, cx=cam.cx / k, cy=cam.cy / k,
            width=W // k, height=H // k, depth_scale=cam.depth_scale,
        )
        work_params = params._replace(cam=cam_small)
        seed_px = seed_px / k
        seed_py = seed_py / k

    shrink_extra = 1 if k > 1 else 0
    ok, depth, bounds, normals = jax.vmap(
        lambda x, y, d: inflate_pyramid(work_params, img, x, y, d, shrink_extra)
    )(seed_px.astype(jnp.int32), seed_py.astype(jnp.int32), seed_depth)
    if k > 1:
        bounds = bounds * k
    ok = ok & seed_valid
    depth = jnp.where(ok, depth, jnp.inf)
    order = jnp.argsort(depth)
    take = order[:capacity]
    return PyramidSet(
        depth=depth[take], bounds=bounds[take], normals=normals[take],
        valid=ok[take],
    )


def prefilter_seeds(params: PlannerParams, depth_u16, seed_px, seed_py,
                    seed_depth, seed_valid, downsample: int = 1):
    """Sound inflation-failure pre-filter: clears the valid bit of seeds the
    inflation is guaranteed to reject, without running it.

    Two exact-or-sound conditions (vs inflate_pyramid's semantics):
      * pass-A reproduction: a blocker (ignore < img < min_pyr_depth)
        inside the seed's initial rectangle fails inflation outright;
      * shrink overlap: a blocker within (shrink(px,py) + PIXEL_BUFFER) of
        the seed on BOTH axes defeats every band/corner escape in the edge
        shrink logic (can_primary, can_hi, can_lo all provably false), so
        inflation must fail — whatever the expanded rectangle was.

    Never kills a seed inflation would accept; callers use it to compact
    an overseeded batch before paying an inflation per seed (the
    lazy round in _plan_core overseeds 4x because most raw fail points sit
    too close to the obstacle that failed them).
    """
    cam = params.cam
    img = depth_u16.astype(jnp.int32)
    k = int(downsample)
    if k > 1:
        # identical pooling to build_pyramid_set (CSEd when jitted together)
        H, W = cam.height, cam.width
        BIGD = jnp.int32(1 << 17)
        ignore_full = (params.true_radius / cam.depth_scale).astype(jnp.int32)
        masked = jnp.where(img > ignore_full, img, BIGD)
        img = masked.reshape(H // k, k, W // k, k).min(axis=(1, 3))
        cam = CameraModel(
            focal=cam.focal / k, cx=cam.cx / k, cy=cam.cy / k,
            width=W // k, height=H // k, depth_scale=cam.depth_scale,
        )
        seed_px = seed_px / k
        seed_py = seed_py / k
    shrink_extra = 1 if k > 1 else 0

    Wd, Hd = int(cam.width), int(cam.height)
    scale = cam.depth_scale
    x0i = seed_px.astype(jnp.int32)
    y0i = seed_py.astype(jnp.int32)
    edge_off = (cam.focal * params.true_radius
                / params.min_check_dist).astype(jnp.int32) + shrink_extra
    min_pyr_depth = (
        (jnp.asarray(seed_depth, jnp.float32) + params.plan_radius) / scale
    ).astype(jnp.int32)
    init_radius = (
        cam.focal * params.plan_radius
        / (scale * min_pyr_depth.astype(jnp.float32))
    ).astype(jnp.int32)
    ignore = (params.true_radius / scale).astype(jnp.int32)
    top0 = jnp.where(y0i - init_radius < edge_off, edge_off,
                     jnp.minimum(Hd - edge_off - 1, y0i + init_radius)
                     - 2 * init_radius)
    bottom0 = top0 + 2 * init_radius
    left0 = jnp.where(x0i - init_radius < edge_off, edge_off,
                      jnp.minimum(Wd - edge_off - 1, x0i + init_radius)
                      - 2 * init_radius)
    right0 = left0 + 2 * init_radius
    numer = (cam.focal * params.plan_radius / scale).astype(jnp.int32)
    shrink = numer // jnp.maximum(img, 1) + shrink_extra

    ys = jnp.arange(Hd)[:, None]
    xs = jnp.arange(Wd)[None, :]

    def doomed(j):
        blocked = (img > ignore) & (img < min_pyr_depth[j])
        in_rect0 = ((xs >= left0[j]) & (xs <= right0[j])
                    & (ys >= top0[j]) & (ys <= bottom0[j]))
        box = ((jnp.abs(xs - x0i[j]) <= shrink + PIXEL_BUFFER)
               & (jnp.abs(ys - y0i[j]) <= shrink + PIXEL_BUFFER))
        return jnp.any(blocked & (in_rect0 | box))

    return seed_valid & ~jax.vmap(doomed)(jnp.arange(seed_px.shape[0]))


def merge_pyramid_sets(a: PyramidSet, b: PyramidSet) -> PyramidSet:
    """Union of two sets, re-sorted by depth, keeping a's capacity."""
    capacity = a.depth.shape[0]
    depth = jnp.concatenate([a.depth, b.depth])
    order = jnp.argsort(depth)[:capacity]
    return PyramidSet(
        depth=depth[order],
        bounds=jnp.concatenate([a.bounds, b.bounds])[order],
        normals=jnp.concatenate([a.normals, b.normals])[order],
        valid=jnp.concatenate([a.valid, b.valid])[order],
    )


def find_containing_pyramid(pyrs: PyramidSet, px, py, depth):
    """First (shallowest-base) pyramid deeper than `depth` containing the
    pixel with the search buffer (cpp:356-380). Returns (found, index)."""
    deeper = pyrs.valid & (pyrs.depth >= depth)
    inside = (
        (pyrs.bounds[:, 2] + PIXEL_BUFFER < px)
        & (px < pyrs.bounds[:, 0] - PIXEL_BUFFER)
        & (pyrs.bounds[:, 1] + PIXEL_BUFFER < py)
        & (py < pyrs.bounds[:, 3] - PIXEL_BUFFER)
    )
    hit = deeper & inside
    found = jnp.any(hit)
    idx = jnp.argmax(hit)  # depth-sorted => first hit is shallowest
    return found, idx


# =============================================================================
# collision checking
# =============================================================================

MAX_SECTIONS = 8
MAX_CHECK_ITERS = 24


def monotonic_sections(tr_one: traj_mod.Traj):
    """Split [0, tf] at the roots of zdot (cpp:303-354).

    Returns (t1s, t2s, valid) arrays of length MAX_SECTIONS.
    """
    # zdot(t) = v0z + a0z t + gz t^2/2 + bz t^3/6 + az t^4/24
    c0 = tr_one.alpha[2] / 24.0
    c1 = tr_one.beta[2] / 6.0
    c2 = tr_one.gamma[2] / 2.0
    c3 = tr_one.a0[2]
    c4 = tr_one.v0[2]
    quart = jnp.abs(c0) > 1e-6
    sc0 = jnp.where(quart, c0, 1.0)
    r4, v4 = rootfind.solve_quartic(c1 / sc0, c2 / sc0, c3 / sc0, c4 / sc0)
    sc1 = jnp.where(jnp.abs(c1) > 0, c1, 1.0)
    r3, v3 = rootfind.solve_cubic(c2 / sc1, c3 / sc1, c4 / sc1)
    r3 = jnp.concatenate([r3, jnp.zeros(1)])
    v3 = jnp.concatenate([v3, jnp.zeros(1, bool)])
    roots = jnp.where(quart, r4, r3.astype(r4.dtype))
    rvalid = jnp.where(quart, v4, v3)

    # boundaries: 0, tf, and interior roots
    tf = tr_one.tf
    interior = rvalid & (roots > 0.0) & (roots < tf)
    bnd = jnp.concatenate(
        [jnp.zeros(1, jnp.float32), jnp.where(interior, roots, tf).astype(jnp.float32),
         tf[None].astype(jnp.float32)]
    )  # (6,)
    bnd = jnp.sort(bnd)
    t1s = bnd[:-1]
    t2s = bnd[1:]
    valid = (t2s - t1s) > 1e-6
    pad = MAX_SECTIONS - t1s.shape[0]
    t1s = jnp.concatenate([t1s, jnp.zeros(pad, jnp.float32)])
    t2s = jnp.concatenate([t2s, jnp.zeros(pad, jnp.float32)])
    valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    return t1s, t2s, valid


def _z_at(tr_one, t):
    return (
        tr_one.p0[2] + tr_one.v0[2] * t + tr_one.a0[2] * t * t / 2.0
        + tr_one.gamma[2] * t**3 / 6.0 + tr_one.beta[2] * t**4 / 24.0
        + tr_one.alpha[2] * t**5 / 120.0
    )


def _deepest_collision_time(tr_one, normals, t1, t2, increasing):
    """Deepest in-time intersection with 4 lateral faces (cpp:382-454).

    Assumes tr_one.p0 == 0 (camera-frame planning), so d(t) = n.p(t) has no
    constant term and t=0 factors out leaving a quartic.
    """
    # quartic coefficients of n.p(t)/t for each face: (4, 5)
    def dot(v):
        return jnp.matmul(normals, v, precision=HIGHEST)

    c0 = dot(tr_one.alpha) / 120.0
    c1 = dot(tr_one.beta) / 24.0
    c2 = dot(tr_one.gamma) / 6.0
    c3 = dot(tr_one.a0) / 2.0
    c4 = dot(tr_one.v0)

    quart = jnp.abs(c0) > 1e-6
    sc0 = jnp.where(quart, c0, 1.0)
    r4, v4 = rootfind.solve_quartic(c1 / sc0, c2 / sc0, c3 / sc0, c4 / sc0)
    sc1 = jnp.where(jnp.abs(c1) > 0, c1, 1.0)
    r3, v3 = rootfind.solve_cubic(c2 / sc1, c3 / sc1, c4 / sc1)
    r3 = jnp.concatenate([r3, jnp.zeros((4, 1))], axis=-1)
    v3 = jnp.concatenate([v3, jnp.zeros((4, 1), bool)], axis=-1)
    roots = jnp.where(quart[:, None], r4, r3.astype(r4.dtype)).astype(jnp.float32)
    rvalid = jnp.where(quart[:, None], v4, v3)

    in_window = rvalid & (roots > t1) & (roots < t2)
    any_hit = jnp.any(in_window)
    # increasing depth: collision time = max root (deepest); else min root
    t_inc = jnp.where(in_window, roots, -jnp.inf).max()
    t_dec = jnp.where(in_window, roots, jnp.inf).min()
    t_col = jnp.where(increasing, t_inc, t_dec)
    return any_hit, t_col


def is_collision_free(params: PlannerParams, pyrs: PyramidSet, tr_one,
                      enabled=True):
    """Pyramid-partition collision check of one camera-frame candidate.

    Returns a bool. See collision_check for the full-result variant."""
    free, _, _, _ = collision_check(params, pyrs, tr_one, enabled)
    return free


def collision_check(params: PlannerParams, pyrs: PyramidSet, tr_one,
                    enabled=True):
    """Pyramid-partition collision check of one camera-frame candidate.

    Fixed-capacity redesign of IsCollisionFree (cpp:214-301): a bounded loop
    pops monotone sections from a stack; each pop either resolves the
    section inside a pyramid or splits off the out-of-pyramid remainder.
    A section whose deepest point has no containing pyramid marks the
    trajectory as colliding — and its deepest point is *returned* so the
    caller can lazily inflate a pyramid there and re-check, reproducing the
    reference's on-demand inflation (DepthImagePlanner.cpp:270-273).

    enabled=False skips all work (used to re-check only failed candidates).
    Returns (free, fail_px, fail_py, fail_depth): the pixel + depth of the
    first uncovered section's deepest point (0s when none).
    """
    t1s, t2s, valid = monotonic_sections(tr_one)

    stack_t1 = t1s
    stack_t2 = t2s
    stack_live = valid & jnp.asarray(enabled)

    def cond(st):
        i, live, _, _, status, _ = st
        return (i < MAX_CHECK_ITERS) & jnp.any(live) & (status == 0)

    slot_iota = jnp.arange(MAX_SECTIONS)
    pyr_iota = jnp.arange(pyrs.depth.shape[0])

    def body(st):
        i, live, t1s, t2s, status, fail = st
        # pop the live section with the deepest endpoint... reference pops
        # sorted-by-deepest; order only affects pyramid reuse, not result.
        # One-hot select/update throughout: dynamic indexing lowers to
        # gather/scatter under vmap over candidates and dominated the check.
        idx = jnp.argmax(live)
        oh = slot_iota == idx
        t1 = jnp.where(oh, t1s, 0.0).sum()
        t2 = jnp.where(oh, t2s, 0.0).sum()

        z1 = _z_at(tr_one, t1)
        z2 = _z_at(tr_one, t2)
        increasing = z1 < z2
        deep_t = jnp.where(increasing, t2, t1)
        start_z = jnp.minimum(z1, z2)
        deep_z = jnp.maximum(z1, z2)

        # skip sections fully closer than the min checking distance
        skip = (z1 < params.min_check_dist) & (z2 < params.min_check_dist)

        # deepest point pixel
        pos_deep = jnp.stack(
            [
                tr_one.p0[0] + tr_one.v0[0] * deep_t + tr_one.a0[0] * deep_t**2 / 2
                + tr_one.gamma[0] * deep_t**3 / 6 + tr_one.beta[0] * deep_t**4 / 24
                + tr_one.alpha[0] * deep_t**5 / 120,
                tr_one.p0[1] + tr_one.v0[1] * deep_t + tr_one.a0[1] * deep_t**2 / 2
                + tr_one.gamma[1] * deep_t**3 / 6 + tr_one.beta[1] * deep_t**4 / 24
                + tr_one.alpha[1] * deep_t**5 / 120,
                deep_z,
            ]
        )
        px, py = project(params.cam, pos_deep)
        found, pidx = find_containing_pyramid(pyrs, px, py, deep_z)

        # no pyramid -> collision (conservative); remember where, so the
        # caller can inflate a pyramid there on demand
        no_cover = ~skip & ~found
        status2 = jnp.where(no_cover, jnp.int32(2), status)
        fail = jax.tree_util.tree_map(
            lambda f, v: jnp.where(no_cover & (status == 0), v, f),
            fail, (px, py, deep_z),
        )

        oh_p = pyr_iota == pidx
        normals = jnp.where(oh_p[:, None, None], pyrs.normals, 0.0).sum(0)
        hit, t_col = _deepest_collision_time(tr_one, normals, t1, t2, increasing)

        # remainder section outside the pyramid
        new_t1 = jnp.where(increasing, t1, t_col)
        new_t2 = jnp.where(increasing, t_col, t2)
        push = ~skip & found & hit & ((new_t2 - new_t1) > 1e-6)
        # write remainder into the freed slot
        t1s2 = jnp.where(oh & push, new_t1, t1s)
        t2s2 = jnp.where(oh & push, new_t2, t2s)
        live3 = jnp.where(oh, push, live)

        return (i + 1, live3, t1s2, t2s2, status2, fail)

    zf = jnp.float32(0.0)
    i, live, _, _, status, fail = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), stack_live, stack_t1, stack_t2, jnp.int32(0),
         (zf, zf, zf)),
    )
    # unresolved sections after the iteration cap: conservative collision
    unresolved = jnp.any(live)
    free = (status == 0) & ~unresolved
    return free, fail[0], fail[1], fail[2]


# =============================================================================
# full planner
# =============================================================================


class PlanResult(NamedTuple):
    found: jnp.ndarray  # bool
    best_idx: jnp.ndarray  # int32 into the candidate batch
    best_cost: jnp.ndarray
    traj: traj_mod.Traj  # the selected candidate (zeros if none)
    # diagnostics (planner_statistics parity)
    num_candidates: jnp.ndarray
    num_feasible: jnp.ndarray  # input-feasible
    num_velocity_admissible: jnp.ndarray
    num_collision_free: jnp.ndarray
    num_pyramids: jnp.ndarray


def plan_debug(params: PlannerParams, depth_u16, key, vel0, acc0, grav,
               goal_cam, n_candidates=512, pyramid_capacity=32, rounds=2,
               inflation_downsample=1, cost_fn=None, lazy_rounds=1,
               samples=None):
    """plan() with per-candidate internals exposed: returns
    (tr, cost, feas, vel_ok, gate, collision_free, pyrs). Supports explicit
    candidate injection via samples=(px, py, depth, tf)."""
    return _plan_core(
        params, depth_u16, key, vel0, acc0, grav, goal_cam, n_candidates,
        pyramid_capacity, rounds, inflation_downsample, cost_fn, lazy_rounds,
        samples=samples,
    )


def plan(params: PlannerParams, depth_u16, key, vel0, acc0, grav, goal_cam,
         n_candidates=512, pyramid_capacity=32, rounds=2,
         inflation_downsample=1, cost_fn=None, lazy_rounds=1):
    """One planning call: sample, gate, build pyramids, pick the best.

    All arguments are camera-frame (the caller rotates world state by the
    camera attitude, as in Rappids_Simulator/main.cpp:489-495).
    cost_fn: optional Traj -> (N,) costs; defaults to the goal-progress
    exploration cost using goal_cam.
    lazy_rounds: extra pyramid rounds seeded from the uncovered deepest
    points of failed candidates (the reference's on-demand inflation,
    DepthImagePlanner.cpp:270-273). The pyramid capacity is split across
    rounds + lazy_rounds.
    """
    tr, cost, feas, vel_ok, gate, collision_free, pyrs = _plan_core(
        params, depth_u16, key, vel0, acc0, grav, goal_cam, n_candidates,
        pyramid_capacity, rounds, inflation_downsample, cost_fn, lazy_rounds,
    )
    ok = gate & collision_free
    best_cost = jnp.where(ok, cost, jnp.inf)
    best_idx = jnp.argmin(best_cost)
    found = jnp.any(ok)

    best_traj = jax.tree_util.tree_map(lambda x: x[best_idx], tr)
    return PlanResult(
        found=found,
        best_idx=best_idx,
        best_cost=best_cost[best_idx],
        traj=best_traj,
        num_candidates=jnp.int32(n_candidates),
        num_feasible=feas.sum().astype(jnp.int32),
        num_velocity_admissible=(feas & vel_ok).sum().astype(jnp.int32),
        num_collision_free=ok.sum().astype(jnp.int32),
        num_pyramids=pyrs.valid.sum().astype(jnp.int32),
    )


LAZY_DEDUPE_PX = 8  # seeds closer than this (px, both axes) duplicate
LAZY_DEDUPE_Z_QUANTA = 2.0  # ... when their depths are within this many codes


def _greedy_seed_dedupe(px, py, z, valid, tol_px, tol_z):
    """Greedy first-wins dedupe of inflation seeds ordered by priority.

    Seed j is dropped when an earlier KEPT seed i < j lies within tol_px
    pixels on both axes and tol_z meters in depth — such pairs inflate to
    near-identical pyramids, and the reference's on-demand inflation never
    builds two pyramids at the same point (DepthImagePlanner.cpp:270-273:
    each failed check donates one seed, then re-checks against the grown
    set before donating again). Sequential by construction (a dropped seed
    must not suppress its own neighbors), but K is tiny: a K-step
    fori_loop on (K,) masks.
    """
    close = (
        (jnp.abs(px[:, None] - px[None, :]) <= tol_px)
        & (jnp.abs(py[:, None] - py[None, :]) <= tol_px)
        & (jnp.abs(z[:, None] - z[None, :]) <= tol_z)
    )
    later = jnp.arange(px.shape[0])[None, :] > jnp.arange(px.shape[0])[:, None]

    def body(j, keep):
        return keep & ~(keep[j] & close[j] & later[j])

    return jax.lax.fori_loop(0, px.shape[0], body, valid)


def candidates_from_samples(params: PlannerParams, px, py, depth, tf,
                            vel0, acc0):
    """Build the candidate set from explicit (pixel, depth, duration)
    samples — the exact construction of sample_candidates (and of the
    reference's GetNextCandidateTrajectory, hpp:393-404) minus the RNG.
    Used by the C++-planner-oracle head-to-head harness to evaluate both
    planners on an identical candidate list."""
    n = px.shape[0]
    goal = deproject(params.cam, jnp.asarray(px, jnp.float32),
                     jnp.asarray(py, jnp.float32),
                     jnp.asarray(depth, jnp.float32))
    p0 = jnp.zeros((n, 3), jnp.float32)
    v0 = jnp.broadcast_to(jnp.asarray(vel0, jnp.float32), (n, 3))
    a0 = jnp.broadcast_to(jnp.asarray(acc0, jnp.float32), (n, 3))
    zero = jnp.zeros((n, 3), jnp.float32)
    return traj_mod.generate(p0, v0, a0, jnp.asarray(tf, jnp.float32),
                             goal_pos=goal, goal_vel=zero, goal_acc=zero)


def _plan_core(params, depth_u16, key, vel0, acc0, grav, goal_cam,
               n_candidates, pyramid_capacity, rounds, inflation_downsample,
               cost_fn, lazy_rounds, samples=None):
    """Shared planning pipeline: sample, gate, pyramid rounds (pre-planned
    + lazy on-demand), collision labels. Returns
    (tr, cost, feas, vel_ok, gate, collision_free, pyrs).

    samples: optional explicit (px, py, depth, tf) arrays overriding the
    random sampler (candidate-injection for oracle comparisons)."""
    if samples is not None:
        tr = candidates_from_samples(params, *samples, vel0, acc0)
        n_candidates = samples[0].shape[0]
    else:
        tr = sample_candidates(params, key, n_candidates, vel0, acc0, grav)
    if cost_fn is None:
        cost = exploration_cost(tr, jnp.asarray(goal_cam, jnp.float32))
    else:
        cost = cost_fn(tr)

    feas = traj_mod.check_input_feasibility(
        tr, grav, params.fmin, params.fmax, params.wmax,
        float(params.min_section_time),
        # sampler durations are U(2,3) s, so dyadic levels whose sections
        # are provably narrower than min_section_time for tf <= 3 never
        # need evaluating (identical verdicts, ~75% fewer section checks)
        static_max_tf=3.0,
    )
    vel_ok = traj_mod.check_velocity_feasibility(tr, params.vmax)
    gate = feas & vel_ok

    # pyramid seeds: endpoints of the cheapest gated candidates
    end = traj_mod.position(tr, tr.tf)
    epx, epy = project(params.cam, end)
    order = jnp.argsort(jnp.where(gate, cost, jnp.inf))

    pyrs = empty_pyramid_set(pyramid_capacity)
    per_round = pyramid_capacity // (rounds + lazy_rounds)

    for rnd in range(rounds):
        take = order[rnd * per_round : (rnd + 1) * per_round]
        seed_valid = gate[take]
        if rnd > 0:
            # skip seeds already covered by an existing pyramid
            f, _ = jax.vmap(lambda x, y, d: find_containing_pyramid(pyrs, x, y, d))(
                epx[take], epy[take], end[take][:, 2]
            )
            seed_valid = seed_valid & ~f
        new_pyrs = build_pyramid_set(
            params, depth_u16, epx[take], epy[take], end[take][:, 2],
            seed_valid, per_round, downsample=inflation_downsample,
        )
        pyrs = merge_pyramid_sets(pyrs, new_pyrs) if rnd > 0 else merge_pyramid_sets(
            empty_pyramid_set(pyramid_capacity - per_round), new_pyrs
        )

    collision_free, fail_px, fail_py, fail_z = jax.vmap(
        lambda i: collision_check(params, pyrs, jax.tree_util.tree_map(lambda x: x[i], tr))
    )(jnp.arange(n_candidates))

    # on-demand rounds (DepthImagePlanner.cpp:270-273 lazy inflation): the
    # cheapest gated candidates that failed for lack of a *covering pyramid*
    # donate their uncovered deepest points as new inflation seeds, then
    # only the failed candidates are re-checked against the enlarged set.
    img_i = depth_u16.astype(jnp.int32)
    ignore_i = (params.true_radius / params.cam.depth_scale).astype(jnp.int32)

    for _ in range(lazy_rounds):
        failed = gate & ~collision_free & (fail_z > 0)
        # exact seed pre-filter: a fail point whose own pixel is blocked
        # shallower than the required pyramid depth can never inflate (the
        # genuinely-colliding candidates fail exactly this way), so don't
        # let them crowd the cheap end of the seed ordering
        pxi = jnp.clip(fail_px.astype(jnp.int32), 0, params.cam.width - 1)
        pyi = jnp.clip(fail_py.astype(jnp.int32), 0, params.cam.height - 1)
        seed_code = img_i[pyi, pxi]
        minpyr_i = (
            (fail_z + params.cam.depth_scale + params.plan_radius)
            / params.cam.depth_scale
        ).astype(jnp.int32)
        seedable = failed & ((seed_code <= ignore_i) | (seed_code >= minpyr_i))
        order2 = jnp.argsort(jnp.where(seedable, cost, jnp.inf))
        # consider 4x more candidate fail points than slots — most raw fail
        # points sit right next to the obstacle that failed them and can
        # never inflate. Inflation dominates lazy-plan time, so don't pay
        # an inflation per raw fail point: kill provably-doomed seeds
        # with the sound prefilter, greedy-dedupe near-identical survivors
        # (cheapest wins), then compact to the front and inflate only
        # 2x per_round of them.
        take = order2[: 4 * per_round]
        seed_valid = seedable[take]
        covered, _ = jax.vmap(
            lambda x, y, d: find_containing_pyramid(pyrs, x, y, d)
        )(fail_px[take], fail_py[take], fail_z[take])
        seed_valid = seed_valid & ~covered
        px_t, py_t, z_t = fail_px[take], fail_py[take], fail_z[take]
        # seed depth = the uncovered point's depth plus one depth-code
        # quantum: inflate floors (min_depth + plan_radius)/scale to an
        # int code, so without the bump the pyramid base can land just
        # below fail_z and find_containing_pyramid still misses
        seed_depth = z_t + params.cam.depth_scale
        seed_valid = prefilter_seeds(
            params, depth_u16, px_t, py_t, seed_depth, seed_valid,
            downsample=inflation_downsample,
        )
        keep = _greedy_seed_dedupe(
            px_t, py_t, z_t, seed_valid, jnp.float32(LAZY_DEDUPE_PX),
            LAZY_DEDUPE_Z_QUANTA * params.cam.depth_scale,
        )
        sel = jnp.argsort(~keep, stable=True)[: 2 * per_round]
        new_pyrs = build_pyramid_set(
            params, depth_u16, px_t[sel], py_t[sel],
            seed_depth[sel], keep[sel], per_round,
            downsample=inflation_downsample,
        )
        pyrs = merge_pyramid_sets(pyrs, new_pyrs)
        refree, fail_px2, fail_py2, fail_z2 = jax.vmap(
            lambda i: collision_check(
                params, pyrs, jax.tree_util.tree_map(lambda x: x[i], tr),
                enabled=failed[i])
        )(jnp.arange(n_candidates))
        collision_free = jnp.where(failed, refree, collision_free)
        fail_px = jnp.where(failed, fail_px2, fail_px)
        fail_py = jnp.where(failed, fail_py2, fail_py)
        fail_z = jnp.where(failed, fail_z2, fail_z)

    return tr, cost, feas, vel_ok, gate, collision_free, pyrs


# =============================================================================
# self-evaluation harnesses (MeasureConservativeness /
# MeasureCollisionCheckingSpeed parity, DepthImagePlanner.cpp:972-1029)
# =============================================================================


def measure_conservativeness(params: PlannerParams, depth_u16, key, vel0,
                             acc0, grav, n_traj=128, pyramid_limit=32):
    """Section IV.A of the RAPPIDS paper: how many trajectories does the
    pyramid checker mislabel as in-collision vs the ray-sphere oracle?

    Returns (num_incorrect_in_collision, num_correct_in_collision).
    """
    import jax as _jax

    from agrifly_tpu.planner import oracle as _oracle

    tr = sample_candidates(params, key, n_traj, vel0, acc0, grav)
    end = traj_mod.position(tr, tr.tf)
    epx, epy = project(params.cam, end)
    pyrs = build_pyramid_set(
        params, depth_u16, epx, epy, end[:, 2],
        jnp.ones((n_traj,), bool), pyramid_limit,
    )
    free_planner = _jax.vmap(
        lambda i: is_collision_free(
            params, pyrs, _jax.tree_util.tree_map(lambda x: x[i], tr))
    )(jnp.arange(n_traj))
    free_oracle = _jax.vmap(
        lambda i: _oracle.is_collision_free_ground_truth(
            params, depth_u16, _jax.tree_util.tree_map(lambda x: x[i], tr))
    )(jnp.arange(n_traj))

    collides_planner = ~free_planner
    collides_oracle = ~free_oracle
    num_correct = jnp.sum(collides_planner & collides_oracle)
    num_incorrect = jnp.sum(collides_planner & ~collides_oracle)
    return num_incorrect.astype(jnp.int32), num_correct.astype(jnp.int32)


def measure_plan_conservativeness(params: PlannerParams, depth_u16, key, vel0,
                                  acc0, grav, goal_cam, n_candidates=256,
                                  pyramid_capacity=32, rounds=2,
                                  lazy_rounds=1, inflation_downsample=1):
    """plan()-level conservativeness vs the ray-sphere oracle.

    Unlike measure_conservativeness (which seeds pyramids from every
    candidate's own endpoint), this uses plan()'s real round structure, so
    it quantifies what the lazy on-demand rounds buy: candidates the planner
    mislabels in-collision *because no pyramid covered a section*.

    Returns (num_incorrect_in_collision, num_correct_in_collision,
    num_collision_free) as int32 scalars.
    """
    import jax as _jax

    from agrifly_tpu.planner import oracle as _oracle

    tr, cost, feas, vel_ok, gate, collision_free, pyrs = _plan_core(
        params, depth_u16, key, vel0, acc0, grav, goal_cam, n_candidates,
        pyramid_capacity, rounds, inflation_downsample, None, lazy_rounds,
    )
    free_oracle = _jax.vmap(
        lambda i: _oracle.is_collision_free_ground_truth(
            params, depth_u16, _jax.tree_util.tree_map(lambda x: x[i], tr))
    )(jnp.arange(n_candidates))

    collides_planner = gate & ~collision_free
    collides_oracle = ~free_oracle
    num_incorrect = jnp.sum(collides_planner & ~collides_oracle)
    num_correct = jnp.sum(collides_planner & collides_oracle)
    num_free = jnp.sum(gate & collision_free)
    return (num_incorrect.astype(jnp.int32), num_correct.astype(jnp.int32),
            num_free.astype(jnp.int32))


def measure_collision_checking_speed(params: PlannerParams, depth_u16, key,
                                     vel0, acc0, grav, n_traj=1024,
                                     pyramid_limit=32):
    """Section IV.B parity: wall-clock of the batched collision check.

    Returns (seconds_total, seconds_per_trajectory, pyramids_used). The
    pyramid build is timed separately from the checks, mirroring the
    reference's exclusion of pyramid-generation time.
    """
    import time as _time

    import jax as _jax

    tr = sample_candidates(params, key, n_traj, vel0, acc0, grav)
    end = traj_mod.position(tr, tr.tf)
    epx, epy = project(params.cam, end)

    build = _jax.jit(
        lambda img: build_pyramid_set(
            params, img, epx, epy, end[:, 2], jnp.ones((n_traj,), bool),
            pyramid_limit,
        )
    )
    pyrs = _jax.block_until_ready(build(depth_u16))

    check = _jax.jit(
        lambda p: _jax.vmap(
            lambda i: is_collision_free(
                params, p, _jax.tree_util.tree_map(lambda x: x[i], tr))
        )(jnp.arange(n_traj))
    )
    _jax.block_until_ready(check(pyrs))  # compile
    t0 = _time.perf_counter()
    out = _jax.block_until_ready(check(pyrs))
    dt = _time.perf_counter() - t0
    return dt, dt / n_traj, int(pyrs.valid.sum())


def exploration_direction_cost(tr: traj_mod.Traj, direction):
    """Direction-based cost (DepthImagePlanner.hpp:486-515 default variant
    used by FindFastestTrajRandomCandidates): reward distance traveled along
    `direction` per unit time."""
    d = jnp.asarray(direction, jnp.float32)
    d = d / jnp.linalg.norm(d)
    end = traj_mod.position(tr, tr.tf)
    return -(end * d).sum(-1) / tr.tf


def find_fastest_trajectory(params: PlannerParams, depth_u16, key, vel0, acc0,
                            grav, exploration_direction, n_candidates=512,
                            pyramid_capacity=32, rounds=2,
                            inflation_downsample=1):
    """FindFastestTrajRandomCandidates parity: plan with the direction cost."""
    return plan(
        params, depth_u16, key, vel0, acc0, grav,
        goal_cam=jnp.zeros(3, jnp.float32),
        n_candidates=n_candidates, pyramid_capacity=pyramid_capacity,
        rounds=rounds, inflation_downsample=inflation_downsample,
        cost_fn=lambda tr: exploration_direction_cost(tr, exploration_direction),
    )
