"""Explicit (imported) scene geometry for the on-device renderers.

The procedural hashed orchard (render/orchard.py) covers the reference's
default world; this module adds the missing capability to *import* a given
world — a Helios-exported crop geometry, a surveyed orchard, any mesh —
and render/fly it (reference: the Unity world is a specific
Helios-generated almond orchard, README.md:98-104).

Scene = a flat table of primitives, three kinds:
    sphere    (cx, cy, cz, r)                    — canopy blobs
    cylinder  (cx, cy, z0, z1, r), axis +z       — trunks, posts
    triangle  (v0, e1, e2)                       — arbitrary mesh faces

Loaders: Wavefront OBJ (the format Helios' export plugin writes) and a
one-line-per-primitive text format for analytic shapes; `from_orchard`
bakes a rectangle of the procedural orchard into explicit primitives
(used to cross-validate the explicit renderer against the procedural one).

Design: instead of per-pixel grid-bucket *gathers* (lane-varying dynamic
indexing, which vmaps badly), rendering is two-phase:
  1. `select_window`: one (S,)-sized masked sort picks the <= capacity
     primitives within the far plane of the camera — tiny, once per frame;
  2. the raycaster scans the window rows (traced scalars per step) against
     all pixels — pure elementwise math, no gathers.
A depth camera with far = 10 m only ever sees a handful of trees, so a
window of 128-256 primitives loses nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.ops import rotation as rot
from agrifly_tpu import backend
from agrifly_tpu.render.raycast import (BIG, RenderConfig, camera_attitude,
                                        world_ray_dirs)

PRIM_NONE = 0.0
PRIM_SPHERE = 1.0
PRIM_CYLINDER = 2.0
PRIM_TRIANGLE = 3.0

ROW_WIDTH = 10  # [type, p0..p8]


class MeshScene(NamedTuple):
    """Flat primitive table + centroid/radius columns for windowing."""

    prims: jnp.ndarray  # (S, ROW_WIDTH) f32
    center_xy: jnp.ndarray  # (S, 2) XY centroid for distance windowing
    radius: jnp.ndarray  # (S,) bounding radius in XY
    count: int  # static number of real rows
    material: jnp.ndarray = None  # (S,) int32 raycast.MAT_* ids for the RGB
    # pass; None -> per-kind defaults (cylinder=trunk, sphere/tri=canopy)


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------


def build_scene(spheres=(), cylinders=(), triangles=(),
                sphere_mats=None, cylinder_mats=None,
                triangle_mats=None) -> MeshScene:
    """spheres: (cx, cy, cz, r); cylinders: (cx, cy, z0, z1, r);
    triangles: ((v0), (v1), (v2)) vertex triples in world frame.
    *_mats: optional per-primitive raycast.MAT_* ids for the RGB pass
    (defaults: cylinders are trunks, spheres/triangles canopy)."""
    import numpy as np

    from agrifly_tpu.render import raycast as rc

    rows, cxy, rad, mats = [], [], [], []
    for i, (cx, cy, cz, r) in enumerate(spheres):
        rows.append([PRIM_SPHERE, cx, cy, cz, r, 0, 0, 0, 0, 0])
        cxy.append([cx, cy])
        rad.append(r)
        mats.append(sphere_mats[i] if sphere_mats is not None else rc.MAT_CANOPY)
    for i, (cx, cy, z0, z1, r) in enumerate(cylinders):
        rows.append([PRIM_CYLINDER, cx, cy, z0, z1, r, 0, 0, 0, 0])
        cxy.append([cx, cy])
        rad.append(r)
        mats.append(cylinder_mats[i] if cylinder_mats is not None else rc.MAT_TRUNK)
    for i, (v0, v1, v2) in enumerate(triangles):
        v0 = np.asarray(v0, np.float64)
        e1 = np.asarray(v1, np.float64) - v0
        e2 = np.asarray(v2, np.float64) - v0
        rows.append([PRIM_TRIANGLE, *v0, *e1, *e2])
        c = v0 + (e1 + e2) / 3.0
        cxy.append([c[0], c[1]])
        rad.append(max(np.linalg.norm(e1[:2]), np.linalg.norm(e2[:2]),
                       np.linalg.norm((e1 - e2)[:2])))
        mats.append(triangle_mats[i] if triangle_mats is not None else rc.MAT_CANOPY)
    if not rows:
        raise ValueError("empty scene")
    return MeshScene(
        prims=jnp.asarray(np.asarray(rows, np.float32)),
        center_xy=jnp.asarray(np.asarray(cxy, np.float32)),
        radius=jnp.asarray(np.asarray(rad, np.float32)),
        count=len(rows),
        material=jnp.asarray(np.asarray(mats, np.int32)),
    )


def load_obj(path) -> MeshScene:
    """Wavefront OBJ triangles (polygon faces are fan-triangulated).
    This is the format Helios' geometry export writes."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    tris.append((verts[idx[0]], verts[idx[k]], verts[idx[k + 1]]))
    if not tris:
        raise ValueError(f"{path}: no faces found")
    return build_scene(triangles=tris)


def load_primitives(path) -> MeshScene:
    """Analytic-primitive text format, one per line:
        sphere cx cy cz r
        cylinder cx cy z0 z1 r
        tree x y trunk_r trunk_h canopy_cx canopy_cy canopy_cz canopy_r
    '#' comments and blank lines are skipped. `tree` expands to a trunk
    cylinder + canopy sphere (the orchard primitive pair)."""
    spheres, cylinders = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            kind, vals = parts[0], [float(x) for x in parts[1:]]
            if kind == "sphere" and len(vals) == 4:
                spheres.append(tuple(vals))
            elif kind == "cylinder" and len(vals) == 5:
                cylinders.append(tuple(vals))
            elif kind == "tree" and len(vals) == 8:
                x, y, tr, th, ccx, ccy, ccz, cr = vals
                cylinders.append((x, y, 0.0, th, tr))
                spheres.append((ccx, ccy, ccz, cr))
            else:
                raise ValueError(f"{path}:{lineno}: bad record {line!r}")
    return build_scene(spheres=spheres, cylinders=cylinders)


def from_orchard(scene, x_range, y_range) -> MeshScene:
    """Bake a rectangle of the procedural orchard (render/orchard.py) into
    explicit primitives — identical geometry, so the explicit renderer can
    be cross-validated pixel-for-pixel against the procedural one."""
    import numpy as np

    from agrifly_tpu.render import orchard as orch

    sx, sy = float(scene.tree_spacing), float(scene.row_spacing)
    spheres, cylinders = [], []
    for ix in range(int(math.floor(x_range[0] / sx)), int(math.ceil(x_range[1] / sx))):
        for iy in range(int(math.floor(y_range[0] / sy)), int(math.ceil(y_range[1] / sy))):
            f = orch.tree_fields(scene, jnp.int32(ix), jnp.int32(iy))
            if not bool(f["present"]):
                continue
            cylinders.append((float(f["cx"]), float(f["cy"]), 0.0,
                              float(f["trunk_h"]), float(f["trunk_r"])))
            spheres.append((float(f["cx"]), float(f["cy"]), float(f["can_h"]),
                            float(f["can_r"])))
            spheres.append((float(f["c2x"]), float(f["c2y"]), float(f["c2z"]),
                            float(f["c2r"])))
    return build_scene(spheres=spheres, cylinders=cylinders)


# ----------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------


def slant_factor(cfg: RenderConfig) -> float:
    """Max |ray dir| over the image for z-normalized dirs: a hit at planar
    depth `far` can be up to far * slant away euclidean (corner rays)."""
    ex = cfg.width / (2.0 * cfg.focal)
    ey = cfg.height / (2.0 * cfg.focal)
    return math.sqrt(1.0 + ex * ex + ey * ey)


def select_window(scene: MeshScene, cam_pos, reach_dist, capacity: int):
    """The <= capacity primitives whose XY footprint lies within
    `reach_dist` (euclidean) of the camera, nearest first; rows beyond are
    type NONE. Returns a (capacity, ROW_WIDTH) array — the only shape the
    renderer sees, so scenes of any size compile to the same program.

    reach_dist must cover the planar far plane along the most slanted ray:
    use cfg.far * slant_factor(cfg) (render_depth does)."""
    d = jnp.linalg.norm(scene.center_xy - cam_pos[:2][None, :], axis=-1)
    reach = d - scene.radius
    visible = reach < reach_dist
    order = jnp.argsort(jnp.where(visible, reach, jnp.inf))[:capacity]
    rows = scene.prims[order]
    ok = visible[order]
    return jnp.where(ok[:, None], rows, jnp.zeros_like(rows))


def row_bounding_spheres(window):
    """Conservative world-space bounding sphere per window row.

    window: (..., K, ROW_WIDTH). Returns (center (..., K, 3), radius
    (..., K)); rows of type NONE get radius -1 (never visible)."""
    kind = window[..., 0]
    p = window[..., 1:]
    is_s = kind == PRIM_SPHERE
    is_c = kind == PRIM_CYLINDER
    is_t = kind == PRIM_TRIANGLE

    # cylinder: center (x, y, (z0+z1)/2), r = sqrt(r^2 + ((z1-z0)/2)^2)
    half_h = (p[..., 3] - p[..., 2]) * 0.5
    c_r = jnp.sqrt(p[..., 4] ** 2 + half_h ** 2)
    # triangle: centroid v0 + (e1+e2)/3, r = max vertex distance
    g = (p[..., 3:6] + p[..., 6:9]) / 3.0
    d0 = jnp.linalg.norm(g, axis=-1)
    d1 = jnp.linalg.norm(p[..., 3:6] - g, axis=-1)
    d2 = jnp.linalg.norm(p[..., 6:9] - g, axis=-1)
    t_r = jnp.maximum(d0, jnp.maximum(d1, d2))

    cx = jnp.where(is_t, p[..., 0] + g[..., 0], p[..., 0])
    cy = jnp.where(is_t, p[..., 1] + g[..., 1], p[..., 1])
    cz = jnp.where(is_s, p[..., 2],
                   jnp.where(is_c, (p[..., 2] + p[..., 3]) * 0.5,
                             p[..., 2] + g[..., 2]))
    r = jnp.where(is_s, p[..., 3], jnp.where(is_c, c_r, t_r))
    r = jnp.where(kind == PRIM_NONE, -1.0, r * 1.001 + 1e-3)  # margin
    return jnp.stack([cx, cy, cz], axis=-1), r


def strip_windows(cfg: RenderConfig, window, cam_pos, cam_att, tile_h: int,
                  return_order: bool = False, far_clip: bool = True):
    """Per-strip compaction of a frame window for strip-tiled raycasters.

    For each tile_h-row strip of the image, conservatively tests every
    window row's bounding sphere against the strip's ray cone (5 halfspace
    tests — a convex superset of the cone, so no possibly-hitting row is
    ever dropped) and compacts the passing rows to the front.

    Returns (strips (T, K, ROW_WIDTH) with passing rows first, n_vis (T,)
    int32) — plus the (T, K) compaction order (original window row per
    compacted slot) when return_order is set, for winner-index passes. A
    strip-tiled renderer loops only n_vis[t] rows instead of K (typically
    a 3-6x cut: trees are narrow in ey)."""
    K = window.shape[0]
    T = cfg.height // tile_h
    center, radius = row_bounding_spheres(window)  # (K,3), (K,)

    # world -> camera. Broadcast-sum, not `@`: a (K,3)@(3,3) dot_general
    # may run in reduced precision on matrix units (TF32's ~0.1% error can
    # exceed the conservative margin and cull a grazing-but-hitting row);
    # this stays elementwise f32.
    R = rot.to_matrix(cam_att)
    d = center - cam_pos[None, :]  # (K,3)
    c = (d[:, :, None] * R[None, :, :]).sum(axis=1)  # c[k] = R^T (center_k - cam)
    ccx, ccy, ccz = c[..., 0], c[..., 1], c[..., 2]

    ex_min = -cfg.width / (2.0 * cfg.focal)
    ex_max = (cfg.width - 1 - cfg.width / 2.0) / cfg.focal
    ys = jnp.arange(T, dtype=jnp.float32) * tile_h
    ey_min = (ys - cfg.height / 2.0) / cfg.focal  # (T,)
    ey_max = (ys + tile_h - 1 - cfg.height / 2.0) / cfg.focal

    ok = radius >= 0
    ok &= ccz + radius > 0.0  # not fully behind the camera
    if far_clip:
        # depth-pass only: beyond far clips to code 255 anyway. The RGB
        # pass must keep these rows — a beyond-far hit still shades
        # (hazed), exactly like the plain scan renders it.
        ok &= ccz - radius <= cfg.far
    ok &= (ccx - ex_min * ccz) >= -radius * math.sqrt(1.0 + ex_min * ex_min)
    ok &= (ex_max * ccz - ccx) >= -radius * math.sqrt(1.0 + ex_max * ex_max)
    # per-strip vertical halfspaces: (T, K)
    sy_min = jnp.sqrt(1.0 + ey_min * ey_min)[:, None]
    sy_max = jnp.sqrt(1.0 + ey_max * ey_max)[:, None]
    vis = ok[None, :]
    vis = vis & ((ccy[None, :] - ey_min[:, None] * ccz[None, :]) >= -radius[None, :] * sy_min)
    vis = vis & ((ey_max[:, None] * ccz[None, :] - ccy[None, :]) >= -radius[None, :] * sy_max)

    # stable compaction: passing rows first, original order preserved
    order = jnp.argsort(~vis, axis=-1, stable=True)  # (T, K)
    strips = window[order]  # (T, K, ROW_WIDTH)
    # zero out the non-passing tail so its rows are type NONE
    keep = jnp.arange(K)[None, :] < vis.sum(-1)[:, None]
    strips = jnp.where(keep[:, :, None], strips, 0.0)
    if return_order:
        return strips, vis.sum(-1).astype(jnp.int32), order
    return strips, vis.sum(-1).astype(jnp.int32)


def _hit_row(row, o, d):
    """Planar-depth intersection of every ray with one primitive row.
    o, d: (..., 3) origins/dirs (d z-normalized in camera scale is NOT
    required: t is in units of |d| like the rest of the renderer)."""
    kind = row[0]
    p = row[1:]

    # sphere
    oc = o - p[0:3]
    a = (d * d).sum(-1)
    b = 2.0 * (oc * d).sum(-1)
    cc = (oc * oc).sum(-1) - p[3] * p[3]
    disc = b * b - 4.0 * a * cc
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t_s = jnp.where(t0 > 0, t0, t1)
    t_sphere = jnp.where((disc >= 0) & (t_s > 0), t_s, BIG)

    # z-axis cylinder (cx, cy, z0, z1, r)
    ox, oy = o[..., 0] - p[0], o[..., 1] - p[1]
    dx, dy = d[..., 0], d[..., 1]
    ca = dx * dx + dy * dy
    cb = 2.0 * (ox * dx + oy * dy)
    ccc = ox * ox + oy * oy - p[4] * p[4]
    cdisc = cb * cb - 4.0 * ca * ccc
    csq = jnp.sqrt(jnp.maximum(cdisc, 0.0))
    ca_safe = jnp.where(ca > 1e-12, ca, 1.0)
    ct0 = (-cb - csq) / (2.0 * ca_safe)
    ct1 = (-cb + csq) / (2.0 * ca_safe)
    t_c = jnp.where(ct0 > 0, ct0, ct1)
    z = o[..., 2] + t_c * d[..., 2]
    cyl_ok = (cdisc >= 0) & (ca > 1e-12) & (t_c > 0) & (z >= p[2]) & (z <= p[3])
    t_cyl = jnp.where(cyl_ok, t_c, BIG)

    # triangle (v0, e1, e2), Moller-Trumbore
    v0 = p[0:3]
    e1 = p[3:6]
    e2 = p[6:9]
    pv = jnp.cross(d, jnp.broadcast_to(e2, d.shape))
    det = (pv * e1).sum(-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tv = o - v0
    u = (tv * pv).sum(-1) * inv_det
    qv = jnp.cross(tv, jnp.broadcast_to(e1, tv.shape))
    v = (qv * d).sum(-1) * inv_det
    t_t = (qv * e2).sum(-1) * inv_det
    tri_ok = (jnp.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t_t > 0)
    t_tri = jnp.where(tri_ok, t_t, BIG)

    t = jnp.where(kind == PRIM_SPHERE, t_sphere,
                  jnp.where(kind == PRIM_CYLINDER, t_cyl,
                            jnp.where(kind == PRIM_TRIANGLE, t_tri, BIG)))
    return t


def render_depth_window(cfg: RenderConfig, window, cam_pos, cam_att,
                        chunk: int = 16):
    """Depth codes from a primitive window (see select_window).

    Same output contract as raycast.render_depth: (H, W) int32 codes in
    [0, 255], planar depth, far/256 scale, ground plane at z = 0.

    The scan goes `chunk` primitives per step — the (chunk, H, W) hit
    block is min-reduced before the (H, W) running minimum touches HBM
    again (one row per step round-tripped the full image through HBM per
    primitive, ~16x slower).
    """
    d = world_ray_dirs(cfg, cam_att)
    o = jnp.broadcast_to(cam_pos, d.shape)

    dz = d[..., 2]
    t_ground = -o[..., 2] / jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
    best0 = jnp.where((t_ground > 0) & (dz != 0), t_ground, BIG)

    capacity = window.shape[0]
    chunk = max(1, min(chunk, capacity))
    pad = (-capacity) % chunk  # zero rows are type NONE -> hit at BIG
    if pad:
        window = jnp.concatenate(
            [window, jnp.zeros((pad, window.shape[1]), window.dtype)], axis=0
        )
    chunks = window.reshape(-1, chunk, window.shape[1])

    def body(best, rows):
        hits = jax.vmap(lambda row: _hit_row(row, o, d))(rows)  # (chunk, H, W)
        return jnp.minimum(best, hits.min(axis=0)), None

    best, _ = jax.lax.scan(body, best0, chunks)

    scale = cfg.far / 256.0
    code = jnp.floor(best / scale).astype(jnp.int32)
    return jnp.clip(code, 0, 255)


def render_depth_window_strips(cfg: RenderConfig, window, cam_pos, cam_att,
                               tile_h: int = 16, chunk: int = 16):
    """Strip-culled variant of render_depth_window — same output, bit-exact.

    The plain window scan tests every window row against every pixel.
    This one runs the `strip_windows` compaction (passing rows first,
    conservative cone test) and, per tile_h-row strip, a while_loop over
    only ceil(n_vis/chunk) chunks — a real early exit (mean n_vis 5.4 of
    79 window rows on the baked orchard). Exactness: culling
    is conservative (no possibly-hitting row is dropped), skipped rows
    contribute only BIG to an order-independent min, and per-row hit math
    is unchanged. With the default chunk=16 (same chunk width as the
    plain path) outputs are bit-identical in practice and pinned by test;
    smaller chunks save another ~40% but XLA:CPU's different fusion
    shapes flip a handful of floor(t/scale) boundary pixels by +/-1 code.
    """
    H, W = cfg.height, cfg.width
    if H % tile_h:
        return render_depth_window(cfg, window, cam_pos, cam_att)
    T = H // tile_h
    K = window.shape[0]
    chunk = max(1, min(chunk, K))
    pad = (-K) % chunk  # zero rows are type NONE -> hit at BIG
    strips, n_vis = strip_windows(cfg, window, cam_pos, cam_att, tile_h)
    if pad:
        strips = jnp.concatenate(
            [strips, jnp.zeros((T, pad, strips.shape[2]), strips.dtype)],
            axis=1)

    d_full = world_ray_dirs(cfg, cam_att)
    o = jnp.broadcast_to(cam_pos, (tile_h, W, 3))

    dz_full = d_full[..., 2]
    t_ground = -cam_pos[2] / jnp.where(jnp.abs(dz_full) < 1e-9, 1e-9, dz_full)
    best0_full = jnp.where((t_ground > 0) & (dz_full != 0), t_ground, BIG)

    def strip_body(_, inp):
        t_idx, rows_t, nv = inp
        z = jnp.zeros((), t_idx.dtype)  # match index dtypes under x64
        d = jax.lax.dynamic_slice(
            d_full, (t_idx * tile_h, z, z), (tile_h, W, 3))
        best0 = jax.lax.dynamic_slice(
            best0_full, (t_idx * tile_h, z), (tile_h, W))
        n_chunks = (nv + chunk - 1) // chunk

        def cond(st):
            return st[0] < n_chunks

        def body(st):
            i, best = st
            rows = jax.lax.dynamic_slice(
                rows_t, (i * chunk, jnp.zeros((), i.dtype)),
                (chunk, rows_t.shape[1]))
            hits = jax.vmap(lambda row: _hit_row(row, o, d))(rows)
            return i + 1, jnp.minimum(best, hits.min(axis=0))

        _, best = jax.lax.while_loop(cond, body, (jnp.int32(0), best0))
        return None, best

    _, best = jax.lax.scan(
        strip_body, None,
        (jnp.arange(T, dtype=jnp.int32), strips, n_vis))

    scale = cfg.far / 256.0
    code = jnp.floor(best.reshape(H, W) / scale).astype(jnp.int32)
    return jnp.clip(code, 0, 255)


def render_depth(cfg: RenderConfig, scene: MeshScene, cam_pos, cam_att,
                 window_capacity: int = 192, strip_cull: bool | None = None):
    """select_window + window render in one call. strip_cull: True runs
    the strip-culled early-exit scan, False the plain full-window scan
    (outputs are bit-identical); None picks by backend (CPU -> strips)."""
    window = select_window(
        scene, cam_pos, cfg.far * slant_factor(cfg), window_capacity
    )
    if strip_cull is None:
        strip_cull = backend.strip_cull()
    if strip_cull:
        return render_depth_window_strips(cfg, window, cam_pos, cam_att)
    return render_depth_window(cfg, window, cam_pos, cam_att)


def render_depth_body(cfg: RenderConfig, scene: MeshScene, body_pos, body_att,
                      window_capacity: int = 192):
    return render_depth(cfg, scene, body_pos, camera_attitude(body_att),
                        window_capacity)


# ----------------------------------------------------------------------
# RGB pass (Scene-image parity for imported worlds)
# ----------------------------------------------------------------------


def render_rgb(cfg: RenderConfig, scene: MeshScene, cam_pos, cam_att,
               window_capacity: int = 192, chunk: int = 16,
               strip_cull: bool | None = None, tile_h: int = 16):
    """Shaded RGB frame of an imported world — the Scene-image counterpart
    of render_depth (reference: AirSimBridge publishes Unity Scene images
    of *the* world, AirSimBridge/main.cpp:77-93; previously only the
    procedural orchard had an RGB pass, raycast.render_rgb).

    Same windowed chunk-scan as the depth pass but tracking the winning
    primitive index; normals are analytic per kind (sphere radial,
    cylinder radial-xy, triangle face normal flipped toward the viewer,
    ground +z), materials come from the per-primitive `material` column,
    and the shading formula (Lambertian 0.35+0.65, sun, distance haze,
    sky) matches raycast.render_rgb exactly — a baked orchard renders the
    same picture through either path. Returns (H, W, 3) uint8.
    """
    from agrifly_tpu.render import raycast as rc

    d_w = jnp.linalg.norm(scene.center_xy - cam_pos[:2][None, :], axis=-1)
    reach = d_w - scene.radius
    visible = reach < cfg.far * slant_factor(cfg)
    order = jnp.argsort(jnp.where(visible, reach, jnp.inf))[:window_capacity]
    ok = visible[order]
    window = jnp.where(ok[:, None], scene.prims[order],
                       jnp.zeros_like(scene.prims[order]))
    if scene.material is not None:
        mats = jnp.where(ok, scene.material[order], rc.MAT_CANOPY)
    else:
        kinds = window[:, 0]
        mats = jnp.where(kinds == PRIM_CYLINDER, rc.MAT_TRUNK, rc.MAT_CANOPY)

    if strip_cull is None:
        strip_cull = backend.strip_cull()
    if strip_cull and cfg.height % tile_h == 0:
        return _render_rgb_strips(
            cfg, window, mats, cam_pos, cam_att, tile_h, chunk)

    d = world_ray_dirs(cfg, cam_att)
    o = jnp.broadcast_to(cam_pos, d.shape)

    dz = d[..., 2]
    t_ground = -o[..., 2] / jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
    t_ground = jnp.where((t_ground > 0) & (dz != 0), t_ground, BIG)

    capacity = window.shape[0]
    chunk = max(1, min(chunk, capacity))
    pad = (-capacity) % chunk
    if pad:
        window = jnp.concatenate(
            [window, jnp.zeros((pad, window.shape[1]), window.dtype)], axis=0)
    chunks = window.reshape(-1, chunk, window.shape[1])
    idx_chunks = jnp.arange(chunks.shape[0] * chunk,
                            dtype=jnp.int32).reshape(-1, chunk)

    def body(carry, x):
        best, best_idx = carry
        rows, idxs = x
        hits = jax.vmap(lambda row: _hit_row(row, o, d))(rows)  # (chunk,H,W)
        t_min = hits.min(axis=0)
        arg = hits.argmin(axis=0)
        win_idx = idxs[arg]  # (H, W): absolute window row of chunk winner
        closer = t_min < best
        return (jnp.where(closer, t_min, best),
                jnp.where(closer, win_idx, best_idx)), None

    (best, best_idx), _ = jax.lax.scan(
        body, (t_ground, jnp.full(t_ground.shape, -1, jnp.int32)),
        (chunks, idx_chunks))

    hit_prim = best_idx >= 0  # else ground (or sky if best >= BIG)
    row = window[jnp.clip(best_idx, 0, window.shape[0] - 1)]  # (H, W, 10)
    mat_prim = mats[jnp.clip(best_idx, 0, mats.shape[0] - 1)]
    return _shade(cfg, o, d, best, row, mat_prim, hit_prim)


def _shade(cfg: RenderConfig, o, d, best, row, mat_prim, hit_prim):
    """Shared shading tail of the RGB pass: analytic normals per kind,
    Lambertian 0.35+0.65 sun, distance haze, sky — identical for the
    plain and strip-culled winner-tracking scans (raycast.render_rgb
    formula). o/d: (H, W, 3) ray origins/dirs; best: (H, W) winning t;
    row: (H, W, 10) winning primitive row; mat_prim: (H, W) its material;
    hit_prim: (H, W) bool (else ground, or sky when best >= BIG)."""
    from agrifly_tpu.render import raycast as rc

    kind = row[..., 0]
    p = row[..., 1:]
    hit = o + best[..., None] * d

    # analytic normals per kind
    n_sphere = hit - p[..., 0:3]
    n_cyl = jnp.concatenate(
        [hit[..., 0:1] - p[..., 0:1], hit[..., 1:2] - p[..., 1:2],
         jnp.zeros_like(hit[..., 2:3])], axis=-1)
    n_tri = jnp.cross(p[..., 3:6], p[..., 6:9])
    # face the viewer
    n_tri = jnp.where(((n_tri * d).sum(-1) > 0)[..., None], -n_tri, n_tri)
    normal = jnp.where((kind == PRIM_SPHERE)[..., None], n_sphere,
                       jnp.where((kind == PRIM_CYLINDER)[..., None], n_cyl, n_tri))
    nn = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / jnp.where(nn < 1e-9, 1.0, nn)
    n_ground = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), hit.shape)
    normal = jnp.where(hit_prim[..., None], normal, n_ground)

    mat = jnp.where(hit_prim, mat_prim,
                    jnp.where(best < BIG, rc.MAT_GROUND, rc.MAT_SKY))

    sun = rc._SUN / jnp.linalg.norm(rc._SUN)
    lambert = jnp.clip((normal * sun).sum(-1), 0.0, 1.0)
    shade = 0.35 + 0.65 * lambert
    base = rc._COLORS[mat]
    haze = jnp.clip(best / cfg.far, 0.0, 1.0)[..., None] * 0.35
    color = base * shade[..., None]
    color = jnp.where((mat == rc.MAT_SKY)[..., None], rc._COLORS[rc.MAT_SKY], color)
    color = color * (1 - haze) + rc._COLORS[rc.MAT_SKY] * haze
    return jnp.clip(color * 255.0, 0, 255).astype(jnp.uint8)


def _render_rgb_strips(cfg: RenderConfig, window, mats, cam_pos, cam_att,
                       tile_h: int, chunk: int):
    """Strip-culled winner-tracking scan for the RGB pass — the depth
    pass's early-exit (render_depth_window_strips) with a compacted-slot
    winner index carried alongside the running min; the slot maps back to
    the original window row (material, primitive data) via the stable
    compaction order, so ties resolve in window order exactly like the
    plain scan. Same chunk=16 bit-exactness caveat, pinned by test."""
    H, W = cfg.height, cfg.width
    T = H // tile_h
    K = window.shape[0]
    chunk = max(1, min(chunk, K))
    pad = (-K) % chunk  # zero rows are type NONE -> hit at BIG, can't win
    strips, n_vis, order = strip_windows(
        cfg, window, cam_pos, cam_att, tile_h, return_order=True,
        far_clip=False)
    if pad:
        strips = jnp.concatenate(
            [strips, jnp.zeros((T, pad, strips.shape[2]), strips.dtype)],
            axis=1)

    d_full = world_ray_dirs(cfg, cam_att)
    o_strip = jnp.broadcast_to(cam_pos, (tile_h, W, 3))

    dz_full = d_full[..., 2]
    t_ground = -cam_pos[2] / jnp.where(jnp.abs(dz_full) < 1e-9, 1e-9, dz_full)
    best0_full = jnp.where((t_ground > 0) & (dz_full != 0), t_ground, BIG)

    def strip_body(_, inp):
        t_idx, rows_t, nv = inp
        z = jnp.zeros((), t_idx.dtype)
        d = jax.lax.dynamic_slice(
            d_full, (t_idx * tile_h, z, z), (tile_h, W, 3))
        best0 = jax.lax.dynamic_slice(
            best0_full, (t_idx * tile_h, z), (tile_h, W))
        n_chunks = (nv + chunk - 1) // chunk

        def cond(st):
            return st[0] < n_chunks

        def body(st):
            i, best, bloc = st
            rows = jax.lax.dynamic_slice(
                rows_t, (i * chunk, jnp.zeros((), i.dtype)),
                (chunk, rows_t.shape[1]))
            hits = jax.vmap(lambda row: _hit_row(row, o_strip, d))(rows)
            t_min = hits.min(axis=0)
            loc = i * chunk + hits.argmin(axis=0).astype(jnp.int32)
            closer = t_min < best
            return (i + 1, jnp.where(closer, t_min, best),
                    jnp.where(closer, loc, bloc))

        _, best, bloc = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), best0, jnp.full((tile_h, W), -1, jnp.int32)))
        return None, (best, bloc)

    _, (best, bloc) = jax.lax.scan(
        strip_body, None,
        (jnp.arange(T, dtype=jnp.int32), strips, n_vis))

    loc_c = jnp.clip(bloc, 0, strips.shape[1] - 1)  # (T, tile_h, W)
    row = jax.vmap(lambda s, l: s[l])(
        strips, loc_c.reshape(T, -1))  # (T, tile_h*W, ROW_WIDTH)
    row = row.reshape(H, W, strips.shape[2])
    gidx = jax.vmap(lambda o_, l: o_[l])(
        order, jnp.clip(loc_c, 0, K - 1).reshape(T, -1))  # original rows
    mat_prim = mats[gidx].reshape(H, W)

    o = jnp.broadcast_to(cam_pos, (H, W, 3))
    return _shade(cfg, o, d_full, best.reshape(H, W), row, mat_prim,
                  (bloc >= 0).reshape(H, W))


def render_rgb_body(cfg: RenderConfig, scene: MeshScene, body_pos, body_att,
                    window_capacity: int = 192):
    return render_rgb(cfg, scene, body_pos, camera_attitude(body_att),
                      window_capacity)
