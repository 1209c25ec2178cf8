"""On-device pinhole depth renderer: per-pixel 2D grid march over the orchard.

Replaces the AirSim/Unity render RPC (msgpack-RPC :41451, SURVEY.md L6)
with a jitted raycaster: every pixel's ray marches through the orchard's
(x, y) grid cells with a fixed-step 2D DDA; each visited cell contributes
one trunk-cylinder and two canopy-sphere intersections. Depth is *planar*
(distance along the optical axis), matching Unity's DepthVis; the output is
the uint8-style code the reference consumes (depth / (far/256), 255 = no
hit within the far plane — Rappids_Simulator/main.cpp:120-122).

Camera convention matches the demo (main.cpp:123-126): the depth camera is
mounted body-forward via depthCamAtt = FromEulerYPR(-90deg, 0, -90deg), so
camera +z looks along body +x, +x is body -y, +y is body -z (image down).

Cost: pixels x DDA_STEPS x ~3 quadratics -> pure elementwise arithmetic,
no gather, no host round-trip, fully fused under jit and vmappable over
fleet poses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu import backend
from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.render import orchard as orch

# depth camera mounting (Rappids_Simulator/main.cpp:123-126)
DEPTH_CAM_YPR = (-math.pi / 2.0, 0.0, -math.pi / 2.0)

BIG = 1e9

# full-f32 products: a GPU may otherwise run f32 matmuls in TF32
HIGHEST = jax.lax.Precision.HIGHEST


class RenderConfig(NamedTuple):
    width: int
    height: int
    focal: float
    far: float
    dda_steps: int  # static number of grid-cell visits per ray


def make_config(width=640, height=480, focal=None, far=10.0, dda_steps=8) -> RenderConfig:
    return RenderConfig(
        width=int(width), height=int(height),
        focal=float(focal if focal is not None else width / 2.0),
        far=float(far), dda_steps=int(dda_steps),
    )


def camera_attitude(body_att):
    """World-from-camera quaternion: body attitude composed with the mount."""
    mount = rot.from_euler_ypr(*DEPTH_CAM_YPR).astype(body_att.dtype)
    return rot.qmul(body_att, mount)


def _ray_dirs(cfg: RenderConfig):
    """Unnormalized camera-frame ray dirs (H, W, 3) with z == 1, so the ray
    parameter t equals planar depth."""
    xs = (jnp.arange(cfg.width, dtype=jnp.float32) - cfg.width / 2.0) / cfg.focal
    ys = (jnp.arange(cfg.height, dtype=jnp.float32) - cfg.height / 2.0) / cfg.focal
    ex, ey = jnp.meshgrid(xs, ys)
    return jnp.stack([ex, ey, jnp.ones_like(ex)], axis=-1)


def world_ray_dirs(cfg: RenderConfig, cam_att):
    """World-frame ray dirs (H, W, 3): R(cam_att) @ (x, y, 1) per pixel.
    The product is pinned to full f32 (a GPU may otherwise run it in
    TF32, ~1e-3 relative error in every ray)."""
    R = rot.to_matrix(cam_att)
    return jnp.einsum("ij,hwj->hwi", R, _ray_dirs(cfg), precision=HIGHEST)


def _cylinder_hit(o, d, cxy, r, h):
    """Smallest t > 0 with the ray inside the cylinder side surface."""
    ox, oy = o[..., 0] - cxy[..., 0], o[..., 1] - cxy[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a > 1e-12, a, 1.0)
    t0 = (-b - sq) / (2.0 * a_safe)
    t1 = (-b + sq) / (2.0 * a_safe)
    t = jnp.where(t0 > 0, t0, t1)
    z = o[..., 2] + t * d[..., 2]
    ok = ok & (t > 0) & (z >= 0.0) & (z <= h)
    return jnp.where(ok, t, BIG)


def _sphere_hit(o, d, c, r):
    oc = o - c
    a = (d * d).sum(-1)
    b = 2.0 * (oc * d).sum(-1)
    cc = (oc * oc).sum(-1) - r * r
    disc = b * b - 4.0 * a * cc
    ok = disc >= 0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t = jnp.where(t0 > 0, t0, t1)
    ok = ok & (t > 0)
    return jnp.where(ok, t, BIG)


def _tree_hit(tree: orch.TreeGeom, o, d):
    t_trunk = _cylinder_hit(o, d, tree.trunk_center, tree.trunk_radius, tree.trunk_height)
    t_c1 = _sphere_hit(o, d, tree.canopy_center, tree.canopy_radius)
    t_c2 = _sphere_hit(o, d, tree.canopy2_center, tree.canopy2_radius)
    t = jnp.minimum(t_trunk, jnp.minimum(t_c1, t_c2))
    return jnp.where(tree.present, t, BIG)


def render_depth(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """Render one depth frame.

    cam_pos: (3,) world camera position; cam_att: (4,) world-from-camera
    quaternion (see camera_attitude). Returns (H, W) int32 depth codes in
    [0, 255], 255 = beyond the far plane.
    """
    d = world_ray_dirs(cfg, cam_att)
    o = jnp.broadcast_to(cam_pos, d.shape)

    # ground plane z = 0
    dz = d[..., 2]
    t_ground = -o[..., 2] / jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
    t_ground = jnp.where((t_ground > 0) & (dz != 0), t_ground, BIG)
    best = t_ground

    # 2D DDA over orchard cells in the (x, y) plane
    sx = scene.tree_spacing
    sy = scene.row_spacing
    fx = o[..., 0] / sx
    fy = o[..., 1] / sy
    ix = jnp.floor(fx).astype(jnp.int32)
    iy = jnp.floor(fy).astype(jnp.int32)
    dx = d[..., 0] / sx
    dy = d[..., 1] / sy

    step_x = jnp.where(dx >= 0, 1, -1).astype(jnp.int32)
    step_y = jnp.where(dy >= 0, 1, -1).astype(jnp.int32)
    inv_dx = 1.0 / jnp.where(jnp.abs(dx) < 1e-9, jnp.where(dx >= 0, 1e-9, -1e-9), dx)
    inv_dy = 1.0 / jnp.where(jnp.abs(dy) < 1e-9, jnp.where(dy >= 0, 1e-9, -1e-9), dy)
    # t to the next cell boundary in each direction
    next_x = (ix.astype(jnp.float32) + (step_x > 0) - fx) * inv_dx
    next_y = (iy.astype(jnp.float32) + (step_y > 0) - fy) * inv_dy
    t_dx = jnp.abs(inv_dx)
    t_dy = jnp.abs(inv_dy)

    def visit(carry, _):
        ix, iy, next_x, next_y, best = carry
        tree = orch.tree_at_cell(scene, ix, iy)
        t = _tree_hit(tree, o, d)
        best = jnp.minimum(best, t)
        # advance to the neighboring cell with the nearer boundary
        go_x = next_x <= next_y
        ix = jnp.where(go_x, ix + step_x, ix)
        iy = jnp.where(go_x, iy, iy + step_y)
        next_x = jnp.where(go_x, next_x + t_dx, next_x)
        next_y = jnp.where(go_x, next_y, next_y + t_dy)
        return (ix, iy, next_x, next_y, best), None

    # single pass is exact: the orchard's tree-in-cell invariant guarantees
    # every tree's geometry lies inside its own cell (orchard.make_params)
    (_, _, _, _, best), _ = jax.lax.scan(
        visit, (ix, iy, next_x, next_y, best), None, length=cfg.dda_steps,
    )

    scale = cfg.far / 256.0
    code = jnp.floor(best / scale).astype(jnp.int32)
    return jnp.clip(code, 0, 255)


def render_depth_body(cfg: RenderConfig, scene: orch.OrchardParams,
                      body_pos, body_att):
    """Render from a vehicle pose (applies the depth-camera mount)."""
    return render_depth(cfg, scene, body_pos, camera_attitude(body_att))


def render_depth_batch(cfg: RenderConfig, scene: orch.OrchardParams,
                       cam_pos, cam_att):
    """The render entry of the flight loops: (B, 3) positions and (B, 4)
    world-from-camera quaternions -> (B, H, W) int32 codes. Runs the
    Pallas (Triton) kernel on a GPU and render_depth elsewhere."""
    if backend.gpu_raycast():
        from agrifly_tpu.render import pallas_raycast

        return pallas_raycast.render_depth_batch(cfg, scene, cam_pos, cam_att)
    return jax.vmap(lambda p, a: render_depth(cfg, scene, p, a))(cam_pos, cam_att)


# =============================================================================
# RGB rendering (the air_sim_bridge's second image stream)
# =============================================================================

MAT_SKY = 0
MAT_GROUND = 1
MAT_TRUNK = 2
MAT_CANOPY = 3

# material base colors (RGB, 0..1)
_COLORS = jnp.array(
    [
        [0.62, 0.78, 0.95],  # sky
        [0.45, 0.38, 0.25],  # orchard soil
        [0.35, 0.22, 0.12],  # trunk bark
        [0.18, 0.45, 0.15],  # canopy leaves
    ],
    jnp.float32,
)
_SUN = jnp.array([0.45, 0.2, 0.87], jnp.float32)  # unit-ish sun direction


def render_rgb(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """Shaded RGB frame from the same scene/geometry as the depth pass.

    Lambertian shading with analytic normals (ground +z, trunk radial,
    canopy sphere normals) and a simple sky. Returns (H, W, 3) uint8.
    Parity stand-in for the reference's Unity Scene image (ImageType 0).
    """
    d = world_ray_dirs(cfg, cam_att)
    o = jnp.broadcast_to(cam_pos, d.shape)

    dz = d[..., 2]
    t_ground = -o[..., 2] / jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
    t_ground = jnp.where((t_ground > 0) & (dz != 0), t_ground, BIG)

    best = t_ground
    mat = jnp.where(t_ground < BIG, MAT_GROUND, MAT_SKY).astype(jnp.int32)
    hit_ix = jnp.zeros(best.shape, jnp.int32)
    hit_iy = jnp.zeros(best.shape, jnp.int32)

    sx = scene.tree_spacing
    sy = scene.row_spacing
    fx = o[..., 0] / sx
    fy = o[..., 1] / sy
    ix = jnp.floor(fx).astype(jnp.int32)
    iy = jnp.floor(fy).astype(jnp.int32)
    gdx = d[..., 0] / sx
    gdy = d[..., 1] / sy
    step_x = jnp.where(gdx >= 0, 1, -1).astype(jnp.int32)
    step_y = jnp.where(gdy >= 0, 1, -1).astype(jnp.int32)
    inv_dx = 1.0 / jnp.where(jnp.abs(gdx) < 1e-9, jnp.where(gdx >= 0, 1e-9, -1e-9), gdx)
    inv_dy = 1.0 / jnp.where(jnp.abs(gdy) < 1e-9, jnp.where(gdy >= 0, 1e-9, -1e-9), gdy)
    next_x = (ix.astype(jnp.float32) + (step_x > 0) - fx) * inv_dx
    next_y = (iy.astype(jnp.float32) + (step_y > 0) - fy) * inv_dy
    t_dx = jnp.abs(inv_dx)
    t_dy = jnp.abs(inv_dy)

    def visit(carry, _):
        ix, iy, next_x, next_y, best, mat, hix, hiy = carry
        tree = orch.tree_at_cell(scene, ix, iy)
        t_trunk = _cylinder_hit(o, d, tree.trunk_center, tree.trunk_radius, tree.trunk_height)
        t_c1 = _sphere_hit(o, d, tree.canopy_center, tree.canopy_radius)
        t_c2 = _sphere_hit(o, d, tree.canopy2_center, tree.canopy2_radius)
        t_tree = jnp.minimum(t_trunk, jnp.minimum(t_c1, t_c2))
        t_tree = jnp.where(tree.present, t_tree, BIG)
        is_trunk = t_trunk <= jnp.minimum(t_c1, t_c2)
        closer = t_tree < best
        best = jnp.where(closer, t_tree, best)
        mat = jnp.where(closer, jnp.where(is_trunk, MAT_TRUNK, MAT_CANOPY), mat)
        hix = jnp.where(closer, ix, hix)
        hiy = jnp.where(closer, iy, hiy)
        go_x = next_x <= next_y
        ix = jnp.where(go_x, ix + step_x, ix)
        iy = jnp.where(go_x, iy, iy + step_y)
        next_x = jnp.where(go_x, next_x + t_dx, next_x)
        next_y = jnp.where(go_x, next_y, next_y + t_dy)
        return (ix, iy, next_x, next_y, best, mat, hix, hiy), None

    carry = (ix, iy, next_x, next_y, best, mat, hit_ix, hit_iy)
    (ix, iy, next_x, next_y, best, mat, hit_ix, hit_iy), _ = jax.lax.scan(
        visit, carry, None, length=cfg.dda_steps
    )

    # hit point + analytic normals
    hit = o + best[..., None] * d
    tree = orch.tree_at_cell(scene, hit_ix, hit_iy)
    n_ground = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), hit.shape)
    radial = hit[..., :2] - tree.trunk_center
    rn = jnp.linalg.norm(radial, axis=-1, keepdims=True)
    n_trunk = jnp.concatenate(
        [radial / jnp.where(rn < 1e-9, 1.0, rn), jnp.zeros_like(rn)], axis=-1
    )
    c1 = hit - tree.canopy_center
    c2 = hit - tree.canopy2_center
    use2 = (jnp.linalg.norm(c2, axis=-1) / jnp.maximum(tree.canopy2_radius, 1e-6)
            < jnp.linalg.norm(c1, axis=-1) / jnp.maximum(tree.canopy_radius, 1e-6))
    n_can = jnp.where(use2[..., None], c2, c1)
    nn = jnp.linalg.norm(n_can, axis=-1, keepdims=True)
    n_can = n_can / jnp.where(nn < 1e-9, 1.0, nn)

    normal = jnp.where(
        (mat == MAT_TRUNK)[..., None], n_trunk,
        jnp.where((mat == MAT_CANOPY)[..., None], n_can, n_ground),
    )
    sun = _SUN / jnp.linalg.norm(_SUN)
    lambert = jnp.clip((normal * sun).sum(-1), 0.0, 1.0)
    shade = 0.35 + 0.65 * lambert

    base = _COLORS[mat]
    # distance haze toward the sky color
    haze = jnp.clip(best / cfg.far, 0.0, 1.0)[..., None] * 0.35
    color = base * shade[..., None]
    color = jnp.where((mat == MAT_SKY)[..., None], _COLORS[MAT_SKY], color)
    color = color * (1 - haze) + _COLORS[MAT_SKY] * haze
    return jnp.clip(color * 255.0, 0, 255).astype(jnp.uint8)


def render_rgb_body(cfg: RenderConfig, scene: orch.OrchardParams, body_pos, body_att):
    return render_rgb(cfg, scene, body_pos, camera_attitude(body_att))
