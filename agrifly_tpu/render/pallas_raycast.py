"""Pallas (Triton) kernel for the orchard depth raycaster on the GPU.

The jnp renderer (render/raycast.py) carries five (H, W) arrays through
its DDA scan and writes them to device memory on every step. Here one
program renders a (BH, BW) pixel tile with the whole DDA in registers:
ray directions from the tile's pixel indices, the camera pose loaded from
its batch row, the 8-step DDA unrolled, and one store of the output codes.
The work is elementwise fp32 (no tensor cores, no shared memory).

Grid = (B, Hp/BH, Wp/BW) over the image padded up to whole tiles; the
wrapper slices the padding off. The scene is baked in as Python floats.
Math is identical to raycast.render_depth (same orchard hash, same
intersection tests); tests/test_render.py checks it in interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.render import orchard as orch
from agrifly_tpu.render.raycast import BIG, RenderConfig, camera_attitude

# pixel tile and warps per program: 512 pixels on 256 threads, 2 pixels a
# thread (the fastest of benchmarks/gpu_bringup.py's tile sweep on an H100)
BH = 4
BW = 128
NUM_WARPS = 8
POSE_WIDTH = 16  # [px, py, pz, R00..R22], zero-padded to a power of two


def _tree_hit_tile(scene: orch.OrchardParams, ix, iy, o, d):
    """Intersect rays with the tree of cell (ix, iy). All args per-pixel
    2-D arrays; o/d are tuples of 3 arrays. Returns t (BIG when no hit)."""
    f = orch.tree_fields(scene, ix, iy)
    ox, oy, oz = o
    dx, dy, dz = d

    # trunk cylinder
    rx = ox - f["cx"]
    ry = oy - f["cy"]
    a = dx * dx + dy * dy
    b = 2.0 * (rx * dx + ry * dy)
    c = rx * rx + ry * ry - f["trunk_r"] * f["trunk_r"]
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a > 1e-12, a, 1.0)
    t0 = (-b - sq) / (2.0 * a_safe)
    t1 = (-b + sq) / (2.0 * a_safe)
    t = jnp.where(t0 > 0, t0, t1)
    z = oz + t * dz
    t_trunk = jnp.where(ok & (t > 0) & (z >= 0.0) & (z <= f["trunk_h"]), t, BIG)

    def sphere(cx, cy, cz, radius):
        sx = ox - cx
        sy = oy - cy
        sz = oz - cz
        a2 = dx * dx + dy * dy + dz * dz
        b2 = 2.0 * (sx * dx + sy * dy + sz * dz)
        c2 = sx * sx + sy * sy + sz * sz - radius * radius
        disc2 = b2 * b2 - 4.0 * a2 * c2
        ok2 = disc2 >= 0
        sq2 = jnp.sqrt(jnp.maximum(disc2, 0.0))
        s0 = (-b2 - sq2) / (2.0 * a2)
        s1 = (-b2 + sq2) / (2.0 * a2)
        s = jnp.where(s0 > 0, s0, s1)
        return jnp.where(ok2 & (s > 0), s, BIG)

    t_c1 = sphere(f["cx"], f["cy"], f["can_h"], f["can_r"])
    t_c2 = sphere(f["c2x"], f["c2y"], f["c2z"], f["c2r"])
    t = jnp.minimum(t_trunk, jnp.minimum(t_c1, t_c2))
    return jnp.where(f["present"], t, BIG)


def _kernel(pose_ref, out_ref, *, cfg: RenderConfig,
            scene: orch.OrchardParams, bh: int, bw: int):
    """pose_ref: this batch row's (1, POSE_WIDTH) pose; out_ref: its
    (1, bh, bw) tile of depth codes."""
    ti = pl.program_id(1)
    tj = pl.program_id(2)

    px = pose_ref[0, 0]
    py = pose_ref[0, 1]
    pz = pose_ref[0, 2]
    R = [[pose_ref[0, 3 + 3 * i + j] for j in range(3)] for i in range(3)]

    shape = (bh, bw)
    rows = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + ti * bh
    cols = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + tj * bw
    row = (rows.astype(jnp.float32) - cfg.height / 2.0) / cfg.focal
    col = (cols.astype(jnp.float32) - cfg.width / 2.0) / cfg.focal

    # world ray dir = R @ (col, row, 1)
    dx = R[0][0] * col + R[0][1] * row + R[0][2]
    dy = R[1][0] * col + R[1][1] * row + R[1][2]
    dz = R[2][0] * col + R[2][1] * row + R[2][2]

    ox = jnp.full(shape, px)
    oy = jnp.full(shape, py)
    oz = jnp.full(shape, pz)

    # ground plane
    dz_safe = jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
    t_ground = -oz / dz_safe
    best = jnp.where((t_ground > 0) & (dz != 0), t_ground, BIG)

    # DDA setup
    sx = scene.tree_spacing
    sy = scene.row_spacing
    fx = ox / sx
    fy = oy / sy
    ix = jnp.floor(fx).astype(jnp.int32)
    iy = jnp.floor(fy).astype(jnp.int32)
    gdx = dx / sx
    gdy = dy / sy
    step_x = jnp.where(gdx >= 0, 1, -1).astype(jnp.int32)
    step_y = jnp.where(gdy >= 0, 1, -1).astype(jnp.int32)
    inv_dx = 1.0 / jnp.where(jnp.abs(gdx) < 1e-9, jnp.where(gdx >= 0, 1e-9, -1e-9), gdx)
    inv_dy = 1.0 / jnp.where(jnp.abs(gdy) < 1e-9, jnp.where(gdy >= 0, 1e-9, -1e-9), gdy)
    next_x = (ix.astype(jnp.float32) + (step_x > 0) - fx) * inv_dx
    next_y = (iy.astype(jnp.float32) + (step_y > 0) - fy) * inv_dy
    t_dx = jnp.abs(inv_dx)
    t_dy = jnp.abs(inv_dy)

    o = (ox, oy, oz)
    d = (dx, dy, dz)
    for _ in range(cfg.dda_steps):
        t = _tree_hit_tile(scene, ix, iy, o, d)
        best = jnp.minimum(best, t)
        go_x = next_x <= next_y
        ix = jnp.where(go_x, ix + step_x, ix)
        iy = jnp.where(go_x, iy, iy + step_y)
        next_x = jnp.where(go_x, next_x + t_dx, next_x)
        next_y = jnp.where(go_x, next_y, next_y + t_dy)

    scale = cfg.far / 256.0
    code = jnp.floor(best / scale).astype(jnp.int32)
    out_ref[0] = jnp.clip(code, 0, 255)


def _static_scene(scene: orch.OrchardParams) -> orch.OrchardParams:
    """The scene as Python numbers (a kernel cannot capture traced values)."""
    return orch.OrchardParams(
        row_spacing=float(scene.row_spacing),
        tree_spacing=float(scene.tree_spacing),
        presence=float(scene.presence),
        jitter=float(scene.jitter),
        trunk_radius=float(scene.trunk_radius),
        trunk_height=float(scene.trunk_height),
        canopy_radius=float(scene.canopy_radius),
        canopy_height=float(scene.canopy_height),
        seed=int(scene.seed),
        clear_radius=float(scene.clear_radius),
    )


def _pose_rows(cam_pos, cam_att):
    """(B, POSE_WIDTH) f32 rows [pos, R row-major, 0...] for the kernel."""
    B = cam_pos.shape[0]
    Rm = rot.to_matrix(cam_att).reshape(B, 9)
    rows = jnp.concatenate(
        [cam_pos.astype(jnp.float32), Rm.astype(jnp.float32)], axis=1)
    return jnp.pad(rows, ((0, 0), (0, POSE_WIDTH - rows.shape[1])))


def render_depth_batch(cfg: RenderConfig, scene: orch.OrchardParams,
                       cam_pos, cam_att, *, bh: int = BH, bw: int = BW,
                       num_warps: int = NUM_WARPS, interpret: bool = False):
    """Render a batch of frames. cam_pos (B, 3), cam_att (B, 4) world-from-
    camera quaternions. Returns (B, H, W) int32 codes."""
    B = cam_pos.shape[0]
    H, W = cfg.height, cfg.width
    Hp = -(-H // bh) * bh
    Wp = -(-W // bw) * bw
    kernel = functools.partial(_kernel, cfg=cfg, scene=_static_scene(scene),
                               bh=bh, bw=bw)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, Hp, Wp), jnp.int32),
        grid=(B, Hp // bh, Wp // bw),
        in_specs=[pl.BlockSpec((1, POSE_WIDTH), lambda b, i, j: (b, 0))],
        out_specs=pl.BlockSpec((1, bh, bw), lambda b, i, j: (b, i, j)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="orchard_raycast",
    )(_pose_rows(cam_pos, cam_att))
    if (Hp, Wp) != (H, W):
        out = out[:, :H, :W]
    return out


def render_depth_body_batch(cfg: RenderConfig, scene: orch.OrchardParams,
                            body_pos, body_att, **kw):
    """Batch render from vehicle poses (applies the depth-camera mount)."""
    cam_att = jax.vmap(camera_attitude)(body_att)
    return render_depth_batch(cfg, scene, body_pos, cam_att, **kw)
