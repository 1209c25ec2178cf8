"""Procedural almond-orchard scene.

Replaces the Unity + Helios render path (SURVEY.md L6): instead of meshes
pushed over RPC, the orchard is a *function* — trees live on a regular
row/column grid (as in a real orchard), and each grid cell's tree
parameters (presence, jitter, trunk radius/height, canopy radii) derive
from an integer hash of the cell coordinates. The renderer marches rays
through grid cells, so scene complexity is O(cells crossed), not O(trees),
and the orchard is unbounded with zero device memory.

Geometry per tree: one vertical trunk cylinder + two canopy spheres.
Ground plane at z = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class OrchardParams(NamedTuple):
    row_spacing: jnp.ndarray  # [m] distance between tree rows (y)
    tree_spacing: jnp.ndarray  # [m] distance between trees in a row (x)
    presence: jnp.ndarray  # probability a grid cell holds a tree
    jitter: jnp.ndarray  # [m] max |offset| of trunk from cell center
    trunk_radius: jnp.ndarray  # [m] mean trunk radius
    trunk_height: jnp.ndarray  # [m] mean trunk (bole) height
    canopy_radius: jnp.ndarray  # [m] mean canopy sphere radius
    canopy_height: jnp.ndarray  # [m] mean canopy center height
    seed: jnp.ndarray  # int32 world seed
    clear_radius: jnp.ndarray  # [m] no trees within this distance of origin


def make_params(row_spacing=6.0, tree_spacing=4.0, presence=0.95, jitter=0.3,
                trunk_radius=0.18, trunk_height=1.2, canopy_radius=1.35,
                canopy_height=2.6, seed=0, clear_radius=3.0) -> OrchardParams:
    """Tree-in-cell invariant: jitter + 1.3 * canopy_radius must stay below
    min(row_spacing, tree_spacing)/2 so every tree's geometry is contained
    in its own grid cell — this is what makes the renderer's single-pass
    DDA exact (each ray only needs to test the cells it crosses)."""
    extent = jitter + 1.2 * canopy_radius  # 1.2 = max per-tree size factor
    assert extent <= min(row_spacing, tree_spacing) / 2.0 + 1e-6, (
        f"tree extent {extent} overflows the grid cell; shrink canopy/jitter"
    )
    f32 = jnp.float32
    return OrchardParams(
        row_spacing=f32(row_spacing), tree_spacing=f32(tree_spacing),
        presence=f32(presence), jitter=f32(jitter),
        trunk_radius=f32(trunk_radius), trunk_height=f32(trunk_height),
        canopy_radius=f32(canopy_radius), canopy_height=f32(canopy_height),
        seed=jnp.int32(seed), clear_radius=f32(clear_radius),
    )


def _mix(h):
    h = h ^ (h >> 13)
    h = h * jnp.int32(1274126177)
    h = h ^ (h >> 16)
    return h


def cell_rand(ix, iy, seed, salt):
    """Deterministic uniform [0,1) from integer cell coords."""
    h = ix * jnp.int32(374761393) + iy * jnp.int32(668265263)
    h = h + seed * jnp.int32(974634599) + jnp.int32(salt) * jnp.int32(1446648)
    h = _mix(h)
    return (h & jnp.int32(0x7FFFFF)).astype(jnp.float32) / jnp.float32(0x800000)


class TreeGeom(NamedTuple):
    present: jnp.ndarray  # bool
    trunk_center: jnp.ndarray  # (2,) x, y
    trunk_radius: jnp.ndarray
    trunk_height: jnp.ndarray
    canopy_center: jnp.ndarray  # (3,)
    canopy_radius: jnp.ndarray
    canopy2_center: jnp.ndarray  # (3,) upper canopy sphere
    canopy2_radius: jnp.ndarray


def tree_fields(p: OrchardParams, ix, iy):
    """Unstacked per-cell tree parameters (keeps every array the pixel
    tile's shape inside the raycast kernel). Returns a dict of arrays
    broadcasting like ix/iy."""
    r0 = cell_rand(ix, iy, p.seed, 0)
    r1 = cell_rand(ix, iy, p.seed, 1)
    r2 = cell_rand(ix, iy, p.seed, 2)
    r3 = cell_rand(ix, iy, p.seed, 3)
    r4 = cell_rand(ix, iy, p.seed, 4)

    cx = (ix.astype(jnp.float32) + 0.5) * p.tree_spacing + (r1 - 0.5) * 2.0 * p.jitter
    cy = (iy.astype(jnp.float32) + 0.5) * p.row_spacing + (r2 - 0.5) * 2.0 * p.jitter

    present = (r0 < p.presence) & (jnp.sqrt(cx * cx + cy * cy) > p.clear_radius)

    size = 0.8 + 0.4 * r3  # per-tree scale factor
    can_r = p.canopy_radius * size
    can_h = p.canopy_height * size
    return dict(
        present=present,
        cx=cx, cy=cy,
        trunk_r=p.trunk_radius * size,
        trunk_h=p.trunk_height * size,
        can_r=can_r, can_h=can_h,
        c2x=cx + (r4 - 0.5) * 0.6,
        c2y=cy + (r2 - 0.5) * 0.6,
        c2z=can_h + 0.8 * can_r,
        c2r=can_r * 0.7,
    )


def tree_at_cell(p: OrchardParams, ix, iy) -> TreeGeom:
    """Tree parameters for grid cell (ix, iy). Broadcasts over cell arrays."""
    f = tree_fields(p, ix, iy)
    return TreeGeom(
        present=f["present"],
        trunk_center=jnp.stack([f["cx"], f["cy"]], axis=-1),
        trunk_radius=f["trunk_r"],
        trunk_height=f["trunk_h"],
        canopy_center=jnp.stack([f["cx"], f["cy"], f["can_h"]], axis=-1),
        canopy_radius=f["can_r"],
        canopy2_center=jnp.stack([f["c2x"], f["c2y"], f["c2z"]], axis=-1),
        canopy2_radius=f["c2r"],
    )
