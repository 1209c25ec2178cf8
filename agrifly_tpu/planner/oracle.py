"""Ground-truth collision oracle: ray-sphere test against every pixel.

jnp port of DepthImagePlanner::IsCollisionFreeGroundTruth
(DepthImagePlanner.cpp:1031-1098): discretize the trajectory at 0.1 s; a
sample collides if any depth pixel's back-projected point is in front of
(or inside) the vehicle sphere along a ray that pierces the sphere. FOV
margins and the min-checking-distance skip match the reference. Slow but
fully vmappable — the correctness anchor for the pyramid planner's
conservativeness (MeasureConservativeness parity, cpp:972-1002).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from agrifly_tpu.planner import rappids, traj as traj_mod
from agrifly_tpu.planner.rappids import HIGHEST

TIMESTEP = 0.1
MAX_SAMPLES = 31  # ceil(3 s / 0.1 s) + 1


def is_collision_free_ground_truth(params: rappids.PlannerParams, depth_u16,
                                   tr_one: traj_mod.Traj):
    """True if the trajectory is collision-free per the ray-sphere oracle."""
    cam = params.cam
    W, H = cam.width, cam.height
    img = depth_u16.astype(jnp.float32)

    ignore = params.true_radius / cam.depth_scale
    edge_off = cam.focal * params.true_radius / params.min_check_dist

    ts = jnp.arange(MAX_SAMPLES, dtype=jnp.float32) * TIMESTEP
    t_ok = ts < tr_one.tf

    # position() broadcasts: tr_one leaves (3,) with ts (S,) -> (S, 3)
    pos = traj_mod.position(tr_one, ts)
    z = pos[:, 2]
    active = t_ok & (z >= params.min_check_dist)

    # FOV check
    px, py = rappids.project(cam, pos)
    fov_bad = active & (
        (px <= edge_off) | (px > W - edge_off) | (py <= edge_off) | (py > H - edge_off)
    )
    any_fov_bad = jnp.any(fov_bad)

    # pixel rays: (H, W, 3) unit vectors
    xs = (jnp.arange(W, dtype=jnp.float32) - cam.cx) / cam.focal
    ys = (jnp.arange(H, dtype=jnp.float32) - cam.cy) / cam.focal
    ex, ey = jnp.meshgrid(xs, ys)
    e = jnp.stack([ex, ey, jnp.ones_like(ex)], axis=-1)
    e = e / jnp.linalg.norm(e, axis=-1, keepdims=True)

    pix_valid = img > ignore
    pix_depth = img * cam.depth_scale  # z-depth of the pixel point
    # back-projected pixel point distance from the origin along its ray:
    # point = depth * ((x-cx)/f, (y-cy)/f, 1), norm = depth * |(u, v, 1)|
    ray_norm = jnp.sqrt(ex * ex + ey * ey + 1.0)
    pix_dist = pix_depth * ray_norm

    r2 = params.plan_radius**2

    def sample_collides(p, a):
        d = jnp.einsum("hwc,c->hw", e, p, precision=HIGHEST)  # e . trajPos
        under = d * d - jnp.dot(p, p, precision=HIGHEST) + r2
        hits_sphere = under >= 0
        second = d + jnp.sqrt(jnp.maximum(under, 0.0))
        blocked = pix_valid & hits_sphere & (pix_dist < second)
        return a & jnp.any(blocked)

    collides = jax.vmap(sample_collides)(pos, active)
    return ~(jnp.any(collides) | any_fov_bad)
