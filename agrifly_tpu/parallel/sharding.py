"""Multi-card scale-out: shard the env axis over a device mesh.

The reference's only parallel dimension is the vehicle/env batch (SURVEY.md
§2 "Parallelism & distribution"): envs never communicate, so scale-out is
embarrassingly parallel — the env axis shards over the devices and the only
collectives are fleet-metric reductions (psum/pmean). This module builds the
mesh, places batched state on it, and wraps the fused sim step in shard_map
with a cross-device metrics reduction. The mesh is flat (one axis): the
cards of a host are joined all to all, so no device order is better than
another.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from agrifly_tpu.sim import env as env_mod

ENV_AXIS = "env"


def make_mesh(devices=None) -> Mesh:
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices).reshape(-1), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for batched env state pytrees."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_fleet(params, mesh: Mesh, n_envs: int, base_seed: int = 0):
    """Batched env states sharded over the mesh (n_envs % n_devices == 0)."""
    keys = jax.random.split(jax.random.PRNGKey(base_seed), n_envs)
    states = jax.vmap(lambda k: env_mod.init_state(params, k))(keys)
    shard = env_sharding(mesh)
    return jax.device_put(states, jax.tree_util.tree_map(lambda _: shard, states))


class FleetMetrics(NamedTuple):
    """Cross-fleet reductions (psums over the mesh)."""

    mean_pos: jnp.ndarray  # (3,)
    mean_speed: jnp.ndarray  # scalar
    num_panicked: jnp.ndarray  # int32
    max_tilt_cos: jnp.ndarray  # scalar: worst (most tilted) cos(tilt)


def _local_step(params, states, cmds, n_env_total, n_substeps,
                use_estimator=False):
    """Per-shard body: scan the fused step, then psum fleet metrics."""

    def body(carry, _):
        new_states, _ = jax.vmap(env_mod.step, in_axes=(None, 0, 0, None))(
            params, carry, cmds, use_estimator)
        return new_states, None

    states, _ = jax.lax.scan(body, states, None, length=n_substeps)

    from agrifly_tpu.ops import rotation as rot

    up_z = jax.vmap(lambda q: rot.rotate(q, jnp.array([0.0, 0.0, 1.0], jnp.float32))[2])(
        states.plant.att
    )
    inv_n = 1.0 / n_env_total
    metrics = FleetMetrics(
        mean_pos=jax.lax.psum(states.plant.pos.sum(0) * inv_n, ENV_AXIS),
        mean_speed=jax.lax.psum(
            jnp.linalg.norm(states.plant.vel, axis=-1).sum() * inv_n, ENV_AXIS
        ),
        num_panicked=jax.lax.psum(
            (states.logic.fs == 3).sum().astype(jnp.int32), ENV_AXIS
        ),
        max_tilt_cos=-jax.lax.pmax(-up_z.min(), ENV_AXIS),
    )
    return states, metrics


def make_fleet_step(params, mesh: Mesh, n_envs: int, n_substeps: int = 1,
                    use_estimator=False):
    """jitted (states, cmds) -> (states, FleetMetrics), env axis sharded.

    use_estimator: False (perfect state), "mocap", or "gpsimu" — the same
    modes as env.step; estimator state shards with the env axis (it is
    per-vehicle), so the estimator-in-the-loop configs scale over the mesh
    identically to perfect-state."""
    spec_env = P(ENV_AXIS)

    fn = jax.shard_map(
        partial(_local_step, params, n_env_total=n_envs, n_substeps=n_substeps,
                use_estimator=use_estimator),
        mesh=mesh,
        in_specs=(spec_env, spec_env),
        out_specs=(spec_env, P()),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=0)


# =============================================================================
# Multi-chip RAPPIDS: shard the candidate axis over the mesh
# =============================================================================
#
# For a single vehicle planning with very large candidate batches, the
# planner itself scales across chips: each device samples and gates its own
# candidate shard and inflates pyramids from its local best seeds; the
# pyramid sets are all_gathered (small: P x ~20 floats) so every device
# checks its candidates against the union; the global argmin rides a pmin.
# Collectives: one all_gather + two pmin/psum-class reductions per plan.


def make_sharded_planner(planner_params, mesh: Mesh, n_candidates: int,
                         pyramid_capacity: int = 32, inflation_downsample: int = 2):
    """Returns jitted (depth_u16, key, vel0, acc0, grav, goal_cam) -> PlanResult
    with the candidate axis sharded over the mesh."""
    from agrifly_tpu.planner import rappids, traj as traj_mod

    n_dev = mesh.devices.size
    assert n_candidates % n_dev == 0 and pyramid_capacity % n_dev == 0
    n_local = n_candidates // n_dev
    p_local = pyramid_capacity // n_dev

    def local_plan(depth_u16, keys, vel0, acc0, grav, goal_cam):
        key = keys[0]  # this device's key (sharded (D,2) -> local (1,2))
        tr = rappids.sample_candidates(
            planner_params, key, n_local, vel0, acc0, grav
        )
        cost = rappids.exploration_cost(tr, goal_cam)
        feas = traj_mod.check_input_feasibility(
            tr, grav, planner_params.fmin, planner_params.fmax,
            planner_params.wmax, float(planner_params.min_section_time),
        )
        vel_ok = traj_mod.check_velocity_feasibility(tr, planner_params.vmax)
        gate = feas & vel_ok

        end = traj_mod.position(tr, tr.tf)
        epx, epy = rappids.project(planner_params.cam, end)
        order = jnp.argsort(jnp.where(gate, cost, jnp.inf))[:p_local]
        local_pyrs = rappids.build_pyramid_set(
            planner_params, depth_u16, epx[order], epy[order],
            end[order][:, 2], gate[order], p_local,
            downsample=inflation_downsample,
        )

        # union of all devices' pyramids (sorted by depth, same on all)
        gathered = jax.lax.all_gather(local_pyrs, ENV_AXIS)  # leaves: (D, p_local, ...)
        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]), gathered
        )
        srt = jnp.argsort(jnp.where(flat.valid, flat.depth, jnp.inf))
        pyrs = jax.tree_util.tree_map(lambda x: x[srt], flat)

        collision_free = jax.vmap(
            lambda i: rappids.is_collision_free(
                planner_params, pyrs, jax.tree_util.tree_map(lambda x: x[i], tr))
        )(jnp.arange(n_local))

        ok = gate & collision_free
        masked = jnp.where(ok, cost, jnp.inf)
        local_best = masked.min()
        local_idx = jnp.argmin(masked)
        local_traj = jax.tree_util.tree_map(lambda x: x[local_idx], tr)

        # global winner: pmin the cost, then psum-select the winning traj
        global_best = jax.lax.pmin(local_best, ENV_AXIS)
        i_win = (local_best == global_best) & jnp.isfinite(global_best)
        # break ties: lowest device index wins
        my_rank = jax.lax.axis_index(ENV_AXIS)
        win_rank = jax.lax.pmin(jnp.where(i_win, my_rank, jnp.int32(2**30)), ENV_AXIS)
        i_win = i_win & (my_rank == win_rank)
        wtraj = jax.tree_util.tree_map(
            lambda x: jax.lax.psum(jnp.where(i_win, x, jnp.zeros_like(x)), ENV_AXIS),
            local_traj,
        )
        found = jnp.isfinite(global_best)
        stats = (
            jax.lax.psum(feas.sum().astype(jnp.int32), ENV_AXIS),
            jax.lax.psum((feas & vel_ok).sum().astype(jnp.int32), ENV_AXIS),
            jax.lax.psum(ok.sum().astype(jnp.int32), ENV_AXIS),
            jax.lax.psum(local_pyrs.valid.sum().astype(jnp.int32), ENV_AXIS),
        )
        return rappids.PlanResult(
            found=found,
            best_idx=jnp.int32(0),
            best_cost=global_best,
            traj=wtraj,
            num_candidates=jnp.int32(n_candidates),
            num_feasible=stats[0],
            num_velocity_admissible=stats[1],
            num_collision_free=stats[2],
            num_pyramids=stats[3],
        )

    spec_rep = P()
    fn = jax.shard_map(
        local_plan,
        mesh=mesh,
        in_specs=(spec_rep, P(ENV_AXIS), spec_rep, spec_rep, spec_rep, spec_rep),
        out_specs=spec_rep,
        check_vma=False,
    )

    def run(depth_u16, key, vel0, acc0, grav, goal_cam):
        keys = jax.random.split(key, n_dev)
        return fn(depth_u16, keys, vel0, acc0, grav, goal_cam)

    return jax.jit(run)


# =============================================================================
# Multi-chip full perception-plan-act: shard the orchard fleet over the mesh
# =============================================================================
#
# Config #4 (BASELINE.md) at chip scale: N independent vehicles each flying
# the complete render -> RAPPIDS -> track frame, the vehicle axis sharded
# over the mesh. Vehicles never communicate (SURVEY §2), so each device
# renders/plans/tracks its own shard and the only collectives are the
# fleet-metric psums.


class OrchardFleetMetrics(NamedTuple):
    mean_pos: jnp.ndarray  # (3,)
    num_panicked: jnp.ndarray  # int32
    num_plans: jnp.ndarray  # int32: successful plans fleet-wide
    num_landed: jnp.ndarray  # int32


def init_orchard_fleet(params, mesh: Mesh, n_envs: int, base_seed: int = 0,
                       lane_spacing: float = 3.0):
    """Batched orchard states abreast in y, sharded over the mesh."""
    from agrifly_tpu.sim import orchard_env

    keys = jax.random.split(jax.random.PRNGKey(base_seed), n_envs)
    lanes = (jnp.arange(n_envs, dtype=jnp.float32) - (n_envs - 1) / 2.0) * lane_spacing
    spawns = jnp.stack([jnp.zeros(n_envs), lanes, jnp.zeros(n_envs)], axis=1)
    states = jax.vmap(lambda k, p: orchard_env.init_state(params, k, pos=p))(
        keys, spawns)
    shard = env_sharding(mesh)
    return jax.device_put(
        states, jax.tree_util.tree_map(lambda _: shard, states))


def make_orchard_fleet_step(params, mesh: Mesh, n_envs: int,
                            n_frames: int = 1):
    """jitted states -> (states, OrchardFleetMetrics): `n_frames` full
    perception-plan-act frames per call, env axis sharded over the mesh.

    Each shard runs frame_step_fleet (jax.vmap(frame_step)) on its local
    vehicle block."""
    from agrifly_tpu.sim import orchard_env

    def local(states):
        def body(carry, _):
            s, _outs = orchard_env.frame_step_fleet(params, carry)
            return s, None

        states, _ = jax.lax.scan(body, states, None, length=n_frames)
        inv_n = 1.0 / n_envs
        metrics = OrchardFleetMetrics(
            mean_pos=jax.lax.psum(states.base.plant.pos.sum(0) * inv_n, ENV_AXIS),
            num_panicked=jax.lax.psum(
                (states.base.logic.panic_reason != 0).sum().astype(jnp.int32),
                ENV_AXIS),
            num_plans=jax.lax.psum(states.plan_count.sum().astype(jnp.int32),
                                   ENV_AXIS),
            num_landed=jax.lax.psum(
                (states.mstage == 2).sum().astype(jnp.int32), ENV_AXIS),
        )
        return states, metrics

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=P(ENV_AXIS),
        out_specs=(P(ENV_AXIS), P()), check_vma=False,
    )
    return jax.jit(fn, donate_argnums=0)
