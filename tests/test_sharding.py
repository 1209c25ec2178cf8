"""Multi-chip sharding on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from agrifly_tpu.parallel import sharding
from agrifly_tpu.sim import env as env_mod
import pytest


def test_fleet_step_on_8_device_mesh():
    assert jax.device_count() >= 8
    mesh = sharding.make_mesh(jax.devices()[:8])
    params = env_mod.make_params(noise_scale=1.0)
    n_envs = 32
    states = sharding.init_fleet(params, mesh, n_envs)
    cmd = env_mod.hover_command((0.0, 0.0, 1.0))
    cmds = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape), cmd
    )
    cmds = jax.device_put(
        cmds, jax.tree_util.tree_map(lambda _: sharding.env_sharding(mesh), cmds)
    )
    fleet_step = sharding.make_fleet_step(params, mesh, n_envs, n_substeps=3)
    states, metrics = fleet_step(states, cmds)
    jax.block_until_ready(metrics)
    assert metrics.mean_pos.shape == (3,)
    assert int(metrics.num_panicked) == 0
    assert float(metrics.max_tilt_cos) <= 1.0 + 1e-6


@pytest.mark.slow
def test_sharded_matches_single_device():
    mesh = sharding.make_mesh(jax.devices()[:8])
    params = env_mod.make_params(noise_scale=0.0)
    n_envs = 16
    cmd = env_mod.hover_command((0.0, 0.0, 1.0))
    cmds = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape), cmd
    )

    # sharded
    states_sh = sharding.init_fleet(params, mesh, n_envs)
    fleet_step = sharding.make_fleet_step(params, mesh, n_envs, n_substeps=10)
    states_sh, metrics = fleet_step(
        states_sh,
        jax.device_put(
            cmds, jax.tree_util.tree_map(lambda _: sharding.env_sharding(mesh), cmds)
        ),
    )

    # single device reference
    keys = jax.random.split(jax.random.PRNGKey(0), n_envs)
    states = jax.vmap(lambda k: env_mod.init_state(params, k))(keys)
    for _ in range(10):
        states, _ = jax.jit(jax.vmap(env_mod.step, in_axes=(None, 0, 0)))(
            params, states, cmds
        )

    np.testing.assert_allclose(
        np.asarray(states_sh.plant.pos), np.asarray(states.plant.pos), atol=1e-6
    )
    np.testing.assert_allclose(
        float(metrics.mean_speed),
        float(np.linalg.norm(np.asarray(states.plant.vel), axis=-1).mean()),
        rtol=1e-5,
    )


@pytest.mark.slow
def test_graft_entry_dryrun():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).resolve().parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


def test_sharded_planner_on_mesh():
    from agrifly_tpu.planner import rappids

    mesh = sharding.make_mesh(jax.devices()[:8])
    cam = rappids.make_camera(160, 120, focal=80.0, depth_scale=10 / 256)
    p = rappids.make_params(cam, 0.116, 0.174)
    f = sharding.make_sharded_planner(p, mesh, n_candidates=128, pyramid_capacity=16)
    img = jnp.full((120, 160), 230, jnp.int32)
    res = f(img, jax.random.PRNGKey(0), jnp.zeros(3), jnp.zeros(3),
            jnp.array([0.0, 9.81, 0.0]), jnp.array([0.0, 0.0, 20.0]))
    assert bool(res.found)
    assert int(res.num_collision_free) > 20
    assert float(res.best_cost) < 0
    # the winning trajectory is a valid primitive reaching ahead
    from agrifly_tpu.planner import traj as traj_mod

    end = np.asarray(traj_mod.position(res.traj, res.traj.tf))
    assert end[2] > 1.0  # forward in the camera frame


def test_estimator_mode_fleet_step_on_mesh():
    """Config #2 (estimator in the loop) sharded over the 8-device mesh:
    the per-vehicle mocap KF + prediction pipe shard with the env axis,
    and the sharded rollout matches an unsharded vmap rollout exactly."""
    mesh = sharding.make_mesh(jax.devices()[:8])
    params = env_mod.make_params(noise_scale=1.0)
    n_envs = 16
    states = sharding.init_fleet(params, mesh, n_envs)
    cmd = env_mod.hover_command((0.0, 0.0, 1.0))
    cmds = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape), cmd
    )
    cmds_sh = jax.device_put(
        cmds, jax.tree_util.tree_map(lambda _: sharding.env_sharding(mesh), cmds)
    )
    est_step = sharding.make_fleet_step(
        params, mesh, n_envs, n_substeps=10, use_estimator="mocap"
    )
    states_sh, metrics = est_step(states, cmds_sh)
    jax.block_until_ready(metrics)
    assert int(metrics.num_panicked) == 0

    # same 10 ticks unsharded
    ref = sharding.init_fleet(params, sharding.make_mesh(jax.devices()[:1]), n_envs)

    def unsharded(states):
        def body(c, _):
            s, _ = jax.vmap(env_mod.step, in_axes=(None, 0, 0, None))(
                params, c, cmds, "mocap")
            return s, None
        s, _ = jax.lax.scan(body, states, None, length=10)
        return s

    ref = jax.jit(unsharded)(ref)
    np.testing.assert_allclose(
        np.asarray(states_sh.plant.pos), np.asarray(ref.plant.pos),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(states_sh.mocap.pos), np.asarray(ref.mocap.pos),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.slow
def test_orchard_fleet_step_sharded_matches_vmap():
    """The FULL perception-plan-act frame (render + RAPPIDS + 16 tracked
    ticks) sharded over the 8-device mesh == plain vmap on one device:
    per-vehicle state equal, psum'd metrics consistent (config #4 at chip
    scale)."""
    from agrifly_tpu.sim import orchard_env

    mesh = sharding.make_mesh(jax.devices()[:8])
    params = orchard_env.make_params(
        width=96, height=72, n_candidates=32, pyramid_capacity=8,
        planner_rounds=1, start_flight_time=0.2)
    n_envs = 16
    states = sharding.init_orchard_fleet(params, mesh, n_envs, base_seed=5)
    step = sharding.make_orchard_fleet_step(params, mesh, n_envs, n_frames=2)

    states_ref = jax.device_get(states)  # host copy before donation
    states_out, metrics = step(states)
    jax.block_until_ready(metrics)

    # reference: same batched states, plain vmap, single device
    @jax.jit
    def vmap_step(s):
        def body(carry, _):
            s2, _ = jax.vmap(lambda st: orchard_env.frame_step(params, st))(carry)
            return s2, None
        return jax.lax.scan(body, s, None, length=2)[0]

    ref = jax.block_until_ready(vmap_step(
        jax.tree_util.tree_map(jnp.asarray, states_ref)))

    for i, (x, y) in enumerate(zip(jax.tree_util.tree_leaves(states_out),
                                   jax.tree_util.tree_leaves(ref))):
        x, y = np.asarray(x), np.asarray(y)
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-5,
                                       err_msg=f"leaf {i}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")

    # metrics agree with host-side reductions over the reference
    np.testing.assert_allclose(
        np.asarray(metrics.mean_pos),
        np.asarray(ref.base.plant.pos).mean(0), atol=1e-5)
    assert int(metrics.num_panicked) == int(
        (np.asarray(ref.base.logic.panic_reason) != 0).sum())
    assert int(metrics.num_plans) == int(np.asarray(ref.plan_count).sum())
