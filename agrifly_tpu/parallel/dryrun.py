"""Self-bootstrapping multi-chip dry run on a virtual CPU mesh.

The driver's multichip contract is: ``__graft_entry__.dryrun_multichip(n)``
must build an n-device ``jax.sharding.Mesh``, jit the full training/sim step
over it with real shardings, and run one step — from *any* ambient backend.
The ambient process may already have initialized a backend that cannot host
an n-device mesh, so the actual work runs in a fresh subprocess that forces
``JAX_PLATFORMS=cpu`` + ``--xla_force_host_platform_device_count=<n>``
before JAX initializes, mirroring tests/conftest.py.

Run directly:  python -m agrifly_tpu.parallel.dryrun 8
"""

from __future__ import annotations

import os
import re
import sys

ENVS_PER_DEVICE = 256
SUBSTEPS = 50


def _force_cpu_mesh(n_devices: int) -> None:
    """Point JAX at a virtual n-device CPU platform. Must run before any
    jax device query; safe even if the environment pinned another
    backend (the config update overrides the env-var pin)."""
    flags = os.environ.get("XLA_FLAGS", "")
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    # the environment may pin jax_platforms; the config wins.
    jax.config.update("jax_platforms", "cpu")


def run_dryrun(n_devices: int, envs_per_device: int = ENVS_PER_DEVICE,
               substeps: int = SUBSTEPS) -> None:
    """The actual dry run; assumes a working backend with >= n_devices.

    Exercises a non-toy shard: envs_per_device fused sim envs per device
    stepped `substeps` ticks under one shard_map'd scan (metric psums over
    the mesh), then the candidate-sharded RAPPIDS planner (all_gather of
    pyramid sets + pmin winner selection).
    """
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.parallel import sharding
    from agrifly_tpu.sim import env as env_mod

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devices)} on "
            f"{jax.default_backend()}"
        )
    mesh = sharding.make_mesh(devices)
    params = env_mod.make_params(noise_scale=1.0)

    n_envs = n_devices * envs_per_device
    states = sharding.init_fleet(params, mesh, n_envs)
    cmd = env_mod.hover_command((0.0, 0.0, 1.5))
    cmds = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape), cmd
    )
    cmds = jax.device_put(
        cmds, jax.tree_util.tree_map(lambda _: sharding.env_sharding(mesh), cmds)
    )

    fleet_step = sharding.make_fleet_step(params, mesh, n_envs, n_substeps=substeps)
    states, metrics = fleet_step(states, cmds)
    jax.block_until_ready(metrics)
    assert metrics.mean_pos.shape == (3,)
    assert int(metrics.num_panicked) == 0, (
        f"{int(metrics.num_panicked)} envs panicked during hover dryrun"
    )

    # estimator-in-the-loop (config #2) sharded over the same mesh: the
    # mocap KF + prediction-pipe state is per-vehicle, so it shards with
    # the env axis (fewer substeps: the estimator chain is the point here)
    states_est = sharding.init_fleet(params, mesh, n_envs)
    est_step = sharding.make_fleet_step(
        params, mesh, n_envs, n_substeps=max(1, substeps // 5),
        use_estimator="mocap",
    )
    states_est, metrics_est = est_step(states_est, cmds)
    jax.block_until_ready(metrics_est)
    assert int(metrics_est.num_panicked) == 0

    # candidate-sharded RAPPIDS planning across the same mesh
    from agrifly_tpu.planner import rappids

    cam = rappids.make_camera(160, 120, focal=80.0, depth_scale=10 / 256)
    pp = rappids.make_params(cam, 0.116, 0.174)
    planner = sharding.make_sharded_planner(
        pp, mesh, n_candidates=16 * n_devices,
        pyramid_capacity=2 * n_devices,
    )
    res = planner(
        jnp.full((120, 160), 230, jnp.int32), jax.random.PRNGKey(0),
        jnp.zeros(3), jnp.zeros(3), jnp.array([0.0, 9.81, 0.0]),
        jnp.array([0.0, 0.0, 20.0]),
    )
    jax.block_until_ready(res)
    assert bool(res.found), "sharded planner found no trajectory in open space"

    # the FULL perception-plan-act loop (render + RAPPIDS + tracked ticks)
    # sharded over the mesh — config #4 (BASELINE.md) at chip scale
    from agrifly_tpu.sim import orchard_env

    oparams = orchard_env.make_params(
        width=96, height=72, n_candidates=32, pyramid_capacity=8,
        planner_rounds=1, start_flight_time=0.1)
    n_o = 2 * n_devices
    ostates = sharding.init_orchard_fleet(oparams, mesh, n_o)
    ostep = sharding.make_orchard_fleet_step(oparams, mesh, n_o, n_frames=3)
    ostates, ometrics = ostep(ostates)
    jax.block_until_ready(ometrics)
    assert int(ometrics.num_panicked) == 0, "orchard fleet panicked in dryrun"
    assert ometrics.mean_pos.shape == (3,)


def spawn(n_devices: int, envs_per_device: int = ENVS_PER_DEVICE,
          substeps: int = SUBSTEPS) -> None:
    """Run the dry run in a fresh subprocess with a forced CPU mesh.

    Raises RuntimeError (with the subprocess tail) on any failure, so the
    caller's rc reflects the dryrun result regardless of the ambient backend.
    """
    import subprocess

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", ""))
    env["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    proc = subprocess.run(
        [sys.executable, "-m", "agrifly_tpu.parallel.dryrun",
         str(n_devices), "--envs-per-device", str(envs_per_device),
         "--substeps", str(substeps)],
        env=env, cwd=repo_root, capture_output=True, text=True, timeout=1800,
    )
    if proc.returncode != 0:
        tail = (proc.stdout + "\n" + proc.stderr)[-4000:]
        raise RuntimeError(
            f"dryrun subprocess failed (rc={proc.returncode}):\n{tail}"
        )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--envs-per-device", type=int, default=ENVS_PER_DEVICE)
    ap.add_argument("--substeps", type=int, default=SUBSTEPS)
    args = ap.parse_args(argv)

    _force_cpu_mesh(args.n_devices)
    run_dryrun(args.n_devices, args.envs_per_device, args.substeps)
    print(f"DRYRUN OK: {args.n_devices} devices x {args.envs_per_device} envs "
          f"x {args.substeps} substeps + sharded planner + sharded orchard loop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
