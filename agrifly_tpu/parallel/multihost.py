"""Multi-process scale-out: process-spanning env-axis sharding.

`jax.distributed.initialize` forms one JAX runtime across processes or
hosts, after which `jax.devices()` is the *global* device list and the
existing env-axis machinery (parallel/sharding.py) runs unchanged over a
process-spanning mesh — jit computations become SPMD across processes, env
shards live on each process's local devices, and the only cross-process
traffic is the fleet-metric psums (envs never communicate, SURVEY §2).

Launch, one command per process:

    AGRIFLY_COORD=host0:5731 AGRIFLY_NPROC=4 AGRIFLY_PROC_ID=<i> \
        python your_driver.py

On one host with several GPUs, either drive all cards from ONE process
(no initialization needed: `jax.devices()` lists them all; this is what
chip_smoke.py --four does), or run one process per card, each seeing its
own card through `CUDA_VISIBLE_DEVICES=<i>`, with AGRIFLY_COORD set to a
free `localhost:<port>`. A JAX process reserves most of a card's memory
when it first uses it, so two processes must not share one card.

`initialize_from_env()` is a no-op without these variables (single-process
runs keep working). AGRIFLY_AUTO_INIT=1 calls `jax.distributed.initialize()`
with no arguments, for cluster managers JAX detects itself (e.g. SLURM);
nothing on a plain GPU host is detected, so give AGRIFLY_COORD there.

CPU-testable: tests/test_multihost.py launches two subprocesses that each
expose 4 virtual CPU devices, form the 2-process x 4-device global mesh,
and run the sharded fleet step.
"""

from __future__ import annotations

import os

ENV_COORD = "AGRIFLY_COORD"
ENV_NPROC = "AGRIFLY_NPROC"
ENV_PROC_ID = "AGRIFLY_PROC_ID"
ENV_AUTO = "AGRIFLY_AUTO_INIT"


def initialize_from_env() -> bool:
    """Join the multi-process runtime if the launch env asks for one.

    Returns True when distributed mode was initialized. Must run before
    any JAX device query in the process (jax backends are lazily
    initialized on first use).
    """
    coord = os.environ.get(ENV_COORD)
    if coord is None:
        if os.environ.get(ENV_AUTO) == "1":
            import jax

            jax.distributed.initialize()  # cluster auto-detection
            return True
        return False
    import jax

    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ[ENV_NPROC]),
        process_id=int(os.environ[ENV_PROC_ID]),
    )
    return True


def process_info():
    """(process_index, process_count) of the current runtime."""
    import jax

    return jax.process_index(), jax.process_count()


def global_env_mesh():
    """1-D env-axis mesh over ALL devices of ALL processes.

    jax.devices() is already the global list after initialize; the mesh
    layout keeps each host's devices contiguous so the env axis splits
    into per-host blocks and cross-host traffic is metrics-only."""
    from agrifly_tpu.parallel import sharding

    return sharding.make_mesh()


def init_global_fleet(params, mesh, n_envs: int, base_seed: int = 0):
    """Globally-sharded batched env state, computed SPMD (no host gather).

    Runs init under jit with an env-axis out_sharding: each process
    materializes only its local shard of the (n_envs, ...) state pytree.
    """
    import jax

    from agrifly_tpu.parallel import sharding
    from agrifly_tpu.sim import env as env_mod

    shard = sharding.env_sharding(mesh)

    def init(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_envs)
        return jax.vmap(lambda k: env_mod.init_state(params, k))(keys)

    shardings = jax.tree_util.tree_map(
        lambda _: shard, jax.eval_shape(init, base_seed))
    return jax.jit(init, out_shardings=shardings)(base_seed)


def make_global_fleet_step(params, mesh, n_envs: int, n_substeps: int = 1,
                           use_estimator=False):
    """The sharded fleet step over a (possibly multi-host) mesh.

    Identical to parallel/sharding.make_fleet_step — shard_map + psum work
    transparently across processes once the runtime is distributed."""
    from agrifly_tpu.parallel import sharding

    return sharding.make_fleet_step(
        params, mesh, n_envs, n_substeps=n_substeps,
        use_estimator=use_estimator)


def init_global_orchard_fleet(params, mesh, n_envs: int, base_seed: int = 0,
                              lane_spacing: float = 3.0):
    """Globally-sharded orchard fleet state (vehicles abreast in y), SPMD.

    The single-host sharding.init_orchard_fleet materializes the full
    batch on the host then device_puts; across processes each host must
    only materialize its own shard, so init runs under jit with an
    env-axis out_sharding (same trick as init_global_fleet)."""
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.parallel import sharding
    from agrifly_tpu.sim import orchard_env

    shard = sharding.env_sharding(mesh)

    def init(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_envs)
        lanes = (jnp.arange(n_envs, dtype=jnp.float32)
                 - (n_envs - 1) / 2.0) * lane_spacing
        spawns = jnp.stack(
            [jnp.zeros(n_envs), lanes, jnp.zeros(n_envs)], axis=1)
        return jax.vmap(
            lambda k, p: orchard_env.init_state(params, k, pos=p))(
                keys, spawns)

    shardings = jax.tree_util.tree_map(
        lambda _: shard, jax.eval_shape(init, base_seed))
    return jax.jit(init, out_shardings=shardings)(base_seed)


def make_global_orchard_step(params, mesh, n_envs: int, n_frames: int = 1):
    """The FULL perception-plan-act orchard frame (render -> RAPPIDS ->
    16 tracked ticks) sharded over a process-spanning mesh — the
    flagship config-#4 workload, not just the physics fleet.

    Delegates to sharding.make_orchard_fleet_step: after
    jax.distributed.initialize the same shard_map program runs SPMD
    across hosts; each process renders/plans/tracks its local vehicle
    block and only the psum'd OrchardFleetMetrics cross processes.
    Exercised by tests/test_multihost.py (2 procs x 4 CPU devices)."""
    from agrifly_tpu.parallel import sharding

    return sharding.make_orchard_fleet_step(
        params, mesh, n_envs, n_frames=n_frames)
