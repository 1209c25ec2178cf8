"""Estimator-in-the-loop fleet throughput (BENCH_DETAILS estimator row).

rollout_fast at 4096 envs, 250 steps/call, donated carry — mocap and
gps-imu modes plus the perfect-state headline configuration.

    python -m benchmarks.bench_estimators [--cpu] [--envs 4096]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    n_envs = int(argv[argv.index("--envs") + 1]) if "--envs" in argv else 4096

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import env

    params = env.make_params(noise_scale=1.0)
    cmd = env.hover_command((0.0, 0.0, 1.2))
    keys = jax.random.split(jax.random.PRNGKey(0), n_envs)
    states0 = jax.vmap(lambda k: env.init_state(params, k))(keys)
    n_steps = 250

    for name, mode in [("physics_logic_steps_per_s", False),
                       ("mocap_estimator_steps_per_s", True),
                       ("gpsimu_estimator_steps_per_s", "gpsimu")]:
        @jax.jit
        def roll(s, mode=mode):
            out, _ = jax.vmap(
                lambda st: env.rollout_fast(params, st, cmd, n_steps, mode)
            )(s)
            return out

        states = jax.tree_util.tree_map(jnp.copy, states0)
        t = _util.pipelined_time(roll, states)
        _util.report(name, n_envs * n_steps / t, "steps/s",
                     baseline=1e6 if mode is False else None)


if __name__ == "__main__":
    main(sys.argv[1:])
