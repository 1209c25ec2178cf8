"""Steady-state headline: physics+logic throughput from a WARM flight state.

bench.py times restarted t=0 rollouts (rollout_fast requires zero
accumulator phase); this variant warms every env 500 ticks of real flight
(EKF past phase A, occupied delay lines and prediction pipes, panic checks
active), reads the now-concrete cadence phase, and times the
phase-specialized rollout from there — the representative load.

    python -m benchmarks.bench_steady [--cpu] [--envs 4096]
"""

import sys

import numpy as np

from benchmarks import _util

WARM_STEPS = 500


def main(argv):
    argv = _util.setup(argv)
    n_envs = int(argv[argv.index("--envs") + 1]) if "--envs" in argv else 4096

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import env

    params = env.make_params(noise_scale=1.0)
    cmd = env.hover_command((0.0, 0.0, 1.2))
    keys = jax.random.split(jax.random.PRNGKey(0), n_envs)
    states = jax.vmap(lambda k: env.init_state(params, k))(keys)

    warm = jax.jit(lambda s: jax.vmap(
        lambda st: env.rollout_fast(params, st, cmd, WARM_STEPS, True))(s)[0])
    states = jax.block_until_ready(warm(states))

    macc = np.unique(np.asarray(states.mocap_acc_us))
    oacc = np.unique(np.asarray(states.offboard_acc_us))
    assert macc.size == 1 and oacc.size == 1, (macc, oacc)
    phase = (int(macc[0]), int(oacc[0]))

    n_steps = 250

    @jax.jit
    def roll(s):
        out, _ = jax.vmap(lambda st: env.rollout_fast(
            params, st, cmd, n_steps, True, entry_phase=phase))(s)
        return out

    t = _util.pipelined_time(roll, states)
    _util.report("steady_state_mocap_steps_per_s", n_envs * n_steps / t,
                 "steps/s", baseline=1e6)

    @jax.jit
    def roll_plain(s):
        out, _ = jax.vmap(lambda st: env.rollout_fast(
            params, st, cmd, n_steps, False, entry_phase=phase))(s)
        return out

    t = _util.pipelined_time(roll_plain, states)
    _util.report("steady_state_physics_steps_per_s", n_envs * n_steps / t,
                 "steps/s", baseline=1e6)


if __name__ == "__main__":
    main(sys.argv[1:])
