"""Headline benchmark: physics + onboard-logic steps/sec/chip at 4096 envs.

Runs the fused 500 Hz sim step (6-DOF plant, motors, IMU synthesis, onboard
EKF + state machine + controllers + mixer, radio delay line, offboard
cascaded control) vmapped over 4096 envs via the cadence-specialized
production rollout (env.rollout_fast), scanned on-device.

Baseline (BASELINE.md): the reference runs 1 env at 500 steps/s wall-clock
(real-time budget, single CPU thread). Target: >= 1e6 steps/s/chip.
Prints one JSON line naming the device it ran on. Refuses to run when JAX
finds no GPU, unless --cpu is given.

    python bench.py [--cpu]
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from agrifly_tpu import backend
from agrifly_tpu.sim import env as env_mod

N_ENVS = 4096
STEPS_PER_CALL = 250
N_CALLS = 8
TARGET = 1e6


def main(argv=()):
    allow_cpu = "--cpu" in argv
    if allow_cpu:
        jax.config.update("jax_platforms", "cpu")
    backend.require_device(allow_cpu=allow_cpu)
    backend.setup_compile_cache()
    params = env_mod.make_params(noise_scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
    states = jax.vmap(lambda k: env_mod.init_state(params, k))(keys)
    cmd = env_mod.hover_command((0.0, 0.0, 1.5))
    cmds = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N_ENVS,) + x.shape), cmd
    )

    def run_chunk(states):
        # rollout_fast is the production fleet rollout: bit-identical to
        # scanning env.step (equivalence-tested in tests/), but each tick is
        # specialized at trace time to its deterministic periodic
        # mocap/offboard cadence, so non-firing ticks carry no masked
        # offboard work.
        new_states, _ = jax.vmap(
            lambda s, c: env_mod.rollout_fast(params, s, c, STEPS_PER_CALL)
        )(states, cmds)
        return new_states

    # rollout_fast's trace-time cadence prologue assumes zero accumulator
    # phase (state.step == 0), so every timed call runs the same valid
    # zero-start rollout instead of chaining donated carries.
    run_chunk = jax.jit(run_chunk)

    # warmup / compile
    out = run_chunk(states)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        out = run_chunk(states)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0

    total_steps = N_ENVS * STEPS_PER_CALL * N_CALLS
    rate = total_steps / elapsed
    dev = backend.device_info()
    print(
        json.dumps(
            {
                "metric": f"physics+logic steps/sec/chip @ {N_ENVS} envs",
                "value": round(rate, 1),
                "unit": "steps/s",
                "vs_baseline": round(rate / TARGET, 3),
                "platform": dev["platform"],
                "device_kind": dev["kind"],
                "device_count": dev["count"],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
