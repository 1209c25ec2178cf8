"""Multi-vehicle full perception-plan-act frames.

Batched orchard frame_step_fleet (render + 256-candidate RAPPIDS + 16
ticks) for 16 and 64 vehicles; reports aggregate realtime multiple.

    python -m benchmarks.bench_fleet_frames [--cpu] [--image 640x480] [--sizes 16,64]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    img = argv[argv.index("--image") + 1] if "--image" in argv else "640x480"
    w, h = (int(x) for x in img.split("x"))
    sizes = ([int(x) for x in argv[argv.index("--sizes") + 1].split(",")]
             if "--sizes" in argv else [16, 64])

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params(width=w, height=h)
    frame_time = params.steps_per_frame * float(params.base.dt_us) * 1e-6

    for fleet in sizes:
        keys = jax.random.split(jax.random.PRNGKey(0), fleet)
        lanes = (jnp.arange(fleet, dtype=jnp.float32) - (fleet - 1) / 2.0) * 3.0
        spawns = jnp.stack([jnp.zeros(fleet), lanes, jnp.zeros(fleet)], axis=1)
        state = jax.vmap(lambda k, p: orchard_env.init_state(params, k, pos=p))(
            keys, spawns)

        @jax.jit
        def step(s):
            return orchard_env.frame_step_fleet(params, s)[0]

        t = _util.pipelined_time(step, state)
        _util.report(f"fleet{fleet}_frame_ms", t * 1e3, "ms")
        _util.report(f"fleet{fleet}_aggregate_realtime",
                     fleet * frame_time / t, "x")


if __name__ == "__main__":
    main(sys.argv[1:])
