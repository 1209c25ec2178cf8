"""640x480 depth-render throughput, procedural orchard.

    python -m benchmarks.bench_render [--cpu] [--batch 256]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else 256

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.render import orchard, raycast
    from agrifly_tpu.ops import rotation as rot

    cfg = raycast.make_config(640, 480, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    key = jax.random.PRNGKey(0)
    pos = jax.random.uniform(key, (batch, 3), jnp.float32,
                             jnp.array([0.0, -20.0, 1.0]),
                             jnp.array([100.0, 20.0, 5.0]))
    att = jax.vmap(raycast.camera_attitude)(
        jnp.broadcast_to(rot.identity(), (batch, 4)))

    f = jax.jit(lambda p, a: raycast.render_depth_batch(cfg, scene, p, a))
    t = _util.pipelined_time(f, pos, att)
    _util.report("render_depth_640x480_fps", batch / t, "frames/s", baseline=5000)


if __name__ == "__main__":
    main(sys.argv[1:])
