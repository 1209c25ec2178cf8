"""Explicit imported-scene render throughput (BENCH_DETAILS meshscene row).

Baked procedural orchard (675 primitives) through meshscene.render_depth
with the backend's strip-culling default.

    python -m benchmarks.bench_meshscene [--cpu] [--batch 64]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else 64

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.render import meshscene, orchard, raycast
    from agrifly_tpu.ops import rotation as rot

    cfg = raycast.make_config(640, 480, far=10.0, dda_steps=8)
    scene = meshscene.from_orchard(orchard.make_params(seed=0),
                                   x_range=(0.0, 60.0), y_range=(-15.0, 15.0))
    key = jax.random.PRNGKey(0)
    pos = jax.random.uniform(key, (batch, 3), jnp.float32,
                             jnp.array([0.0, -10.0, 1.0]),
                             jnp.array([50.0, 10.0, 4.0]))
    att = jax.vmap(raycast.camera_attitude)(
        jnp.broadcast_to(rot.identity(), (batch, 4)))

    f = jax.jit(jax.vmap(lambda p, a: meshscene.render_depth(
        cfg, scene, p, a)))
    t = _util.pipelined_time(f, pos, att)
    _util.report("meshscene_depth_640x480_fps", batch / t, "frames/s")


if __name__ == "__main__":
    main(sys.argv[1:])
