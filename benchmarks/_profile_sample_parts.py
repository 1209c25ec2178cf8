"""Micro-split of sample_candidates + exploration_cost (scan-chunked).

    python -m benchmarks._profile_sample_parts [--cpu] [--candidates 512]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    n = int(argv[argv.index("--candidates") + 1]) if "--candidates" in argv else 512

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids, traj as traj_mod

    cam = rappids.make_camera(640, 480, focal=320.0, depth_scale=10.0 / 256.0)
    params = rappids.make_params(cam, true_radius=0.116, plan_radius=0.174,
                                 min_check_dist=0.5)
    vel = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    acc = jnp.zeros(3, jnp.float32)
    goal = jnp.array([0.0, 0.0, 50.0], jnp.float32)

    def one(sub, stop):
        k1, k2, k3, k4 = jax.random.split(sub, 4)
        px = jax.random.uniform(k1, (n,), jnp.float32, 0.1 * cam.width, 0.9 * cam.width)
        py = jax.random.uniform(k2, (n,), jnp.float32, 0.1 * cam.height, 0.9 * cam.height)
        depth = jax.random.uniform(k3, (n,), jnp.float32, 1.5, 3.0)
        tf = jax.random.uniform(k4, (n,), jnp.float32, 2.0, 3.0)
        if stop == "rng":
            return px.sum() + py.sum() + depth.sum() + tf.sum()
        goal_px = rappids.deproject(cam, px, py, depth)
        p0 = jnp.zeros((n, 3), jnp.float32)
        v0 = jnp.broadcast_to(vel, (n, 3))
        a0 = jnp.broadcast_to(acc, (n, 3))
        zero = jnp.zeros((n, 3), jnp.float32)
        tr = traj_mod.generate(p0, v0, a0, tf, goal_pos=goal_px, goal_vel=zero,
                               goal_acc=zero)
        if stop == "generate":
            return tr.alpha.sum() + tr.cost.sum()
        cost = rappids.exploration_cost(tr, goal)
        return cost.sum()

    CHUNK = 25
    prev = 0.0
    for stop in ["rng", "generate", "cost"]:
        @jax.jit
        def f(key, stop=stop):
            def body(k, _):
                k, sub = jax.random.split(k)
                return k, one(sub, stop)
            _, outs = jax.lax.scan(body, key, None, length=CHUNK)
            return outs
        t = _util.pipelined_time(f, jax.random.PRNGKey(1)) / CHUNK * 1e3
        print(f"{stop:10s} cum {t:7.3f} ms   delta {t - prev:7.3f} ms")
        prev = t


if __name__ == "__main__":
    main(sys.argv[1:])
