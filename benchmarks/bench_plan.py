"""RAPPIDS plan() latency at 640x480 (BENCH_DETAILS planner row).

Reports full-res, pooled (k=2), and the reference-parity lazy-inflation
mode, at 512 candidates / 32 pyramids.

    python -m benchmarks.bench_plan [--cpu] [--candidates 512] [--pyramids 32]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    n_cand = int(argv[argv.index("--candidates") + 1]) if "--candidates" in argv else 512
    n_pyr = int(argv[argv.index("--pyramids") + 1]) if "--pyramids" in argv else 32

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids
    from agrifly_tpu.render import orchard, raycast
    from agrifly_tpu.ops import rotation as rot

    cfg = raycast.make_config(640, 480, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    cam = rappids.make_camera(640, 480, focal=320.0, depth_scale=10.0 / 256.0)
    params = rappids.make_params(cam, true_radius=0.116, plan_radius=0.174,
                                 min_check_dist=0.5)
    cam_att = raycast.camera_attitude(rot.identity())
    pos = jnp.array([5.0, 0.0, 2.5], jnp.float32)
    depth = raycast.render_depth_batch(cfg, scene, pos[None], cam_att[None])[0]
    depth = jax.block_until_ready(depth)

    vel = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    acc = jnp.zeros(3, jnp.float32)
    grav = jnp.array([0.0, 9.81, 0.0], jnp.float32)
    goal = jnp.array([0.0, 0.0, 50.0], jnp.float32)

    cases = [
        ("plan_ms_fullres", dict(inflation_downsample=1, rounds=2,
                                 lazy_rounds=0)),
        ("plan_ms_pooled_k2", dict(inflation_downsample=2, rounds=2,
                                   lazy_rounds=0)),
        ("plan_ms_lazy_fullres", dict(inflation_downsample=1, rounds=2,
                                      lazy_rounds=1)),
        ("plan_ms_lazy_pooled_k2", dict(inflation_downsample=2, rounds=2,
                                        lazy_rounds=1)),
    ]
    # scan CHUNK plans per call (fresh key each) AND pipeline the calls,
    # so the per-call dispatch amortizes over CHUNK plans — matching how
    # plan() is consumed inside fly().
    CHUNK = 25
    for name, kw in cases:
        @jax.jit
        def f(key, kw=kw):
            def body(k, _):
                k, sub = jax.random.split(k)
                res = rappids.plan(
                    params, depth, sub, vel, acc, grav, goal,
                    n_candidates=n_cand, pyramid_capacity=n_pyr, **kw)
                return k, res.num_collision_free
            k, ns = jax.lax.scan(body, key, None, length=CHUNK)
            return ns
        t = _util.pipelined_time(f, jax.random.PRNGKey(1)) / CHUNK
        _util.report(name, t * 1e3, "ms", baseline=None)
        print(f"  # {name}: collision_free="
              f"{int(f(jax.random.PRNGKey(1))[0])}")


if __name__ == "__main__":
    main(sys.argv[1:])
