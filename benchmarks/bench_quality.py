"""Plan quality vs candidate count at reference-budget scale.

The reference planner is an ANYTIME loop: it samples/checks candidates
one at a time until a CPU budget expires (15 ms in the ROS node,
50 ms in the single-thread demo — DepthImagePlanner.cpp:91-212,
ExampleVehicleStateMachine.cpp:183). Plan quality is therefore bounded
by how many candidates fit the budget. The batch redesign evaluates a
FIXED candidate set in one fused program, so the relevant questions are

  1. how many candidates per millisecond the batch pipeline sustains
     (including pyramid building), and
  2. how the chosen-trajectory cost improves with candidate count —
     i.e. what the reference's budget buys here.

For each N this prints pipelined plan() latency, found-rate and mean
best-cost over the 4 standard cluttered scenes, plus candidates/ms.

    python -m benchmarks.bench_quality [--cpu] [--image 640x480]
        [--pyramids 32] [--sizes 256,512,1024,2048]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    img = argv[argv.index("--image") + 1] if "--image" in argv else "640x480"
    w, h = (int(x) for x in img.split("x"))
    n_pyr = int(argv[argv.index("--pyramids") + 1]) if "--pyramids" in argv else 32
    sizes = ([int(x) for x in argv[argv.index("--sizes") + 1].split(",")]
             if "--sizes" in argv else [256, 512, 1024, 2048])

    import json

    import jax
    import jax.numpy as jnp
    import numpy as np

    from agrifly_tpu.ops import rotation as rot
    from agrifly_tpu.planner import rappids
    from agrifly_tpu.render import orchard, raycast

    cfg = raycast.make_config(w, h, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    cam = rappids.make_camera(w, h, focal=w / 2.0, depth_scale=10.0 / 256.0)
    params = rappids.make_params(cam, true_radius=0.116, plan_radius=0.174,
                                 min_check_dist=0.5)
    att = raycast.camera_attitude(rot.identity())
    poses = [(5.0, 0.0, 2.5), (12.0, 1.5, 2.0), (20.0, -1.0, 3.0),
             (30.0, 0.5, 1.5)]
    depths = [jax.block_until_ready(
        raycast.render_depth(cfg, scene, jnp.asarray(p, jnp.float32), att))
        for p in poses]
    vel0 = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    acc0 = jnp.zeros(3, jnp.float32)
    grav = jnp.array([0.0, 9.81, 0.0], jnp.float32)
    goal = jnp.array([0.0, 0.0, 50.0], jnp.float32)

    CHUNK = 8
    for n_cand in sizes:
        founds, costs = [], []
        t_ms = None
        for k, depth in enumerate(depths):
            key = jax.random.PRNGKey(100 + k)
            fn = jax.jit(lambda d, ky: rappids.plan(
                params, d, ky, vel0, acc0, grav, goal,
                n_candidates=n_cand, pyramid_capacity=n_pyr,
                rounds=2, lazy_rounds=1))
            res = jax.block_until_ready(fn(depth, key))
            founds.append(bool(res.found))
            costs.append(float(res.best_cost))
            if k == 0:
                # scan CHUNK plans per call + pipeline the calls
                # (bench_plan methodology: per-plan cost, dispatch-free)
                def f(ky, d=depth):
                    def body(kc, _):
                        kc, sub = jax.random.split(kc)
                        r = rappids.plan(
                            params, d, sub, vel0, acc0, grav, goal,
                            n_candidates=n_cand, pyramid_capacity=n_pyr,
                            rounds=2, lazy_rounds=1)
                        return kc, r.best_cost
                    kc, cs = jax.lax.scan(body, ky, None, length=CHUNK)
                    return cs.sum()
                t = _util.pipelined_time(
                    jax.jit(f), jax.random.PRNGKey(1)) / CHUNK
                t_ms = t * 1e3
        print(json.dumps({
            "metric": f"plan_quality_N{n_cand}",
            "plan_ms": round(t_ms, 3),
            "candidates_per_ms": round(n_cand / t_ms, 1),
            "found_rate": sum(founds) / len(founds),
            "mean_best_cost": round(float(np.mean(costs)), 4),
            # the reference ROS node's whole budget per image
            "budget_margin_vs_15ms": round(15.0 / t_ms, 1),
        }))


if __name__ == "__main__":
    main(sys.argv[1:])
