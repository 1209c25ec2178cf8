"""Scan-chunked per-phase split of rappids.plan() at 640x480.

Times each cumulative prefix of the pipeline as a CHUNK-long lax.scan
inside one jit, exactly like bench_plan.py, so per-phase deltas are
dispatch-free.

Cumulative prefixes:
  sample_gate      sample + cost + input/velocity feasibility
  pyramids         + R pyramid rounds (incl. covered-seed prefilter)
  collision        + vmapped collision check of all N candidates
  lazy1            + 1 lazy round (seed from failures, build, re-check)

    python -m benchmarks._profile_plan_phases [--cpu] [--candidates 512]
        [--pyramids 32] [--rounds 2]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    n_cand = int(argv[argv.index("--candidates") + 1]) if "--candidates" in argv else 512
    n_pyr = int(argv[argv.index("--pyramids") + 1]) if "--pyramids" in argv else 32
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 2

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids, traj as traj_mod
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

    def phase_fn(stop):
        """Pipeline prefix ending at `stop`; returns a small reduction so
        nothing is dead-code-eliminated."""

        def one(sub):
            tr = rappids.sample_candidates(params, sub, n_cand, vel, acc, grav)
            cost = rappids.exploration_cost(tr, goal)
            feas = traj_mod.check_input_feasibility(
                tr, grav, params.fmin, params.fmax, params.wmax,
                float(params.min_section_time), static_max_tf=3.0)
            vel_ok = traj_mod.check_velocity_feasibility(tr, params.vmax)
            gate = feas & vel_ok
            if stop == "sample_gate":
                return gate.sum().astype(jnp.float32) + cost.sum()

            end = traj_mod.position(tr, tr.tf)
            epx, epy = rappids.project(params.cam, end)
            order = jnp.argsort(jnp.where(gate, cost, jnp.inf))
            pyrs = rappids.empty_pyramid_set(n_pyr)
            per_round = n_pyr // (rounds + 1)
            for rnd in range(rounds):
                take = order[rnd * per_round:(rnd + 1) * per_round]
                seed_valid = gate[take]
                if rnd > 0:
                    f, _ = jax.vmap(
                        lambda x, y, d: rappids.find_containing_pyramid(pyrs, x, y, d)
                    )(epx[take], epy[take], end[take][:, 2])
                    seed_valid = seed_valid & ~f
                new_pyrs = rappids.build_pyramid_set(
                    params, depth, epx[take], epy[take], end[take][:, 2],
                    seed_valid, per_round)
                pyrs = rappids.merge_pyramid_sets(pyrs, new_pyrs) if rnd > 0 \
                    else rappids.merge_pyramid_sets(
                        rappids.empty_pyramid_set(n_pyr - per_round), new_pyrs)
            if stop == "pyramids":
                return pyrs.depth.sum() + pyrs.valid.sum().astype(jnp.float32)

            collision_free, fail_px, fail_py, fail_z = jax.vmap(
                lambda i: rappids.collision_check(
                    params, pyrs, jax.tree_util.tree_map(lambda x: x[i], tr))
            )(jnp.arange(n_cand))
            if stop == "collision":
                return collision_free.sum().astype(jnp.float32) + fail_z.sum()

            img_i = depth.astype(jnp.int32)
            ignore_i = (params.true_radius / params.cam.depth_scale).astype(jnp.int32)
            failed = gate & ~collision_free & (fail_z > 0)
            pxi = jnp.clip(fail_px.astype(jnp.int32), 0, params.cam.width - 1)
            pyi = jnp.clip(fail_py.astype(jnp.int32), 0, params.cam.height - 1)
            seed_code = img_i[pyi, pxi]
            minpyr_i = ((fail_z + params.cam.depth_scale + params.plan_radius)
                        / params.cam.depth_scale).astype(jnp.int32)
            seedable = failed & ((seed_code <= ignore_i) | (seed_code >= minpyr_i))
            order2 = jnp.argsort(jnp.where(seedable, cost, jnp.inf))
            take = order2[: 4 * per_round]
            seed_valid = seedable[take]
            covered, _ = jax.vmap(
                lambda x, y, d: rappids.find_containing_pyramid(pyrs, x, y, d)
            )(fail_px[take], fail_py[take], fail_z[take])
            seed_valid = seed_valid & ~covered
            if stop == "lazy_seed":
                return seed_valid.sum().astype(jnp.float32)
            new_pyrs = rappids.build_pyramid_set(
                params, depth, fail_px[take], fail_py[take],
                fail_z[take] + params.cam.depth_scale, seed_valid, per_round)
            pyrs = rappids.merge_pyramid_sets(pyrs, new_pyrs)
            if stop == "lazy_build":
                return pyrs.depth.sum()
            refree, *_ = jax.vmap(
                lambda i: rappids.collision_check(
                    params, pyrs, jax.tree_util.tree_map(lambda x: x[i], tr),
                    enabled=failed[i])
            )(jnp.arange(n_cand))
            collision_free = jnp.where(failed, refree, collision_free)
            return collision_free.sum().astype(jnp.float32)

        CHUNK = 25

        @jax.jit
        def f(key):
            def body(k, _):
                k, sub = jax.random.split(k)
                return k, one(sub)
            _, outs = jax.lax.scan(body, key, None, length=CHUNK)
            return outs

        return f, CHUNK

    stops = ["sample_gate", "pyramids", "collision", "lazy_seed",
             "lazy_build", "lazy1"]
    prev = 0.0
    key = jax.random.PRNGKey(1)
    for stop in stops:
        f, chunk = phase_fn(stop)
        t = _util.pipelined_time(f, key) / chunk * 1e3
        print(f"{stop:12s} cum {t:7.3f} ms   delta {t - prev:7.3f} ms")
        prev = t


if __name__ == "__main__":
    main(sys.argv[1:])
