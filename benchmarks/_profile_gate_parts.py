"""Sub-split of the plan() sample+gate phase (scan-chunked).

    python -m benchmarks._profile_gate_parts [--cpu] [--candidates 512]
"""

import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    n_cand = int(argv[argv.index("--candidates") + 1]) if "--candidates" in argv else 512

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids, traj as traj_mod

    cam = rappids.make_camera(640, 480, focal=320.0, depth_scale=10.0 / 256.0)
    params = rappids.make_params(cam, true_radius=0.116, plan_radius=0.174,
                                 min_check_dist=0.5)
    vel = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    acc = jnp.zeros(3, jnp.float32)
    grav = jnp.array([0.0, 9.81, 0.0], jnp.float32)
    goal = jnp.array([0.0, 0.0, 50.0], jnp.float32)

    def one(sub, stop):
        tr = rappids.sample_candidates(params, sub, n_cand, vel, acc, grav)
        cost = rappids.exploration_cost(tr, goal)
        if stop == "sample_cost":
            return cost.sum() + tr.alpha.sum()
        feas = traj_mod.check_input_feasibility(
            tr, grav, params.fmin, params.fmax, params.wmax,
            float(params.min_section_time), static_max_tf=3.0)
        if stop == "input_feas":
            return cost.sum() + feas.sum().astype(jnp.float32)
        vel_ok = traj_mod.check_velocity_feasibility(tr, params.vmax)
        return cost.sum() + (feas & vel_ok).sum().astype(jnp.float32)

    CHUNK = 25
    prev = 0.0
    for stop in ["sample_cost", "input_feas", "vel_feas"]:
        @jax.jit
        def f(key, stop=stop):
            def body(k, _):
                k, sub = jax.random.split(k)
                return k, one(sub, stop)
            _, outs = jax.lax.scan(body, key, None, length=CHUNK)
            return outs
        t = _util.pipelined_time(f, jax.random.PRNGKey(1)) / CHUNK * 1e3
        print(f"{stop:12s} cum {t:7.3f} ms   delta {t - prev:7.3f} ms")
        prev = t


if __name__ == "__main__":
    main(sys.argv[1:])
