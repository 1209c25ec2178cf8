"""Single-vehicle 640x480 frame phase breakdown.

Times, per frame, over a scanned 31-frame block with donated carry:
  full     - frame_step (render + plan + 16 ticks + mission logic)
  ticks    - the 16-tick _sim_tick scan alone
  render   - depth render alone
  plan     - rappids.plan alone (fixed image)

    python -m benchmarks.bench_frame [--cpu]
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from agrifly_tpu.sim import orchard_env
from agrifly_tpu.planner import rappids
from agrifly_tpu.render import raycast
from benchmarks import _util
from agrifly_tpu.ops import rotation as rot

N_FRAMES = 31
REPS = 5


def timeit(fn, arg):
    out = jax.block_until_ready(fn(arg))
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(arg))
        best = min(best, time.perf_counter() - t0)
    return best / N_FRAMES, out


def main(argv):
    _util.setup(argv)
    params = orchard_env.make_params()
    state = orchard_env.init_state(params, jax.random.PRNGKey(0))

    # advance to steady flight (past start_flight_step = 2500 ticks = 157 frames)
    warm = jax.jit(lambda s: orchard_env.fly(params, s, 160)[0])
    state = jax.block_until_ready(warm(state))
    print("warm state: step", int(state.base.step), "plans", int(state.plan_count))

    # full frame
    @jax.jit
    def full(s):
        return orchard_env.fly(params, s, N_FRAMES)[0]

    t_full, _ = timeit(full, state)
    print(f"full frame:  {t_full*1e3:8.3f} ms")

    # ticks only
    @jax.jit
    def ticks(s):
        def body(c, _):
            return orchard_env._sim_tick(params, c), None
        return jax.lax.scan(body, s, None, length=16 * N_FRAMES)[0]

    t_ticks, _ = timeit(ticks, state)  # per frame = 16 ticks
    print(f"16 ticks:    {t_ticks*1e3:8.3f} ms")

    # render only
    @jax.jit
    def render(s):
        def body(c, _):
            base = c.base
            cam_att = raycast.camera_attitude(base.plant.att)
            depth = orchard_env.render_frame(params, base.plant.pos, cam_att)
            # fold depth back into carry so scan iterations aren't DCE'd
            c = c._replace(base=base._replace(
                key=base.key + depth[0, :2].astype(jnp.uint32)))
            return c, None
        return jax.lax.scan(body, s, None, length=N_FRAMES)[0]

    t_render, _ = timeit(render, state)
    print(f"render:      {t_render*1e3:8.3f} ms")

    # plan only (fresh depth each iteration comes from carry-dependent noise
    # so XLA can't hoist the plan out of the scan)
    base = state.base
    cam_att = raycast.camera_attitude(base.plant.att)
    depth0 = orchard_env.render_frame(params, base.plant.pos, cam_att)
    depth0 = jax.block_until_ready(depth0)

    @jax.jit
    def plan(s):
        def body(carry, _):
            key, acc = carry
            key, sub = jax.random.split(key)
            img = jnp.clip(depth0 + (acc % 2), 0, 255)
            res = rappids.plan(
                params.planner, img, sub,
                jnp.array([0., 0., 1.5]), jnp.zeros(3),
                jnp.array([0., 9.81, 0.]), jnp.array([0., 0., 20.]),
                n_candidates=params.n_candidates,
                pyramid_capacity=params.pyramid_capacity,
                rounds=params.planner_rounds,
                inflation_downsample=params.inflation_downsample,
            )
            return (key, acc + res.num_collision_free), None
        return jax.lax.scan(body, (s.base.key, jnp.int32(0)), None, length=N_FRAMES)[0]

    t_plan, _ = timeit(plan, state)
    print(f"plan:        {t_plan*1e3:8.3f} ms")

    resid = t_full - t_ticks - t_render - t_plan
    print(f"residual (frame glue): {resid*1e3:8.3f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
