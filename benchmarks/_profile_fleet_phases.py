"""Phase breakdown of the vmapped fleet frame (16 veh, 640x480).

Per-frame times over a pipelined dispatch of whole-frame jits:
  full    - vmapped frame_step (render + plan + 16 ticks + mission)
  ticks   - the vmapped 16-tick _sim_tick scan alone
  render  - batched depth render alone
  plan    - vmapped rappids.plan alone (fixed images)
"""
import sys
import time

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    fleet = int(argv[argv.index("--fleet") + 1]) if "--fleet" in argv else 16

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params()

    keys = jax.random.split(jax.random.PRNGKey(0), fleet)
    lanes = (jnp.arange(fleet, dtype=jnp.float32) - (fleet - 1) / 2.0) * 3.0
    spawns = jnp.stack([jnp.zeros(fleet), lanes, jnp.zeros(fleet)], axis=1)
    state = jax.vmap(lambda k, p: orchard_env.init_state(params, k, pos=p))(
        keys, spawns)

    # warm into steady flight
    warm = jax.jit(lambda s: jax.vmap(
        lambda st: orchard_env.fly(params, st, 160)[0])(s))
    state = jax.block_until_ready(warm(state))

    @jax.jit
    def full(s):
        return jax.vmap(lambda st: orchard_env.frame_step(params, st)[0])(s)

    t = _util.pipelined_time(full, state)
    print(f"full frame ({fleet} veh): {t*1e3:8.3f} ms")

    @jax.jit
    def ticks(s):
        def one(st):
            def body(c, _):
                return orchard_env._sim_tick(params, c), None
            return jax.lax.scan(body, st, None, length=16)[0]
        return jax.vmap(one)(s)

    t = _util.pipelined_time(ticks, state)
    print(f"ticks (16): {t*1e3:8.3f} ms")

    from agrifly_tpu.render import raycast

    cam_att = jax.vmap(
        lambda st: raycast.camera_attitude(st.base.plant.att))(state)
    pos = state.base.plant.pos

    @jax.jit
    def render(args):
        p, a = args
        return raycast.render_depth_batch(params.render_cfg, params.scene, p, a)

    t = _util.pipelined_time(render, (pos, cam_att))
    print(f"render:     {t*1e3:8.3f} ms")

    depth = jax.block_until_ready(render((pos, cam_att)))
    from agrifly_tpu.planner import rappids

    vel = jnp.tile(jnp.array([0.0, 0.0, 1.5], jnp.float32), (fleet, 1))
    acc = jnp.zeros((fleet, 3), jnp.float32)
    grav = jnp.tile(jnp.array([0.0, 0.0, -9.81], jnp.float32), (fleet, 1))
    goal = jnp.tile(jnp.array([0.0, 0.0, 8.0], jnp.float32), (fleet, 1))
    pkeys = jax.random.split(jax.random.PRNGKey(1), fleet)

    @jax.jit
    def plan(d):
        return jax.vmap(lambda dd, k, v, a, g, gl: rappids.plan(
            params.planner, dd, k, v, a, g, gl,
            n_candidates=params.n_candidates,
            pyramid_capacity=params.pyramid_capacity,
            rounds=params.planner_rounds,
            inflation_downsample=params.inflation_downsample).found)(
                d, pkeys, vel, acc, grav, goal)

    t = _util.pipelined_time(plan, depth)
    print(f"plan:       {t*1e3:8.3f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
