"""Packed vs unpacked host-boundary dispatch for the scanned fly block.

The operator surfaces (teleop, --record, realtime) carry the 126-leaf
orchard state across the host boundary every jit call, which costs host
dispatch per buffer. io/packbuf.Packer ships the whole state as ONE
uint32 buffer instead. This bench A/Bs the two program shapes at the
operator block sizes (teleop BLK=10, demo/record BLK=31) in both
dispatch disciplines:

  synced    — block_until_ready every call (the teleop/record loop when
              an operator event or a topic publish must read back)
  pipelined — back-to-back dispatch, one final sync (the demo main loop)

Usage: python benchmarks/bench_packbuf.py [--cpu] [--image WxH]
       [--candidates N] [--blocks 10,31] [--calls K]
"""

from __future__ import annotations

import sys
import time


def main(argv):
    from benchmarks._util import report, setup

    argv = setup(argv)
    image = "640x480"
    candidates = 256
    blocks = (10, 31)
    calls = 8
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--image":
            image = argv[i + 1]; i += 2
        elif a == "--candidates":
            candidates = int(argv[i + 1]); i += 2
        elif a == "--blocks":
            blocks = tuple(int(x) for x in argv[i + 1].split(",")); i += 2
        elif a == "--calls":
            calls = int(argv[i + 1]); i += 2
        else:
            raise SystemExit(f"unknown arg {a}")

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.io import packbuf
    from agrifly_tpu.sim import orchard_env

    w, h = (int(x) for x in image.split("x"))
    params = orchard_env.make_params(
        width=w, height=h, n_candidates=candidates)
    state0 = orchard_env.init_state(params, jax.random.PRNGKey(0))
    packer = packbuf.Packer(state0)
    dt_frame = int(params.steps_per_frame) * float(params.base.dt_us) * 1e-6

    def timed_carry(fn, make_x0, synced):
        """ms/call carrying fn's output into the next call. make_x0 builds
        a fresh input per run (the packed fn donates its argument, so a
        buffer from a previous run would already be consumed)."""
        x = fn(make_x0())               # compile + warm
        x = jax.block_until_ready(x)
        t0 = time.perf_counter()
        for _ in range(calls):
            x = fn(x)
            if synced:
                x = jax.block_until_ready(x)
        jax.block_until_ready(x)
        return (time.perf_counter() - t0) / calls * 1e3

    for blk in blocks:
        fly = jax.jit(lambda s, _n=blk: orchard_env.fly(params, s, _n)[0])
        _step = packer.wrap_step(
            lambda s, _n=blk: orchard_env.fly(params, s, _n)[0])
        packed_fly = jax.jit(lambda b: _step(b)[0], donate_argnums=0)
        sim_ms = blk * dt_frame * 1e3
        for name, fn, make_x0 in (
                ("unpacked", fly, lambda: state0),
                ("packed", packed_fly, lambda: packer.pack(state0)[0])):
            for disc in ("synced", "pipelined"):
                ms = timed_carry(fn, make_x0, disc == "synced")
                report(f"fly_blk{blk}_{name}_{disc}", round(ms, 2),
                       "ms/call", None)
                report(f"fly_blk{blk}_{name}_{disc}_realtime",
                       round(sim_ms / ms, 2), "x", None)


if __name__ == "__main__":
    main(sys.argv[1:])
