"""Render-path decision and bring-up timings on one GPU.

Sections (all by default, or the ones named by --only a,b,...):
  render  the Triton raycaster against the jnp renderer at 640x480, B=1
          and B=256: pixel parity, time per call
  sweep   the kernel's tile and warp count at B=256
  frames  the single-vehicle orchard frame (orchard_env.fly, 256
          candidates) and a 256-vehicle fly_fleet frame, with each render
          path; timed in turns (triton, jnp, jnp, triton)
  strip   the imported-world renderer (meshscene) with strip culling on
          and off
  ticks   the 16-tick block alone: ms/frame, and the device idle share of
          a traced window of it and of the whole single-vehicle frame
  read    device-read latency: one tiny dispatch plus a host read

Prints one JSON line per number and writes them all to
chiprun_out/gpu_bringup.json. Refuses to run without a GPU.

    python -m benchmarks.gpu_bringup [--only render,ticks] [--fleet 256]

--image WxH and --cpu exist to rehearse the script at a tiny size on the
CPU (the Triton path then needs interpret mode); such numbers are not
device numbers.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time
import traceback

from benchmarks import _util

OUT = os.path.join("chiprun_out", "gpu_bringup.json")
RESULTS: dict = {}
W, H = 640, 480


def record(key, value, unit=""):
    RESULTS[key] = value
    print(json.dumps({"metric": key, "value": value, "unit": unit}), flush=True)


def _dump():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(RESULTS, f, indent=1, sort_keys=True)


def poses(batch, seed=0):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.ops import rotation as rot
    from agrifly_tpu.render import raycast

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pos = jax.random.uniform(k1, (batch, 3), jnp.float32,
                             jnp.array([0.0, -20.0, 1.0]),
                             jnp.array([100.0, 20.0, 5.0]))
    yaw = jax.random.uniform(k2, (batch,), jnp.float32, -0.6, 0.6)
    att = jax.vmap(lambda y: raycast.camera_attitude(
        rot.from_euler_ypr(y, jnp.float32(0.0), jnp.float32(0.0))))(yaw)
    return pos, att


def _variant(name):
    """Select the render path of the next trace: 'triton' or 'jnp'."""
    from agrifly_tpu import backend

    backend.gpu_raycast = lambda: name == "triton"


def section_render():
    import jax
    import numpy as np

    from agrifly_tpu.render import orchard, raycast

    cfg = raycast.make_config(W, H, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    for batch in (1, 256):
        pos, att = poses(batch)
        fns = {}
        for name in ("triton", "jnp"):
            _variant(name)
            fns[name] = jax.jit(
                lambda p, a: raycast.render_depth_batch(cfg, scene, p, a))
            t0 = time.perf_counter()
            out = np.asarray(fns[name](pos, att))
            record(f"render_b{batch}_{name}_compile_s", time.perf_counter() - t0, "s")
            if name == "triton":
                ref = out
            else:
                diff = out != ref
                record(f"render_b{batch}_{name}_vs_triton_pixel_share",
                       float(diff.mean()))
                record(f"render_b{batch}_{name}_vs_triton_max_code_diff",
                       int(np.abs(out - ref).max()))
        for name in ("triton", "jnp", "jnp", "triton"):
            t = _util.pipelined_time(fns[name], pos, att, calls=20)
            record(f"render_b{batch}_{name}_ms", t * 1e3, "ms")
    _variant("triton")


def section_sweep():
    import jax

    from agrifly_tpu.render import orchard, pallas_raycast, raycast

    cfg = raycast.make_config(W, H, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    pos, att = poses(256)
    for bh, bw, warps in ((4, 128, 4), (2, 128, 4), (4, 64, 4), (2, 64, 2),
                          (4, 128, 8), (8, 64, 8), (2, 256, 4), (4, 256, 8),
                          (1, 128, 1), (8, 128, 8), (4, 128, 4)):
        f = jax.jit(lambda p, a, bh=bh, bw=bw, w=warps:
                    pallas_raycast.render_depth_batch(cfg, scene, p, a, bh=bh,
                                                      bw=bw, num_warps=w))
        t = _util.pipelined_time(f, pos, att, calls=20)
        record(f"render_b256_tile{bh}x{bw}_w{warps}_ms", t * 1e3, "ms")


def _fleet_state(params, fleet):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import orchard_env

    keys = jax.random.split(jax.random.PRNGKey(0), fleet)
    lanes = (jnp.arange(fleet, dtype=jnp.float32) - (fleet - 1) / 2.0) * 3.0
    spawns = jnp.stack([jnp.zeros(fleet), lanes, jnp.zeros(fleet)], axis=1)
    return jax.vmap(lambda k, p: orchard_env.init_state(params, k, pos=p))(
        keys, spawns)


def section_frames(fleet):
    import jax

    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params(width=W, height=H)
    s1 = orchard_env.init_state(params, jax.random.PRNGKey(0))
    sf = _fleet_state(params, fleet)
    n = 31
    for tag, state, make, per_call, calls in (
            ("single", s1, lambda: jax.jit(
                lambda s: orchard_env.fly(params, s, n)[0]), n, 4),
            (f"fleet{fleet}", sf, lambda: jax.jit(
                lambda s: orchard_env.fly_fleet(params, s, 1)[0]), 1, 6)):
        fns = {}
        for name in ("triton", "jnp"):
            _variant(name)
            fns[name] = make()
            t0 = time.perf_counter()
            jax.block_until_ready(fns[name](state))
            record(f"frame_{tag}_{name}_compile_s", time.perf_counter() - t0, "s")
        for name in ("triton", "jnp", "jnp", "triton"):
            t = _util.pipelined_time(fns[name], state, calls=calls)
            record(f"frame_{tag}_{name}_ms_per_frame", t / per_call * 1e3, "ms")
        _dump()
    _variant("triton")


def section_strip():
    import jax

    from agrifly_tpu.render import meshscene, orchard, raycast

    cfg = raycast.make_config(W, H, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    mesh = meshscene.from_orchard(scene, (-10.0, 130.0), (-20.0, 20.0))
    record("strip_scene_primitives", mesh.count)
    pos, att = poses(1)
    for cull in (True, False, True, False):
        f = jax.jit(lambda p, a, c=cull: meshscene.render_depth(
            cfg, mesh, p, a, strip_cull=c))
        t = _util.pipelined_time(f, pos[0], att[0], calls=20)
        record(f"strip_cull_{'on' if cull else 'off'}_ms", t * 1e3, "ms")


def _busy_idle(trace_dir):
    """Device busy time (union of kernel intervals on the GPU stream lines)
    and idle share over [first kernel start, last kernel end]; plus the
    kernels with the largest summed duration."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = ProfileData.from_file(path)
    spans, by_name, lines = [], {}, set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(f"{plane.name}|{line.name}")
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.duration_ns
    if not spans:
        return {"lines": sorted(lines), "kernels": 0}
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"lines": sorted(lines), "kernels": len(spans),
            "window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window,
            "top_kernels_ms": [(k[:80], v / 1e6) for k, v in top]}


def section_ticks():
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params(width=W, height=H)
    s = orchard_env.init_state(params, jax.random.PRNGKey(0))
    n = 31

    def ticks_only(s):
        def body(carry, _):
            k, sub = jax.random.split(carry.base.key)
            noise = jax.random.normal(
                sub, (params.steps_per_frame, 2, 3), jnp.float32)
            carry = carry._replace(base=carry.base._replace(key=k))
            return orchard_env.frame_ticks(params, carry, noise), None
        return jax.lax.scan(body, s, None, length=n)[0]

    for tag, fn in (("ticks", jax.jit(ticks_only)),
                    ("frame", jax.jit(lambda s: orchard_env.fly(params, s, n)[0]))):
        jax.block_until_ready(fn(s))
        t = _util.pipelined_time(fn, s, calls=4)
        record(f"{tag}_block_ms_per_frame", t / n * 1e3, "ms")
        with tempfile.TemporaryDirectory() as d:
            jax.profiler.start_trace(d)
            out = s
            for _ in range(3):
                out = fn(out)
            jax.block_until_ready(out)
            jax.profiler.stop_trace()
            stats = _busy_idle(d)
        for k, v in stats.items():
            record(f"{tag}_trace_{k}", v)
        _dump()


def section_read():
    import statistics

    import jax
    import jax.numpy as jnp
    import numpy as np

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    np.asarray(f(x))
    ts = []
    for _ in range(200):
        t0 = time.perf_counter()
        x = f(x)
        np.asarray(x)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    record("read_roundtrip_median_us", statistics.median(ts) * 1e6, "us")
    record("read_roundtrip_p90_us", ts[int(0.9 * len(ts))] * 1e6, "us")


def main(argv):
    global W, H
    argv = _util.setup(argv)
    from agrifly_tpu import backend

    only = (argv[argv.index("--only") + 1].split(",") if "--only" in argv
            else ["read", "render", "sweep", "strip", "ticks", "frames"])
    fleet = int(argv[argv.index("--fleet") + 1]) if "--fleet" in argv else 256
    if "--image" in argv:
        W, H = (int(x) for x in argv[argv.index("--image") + 1].split("x"))
    record("nvidia_smi", backend.card_name_power())
    record("device", backend.device_info())
    sections = {"render": section_render, "sweep": section_sweep,
                "frames": lambda: section_frames(fleet),
                "strip": section_strip, "ticks": section_ticks,
                "read": section_read}
    failed = []
    for name in only:
        t0 = time.perf_counter()
        try:
            sections[name]()
        except Exception:  # one section's failure must not lose the others
            traceback.print_exc()
            failed.append(name)
        record(f"section_{name}_s", time.perf_counter() - t0, "s")
        _dump()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
