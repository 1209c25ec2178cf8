"""Prove on the GPU that the perception-plan-act loop runs and is right.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

One card, full width (640x480 depth, 256 candidates, 32 pyramids, 500 Hz):
  0 gpu-tests  `pytest -m gpu tests/test_gpu.py` in a child process, before
               this process touches the card (one process on it at a time)
  1 device     JAX's platform must be gpu; there is no CPU fallback
  2 physics    env.rollout_fast at 4096 envs x 250 steps (bench.py's shape);
               64 of those envs again on the host CPU, compared
  3 flight     demo.main at its defaults for 248 frames (5 s of take-off,
               then ~3 s of planned flight): rc 0, no panic, plans > 0,
               progress toward the goal; then, on the next frame, the
               depth render against the CPU's, plan() against the
               ray-sphere oracle, and one 16-tick block against the CPU's
  4 raycaster  the Triton kernel against the jnp renderer on the card, at
               B=1 and B=256
  5 fleet      demo --fleet 64 for three blocks
  6 bridge     launch --auto-start --record (the bag is not empty), and
               demo --realtime --duration 5 (its mocap and telemetry
               bands hold)
  7 imported   the seeded procedural orchard baked into a primitives file
               (meshscene.from_orchard), flown by demo --scene-file

Four cards (--four), and nothing else:
  fleet4       sharding.make_fleet_step at 4 x 4096 envs against the same
               envs on one card
  mesh4        demo --fleet 64 --mesh, and make_orchard_fleet_step on four
               cards against the unsharded fly_fleet on one: the fleet
               metrics match

Each phase prints its compile and run seconds. Any failed phase ends the
run with a non-zero exit and no result line. The last line of a passing
run is the result JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
# lowering + XLA compilation (tracing is left out: its events nest)
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def result_line(device: dict) -> str:
    """The run's last line: the contract's JSON object."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def check_device(want_count: int = 1) -> dict:
    """Phase 1: the platform must be gpu, with at least `want_count`
    cards. Raises SystemExit otherwise (there is no CPU fallback)."""
    from agrifly_tpu import backend

    if backend.platform() != "gpu":
        raise SystemExit(f"device check: JAX platform is "
                         f"{backend.platform()!r}, not 'gpu'")
    info = backend.device_info()
    if info["count"] < want_count:
        raise SystemExit(f"device check: {info['count']} GPU(s), "
                         f"need {want_count}")
    return info


def run_phase(name, fn, failures):
    """Run one phase; print its compile and run seconds."""
    t0 = time.perf_counter()
    c0 = _compile_s[0]
    ok = True
    try:
        fn()
    except Exception as e:  # report and go on: every phase gets to run
        traceback.print_exc()
        print(f"[{name}] FAILED: {e}", flush=True)
        failures.append(name)
        ok = False
    wall = time.perf_counter() - t0
    comp = _compile_s[0] - c0
    print(f"[{name}] {'ok' if ok else 'FAILED'}: compile {comp:.1f} s, "
          f"run {wall - comp:.1f} s", flush=True)


def compare_trees(name, got, ref, rtol, atol, codes=()):
    """Discrete leaves equal, float leaves within atol + rtol*|ref|.
    Integer leaves whose last path key is one of `codes` are quantized floats
    (wire codes) and may differ by one code. Prints the worst float leaf;
    raises PhaseFailed on a violation."""
    import jax
    import numpy as np

    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    r_leaves = jax.tree_util.tree_leaves(ref)
    worst, bad, n_code = (0.0, ""), [], 0
    for (path, g), r in zip(g_leaves, r_leaves):
        g, r = np.asarray(g), np.asarray(r)
        key = jax.tree_util.keystr(path)
        if np.issubdtype(r.dtype, np.floating):
            err = np.abs(g.astype(np.float64) - r)
            lim = atol + rtol * np.abs(r)
            ratio = float(np.max(err / lim)) if err.size else 0.0
            if ratio > worst[0]:
                worst = (ratio, f"{key} max|d|={float(err.max()):.3g}")
            if ratio > 1.0 or not np.all(np.isfinite(g)):
                bad.append(f"{key} (max|d| {float(err.max()):.3g})")
        elif jax.tree_util.keystr(path[-1:]).strip(".[]'") in codes:
            d = np.abs(g.astype(np.int64) - r.astype(np.int64))
            n_code += int(np.sum(d > 0))
            if d.size and d.max() > 1:
                bad.append(f"{key} (codes, max|d| {int(d.max())})")
        elif not np.array_equal(g, r):
            bad.append(f"{key} (discrete, {int(np.sum(g != r))} differ)")
    print(f"  {name}: worst float leaf at {worst[0]:.3f} of its tolerance "
          f"({worst[1]}); rtol {rtol}, atol {atol}"
          + (f"; {n_code} wire codes off by one" if codes else ""))
    check(not bad, f"{name}: out of tolerance: {', '.join(bad[:8])}")


def compare_fleets(name, got, ref):
    """Env fleets after a closed-loop rollout: the vehicles' physical state
    within 2e-2 (the offboard controller's f32 acos near 1 bounds command
    agreement between correct implementations at ~1e-2 rad/s, and 250
    ticks feed that back), and flight state, panic flags and step equal.
    Radio codes and filter internals follow the commands and are left
    out."""
    def pick(s):
        return {"plant": s.plant, "fs": s.logic.fs,
                "panic": s.logic.panic_reason, "step": s.step}

    compare_trees(name, pick(got), pick(ref), rtol=1e-3, atol=2e-2)


# ----------------------------------------------------------------------
# one card
# ----------------------------------------------------------------------


def phase_gpu_tests():
    with tempfile.TemporaryDirectory() as d:
        xml_path = os.path.join(d, "gpu.xml")
        # no third-party plugins: one on the card's machine imports a
        # `tests` package of its own
        env = dict(os.environ, AGRIFLY_TEST_GPU="1",
                   PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "tests/test_gpu.py",
             "-q",
             "-p", "no:cacheprovider", "-p", "no:randomly", "-rs",
             f"--junitxml={xml_path}"], cwd=REPO, env=env).returncode
        import xml.etree.ElementTree as ET

        suite = ET.parse(xml_path).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        n = {k: int(suite.get(k, 0)) for k in
             ("tests", "failures", "errors", "skipped")}
    print(f"  gpu tests: {n}")
    check(rc == 0 and n["tests"] > 0 and n["failures"] == n["errors"]
          == n["skipped"] == 0, f"gpu-marked tests: rc {rc}, {n}")


def phase_physics(n_envs=4096, n_steps=250, n_cpu=64):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import env as env_mod

    params = env_mod.make_params(noise_scale=1.0)
    cmd = env_mod.hover_command((0.0, 0.0, 1.5))

    def fleet(n):
        keys = jax.random.split(jax.random.PRNGKey(0), n_envs)[:n]
        states = jax.vmap(lambda k: env_mod.init_state(params, k))(keys)
        cmds = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n,) + x.shape), cmd)
        return states, cmds

    run = jax.jit(jax.vmap(
        lambda s, c: env_mod.rollout_fast(params, s, c, n_steps)[0]))
    states, cmds = fleet(n_envs)
    gpu_out = jax.block_until_ready(run(states, cmds))
    t0 = time.perf_counter()
    gpu_out = jax.block_until_ready(run(states, cmds))
    dt = time.perf_counter() - t0
    print(f"  {n_envs} envs x {n_steps} steps: {dt * 1e3:.1f} ms "
          f"({n_envs * n_steps / dt:.3g} steps/s)")
    cpu = jax.devices("cpu")[0]
    cpu_out = run(*jax.device_put(fleet(n_cpu), cpu))
    compare_fleets("physics gpu[:64] vs cpu",
                   jax.tree_util.tree_map(lambda x: x[:n_cpu], gpu_out),
                   cpu_out)


def _demo_params(**kw):
    from agrifly_tpu.sim import orchard_env

    return orchard_env.make_params(**kw)  # demo's defaults: 640x480/256/32


def phase_flight(state_out):
    import jax
    import numpy as np

    from agrifly_tpu import demo
    from agrifly_tpu.sim import orchard_env
    from agrifly_tpu.utils import checkpoint

    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "final")
        rc = demo.main(["--frames", "248", "--ckpt", ck])
        check(rc == 0, f"demo returned {rc}")
        params = _demo_params()
        template = orchard_env.init_state(params, jax.random.PRNGKey(0))
        s = checkpoint.restore(ck, template)
    goal = np.asarray(params.waypoints[0])
    pos = np.asarray(s.base.plant.pos)
    d0 = float(np.linalg.norm(goal))  # spawn at the origin
    d1 = float(np.linalg.norm(goal - pos))
    print(f"  plans {int(s.plan_count)}, panic {int(s.base.logic.panic_reason)}, "
          f"goal distance {d0:.2f} -> {d1:.2f} m")
    check(int(s.base.logic.panic_reason) == 0, "panic")
    check(int(s.plan_count) > 0, "no plan adopted")
    check(d0 - d1 > 1.0, "no progress toward the goal")
    state_out.append((params, s))


def parity_render(params, s):
    import jax
    import numpy as np

    from agrifly_tpu.render import raycast
    from agrifly_tpu.sim import orchard_env

    cam_att = raycast.camera_attitude(s.base.plant.att)
    gpu = np.asarray(jax.jit(lambda p, a: orchard_env.render_frame(
        params, p, a))(s.base.plant.pos, cam_att))
    cpu = jax.devices("cpu")[0]
    ref = np.asarray(jax.jit(lambda p, a: raycast.render_depth(
        params.render_cfg, params.scene, p, a))(
            *jax.device_put((s.base.plant.pos, cam_att), cpu)))
    diff = np.abs(gpu - ref)
    share = float((diff > 0).mean())
    # FMA contraction moves a hit distance by an ulp or so, which flips
    # floor(t / scale) where t sits on a code boundary: +-1 code, rarely
    print(f"  depth gpu vs cpu: {share:.3g} of pixels differ, "
          f"max {int(diff.max())} codes; {float((ref < 255).mean()):.2f} "
          f"of pixels hit something")
    check(share <= 0.005, f"render parity: {share:.4f} of pixels differ")
    return gpu


def parity_plan(params, s, depth):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from agrifly_tpu.ops import lin3, rotation as rot
    from agrifly_tpu.planner import oracle, rappids
    from agrifly_tpu.render import raycast
    from agrifly_tpu.sim import orchard_env

    R = rot.to_matrix(raycast.camera_attitude(s.base.plant.att))
    vel = lin3.mv3t(R, s.base.plant.vel)
    grav = lin3.mv3t(R, orchard_env.GRAV_W)
    goal = lin3.mv3t(R, params.waypoints[0] - s.base.plant.pos)

    @jax.jit
    def labels(img, key):
        tr, _, _, _, gate, free, _ = rappids._plan_core(
            params.planner, img, key, vel, jnp.zeros(3, jnp.float32), grav,
            goal, params.n_candidates, params.pyramid_capacity,
            params.planner_rounds, params.inflation_downsample, None, 1)
        # 16 candidates at a time: the oracle holds (samples, H, W) arrays
        truth = jax.lax.map(lambda i: oracle.is_collision_free_ground_truth(
            params.planner, img, jax.tree_util.tree_map(lambda x: x[i], tr)),
            jnp.arange(params.n_candidates), batch_size=16)
        return gate, free, truth

    gate, free, truth = (np.asarray(x) for x in labels(
        jnp.asarray(depth), jax.random.PRNGKey(7)))
    false_free = int(np.sum(gate & free & ~truth))
    conservative = int(np.sum(gate & ~free & truth))
    print(f"  plan() vs oracle: {int(gate.sum())} gated candidates, "
          f"{int((gate & free).sum())} labelled free, {false_free} "
          f"false-free, {conservative} conservatively in-collision")
    check(false_free == 0, f"{false_free} false-free labels")


def parity_ticks(params, s):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.sim import orchard_env

    noise = jax.random.normal(jax.random.PRNGKey(3),
                              (params.steps_per_frame, 2, 3), jnp.float32)
    block = jax.jit(lambda st, n: orchard_env.frame_ticks(params, st, n))
    gpu = block(s, noise)
    cpu = block(*jax.device_put((s, noise), jax.devices("cpu")[0]))
    # ulp-level rounding differences (FMA contraction, the backends' own
    # sqrt/div) pass through the offboard attitude controller's acos near
    # 1, which is ill-conditioned in f32: two correct implementations
    # agree on commanded body rates only to ~1e-2 rad/s near hover (the
    # C++ golden-trace finding). 16 ticks move them ~2e-4 rad/s, which
    # flips a uint16 radio code where the command sits on a code boundary.
    compare_trees("16-tick block gpu vs cpu", gpu, cpu, rtol=1e-4, atol=1e-3,
                  codes=("fields",))


def phase_raycaster(width=640, height=480, batches=(1, 256)):
    import jax
    import numpy as np

    from agrifly_tpu.render import orchard, pallas_raycast, raycast
    from benchmarks.gpu_bringup import poses

    cfg = raycast.make_config(width, height, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    ref_fn = jax.jit(jax.vmap(
        lambda p, a: raycast.render_depth(cfg, scene, p, a)))
    ker_fn = jax.jit(lambda p, a: pallas_raycast.render_depth_batch(
        cfg, scene, p, a))
    for batch in batches:
        pos, att = poses(batch)
        got, ref = np.asarray(ker_fn(pos, att)), np.asarray(ref_fn(pos, att))
        diff = np.abs(got - ref)
        share = float((diff > 0).mean())
        print(f"  kernel vs jnp, B={batch}: {share:.3g} of pixels differ, "
              f"max {int(diff.max())} codes")
        check(got.shape == (batch, height, width), f"shape {got.shape}")
        # an ulp of hit distance: +-1 code at code boundaries, or a
        # grazing silhouette ray flipping between hit and miss
        check(share <= 1e-3, f"B={batch}: {share:.4g} of pixels differ")


def phase_fleet():
    from agrifly_tpu import demo

    rc = demo.main(["--fleet", "64", "--frames", "93"])
    check(rc == 0, f"demo --fleet 64 returned {rc}")


def phase_bridge():
    from agrifly_tpu import demo, launch

    with tempfile.TemporaryDirectory() as d:
        bag = os.path.join(d, "bag.jsonl")
        rc = launch.main(["--auto-start", "--frames", "62", "--record", bag])
        check(rc == 0, f"launch returned {rc}")
        with open(bag) as f:
            n = sum(1 for _ in f)
        print(f"  bag: {n} messages")
        check(n > 0, "empty bag")
    rc = demo.main(["--realtime", "--duration", "5"])
    check(rc == 0, f"demo --realtime returned {rc} (bands violated)")


def write_primitives(path, mesh):
    """A MeshScene of spheres and z-axis cylinders in load_primitives'
    text format."""
    import numpy as np

    from agrifly_tpu.render import meshscene

    rows = np.asarray(mesh.prims)[: mesh.count]
    with open(path, "w") as f:
        for r in rows:
            if r[0] == meshscene.PRIM_SPHERE:
                f.write("sphere %r %r %r %r\n" % tuple(float(x) for x in r[1:5]))
            elif r[0] == meshscene.PRIM_CYLINDER:
                f.write("cylinder %r %r %r %r %r\n"
                        % tuple(float(x) for x in r[1:6]))


def phase_imported():
    import numpy as np

    from agrifly_tpu import demo
    from agrifly_tpu.render import meshscene, orchard

    mesh = meshscene.from_orchard(orchard.make_params(seed=0),
                                  (-10.0, 130.0), (-20.0, 20.0))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "orchard.prims")
        write_primitives(path, mesh)
        back = meshscene.load_primitives(path)
        check(back.count == mesh.count and np.allclose(
            np.asarray(back.prims)[: back.count],
            np.asarray(mesh.prims)[: mesh.count]), "primitives round trip")
        print(f"  {mesh.count} primitives")
        rc = demo.main(["--scene-file", path, "--frames", "31"])
    check(rc == 0, f"demo --scene-file returned {rc}")


def main_one_card(failures):
    state = []
    run_phase("flight", lambda: phase_flight(state), failures)
    if state:
        params, s = state[0]
        depth = []
        run_phase("parity-render",
                  lambda: depth.append(parity_render(params, s)), failures)
        if depth:
            run_phase("parity-plan",
                      lambda: parity_plan(params, s, depth[0]), failures)
        run_phase("parity-ticks", lambda: parity_ticks(params, s), failures)
    run_phase("physics", phase_physics, failures)
    run_phase("raycaster", phase_raycaster, failures)
    run_phase("fleet", phase_fleet, failures)
    run_phase("bridge", phase_bridge, failures)
    run_phase("imported", phase_imported, failures)


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------


def phase_fleet4(n_envs=4 * 4096, n_sub=250):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.parallel import sharding
    from agrifly_tpu.sim import env as env_mod

    params = env_mod.make_params(noise_scale=1.0)
    cmd = env_mod.hover_command((0.0, 0.0, 1.5))
    out = {}
    for tag, devs in (("4 cards", jax.devices()[:4]),
                      ("1 card", jax.devices()[:1])):
        mesh = sharding.make_mesh(devs)
        states = sharding.init_fleet(params, mesh, n_envs)
        cmds = jax.device_put(
            jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape), cmd),
            sharding.env_sharding(mesh))
        step = sharding.make_fleet_step(params, mesh, n_envs, n_sub)
        s1, m1 = jax.block_until_ready(step(states, cmds))
        t0 = time.perf_counter()
        s2, m2 = jax.block_until_ready(step(s1, cmds))
        dt = time.perf_counter() - t0
        print(f"  {tag}: {n_envs} envs x {n_sub} steps in {dt * 1e3:.1f} ms "
              f"({n_envs * n_sub / dt:.3g} steps/s); {m2}")
        out[tag] = (jax.device_get(s2), jax.device_get(m2))
    compare_fleets("fleet states 4 vs 1 card", out["4 cards"][0],
                   out["1 card"][0])
    compare_trees("fleet metrics 4 vs 1 card", out["4 cards"][1],
                  out["1 card"][1], rtol=1e-3, atol=1e-3)


def phase_mesh4():
    import jax
    import jax.numpy as jnp

    from agrifly_tpu import demo
    from agrifly_tpu.parallel import sharding
    from agrifly_tpu.sim import orchard_env

    rc = demo.main(["--fleet", "64", "--mesh", "--frames", "62"])
    check(rc == 0, f"demo --fleet 64 --mesh returned {rc}")

    # demo's own program (its params, 31-frame blocks), run for six blocks:
    # take-off, then ~1 s of planned flight from t = 5 s
    fleet, frames, blocks = 64, 31, 6
    params = _demo_params()
    mesh = sharding.make_mesh(jax.devices()[:4])
    states = sharding.init_orchard_fleet(params, mesh, fleet)
    host = jax.device_get(states)  # the sharded step donates its input
    step4 = sharding.make_orchard_fleet_step(params, mesh, fleet,
                                             n_frames=frames)
    step1 = jax.jit(lambda s: orchard_env.fly_fleet(params, s, frames)[0])
    s1 = jax.device_put(host, jax.devices()[0])
    for _ in range(blocks):
        states, m4 = step4(states)
        s1 = step1(s1)
    m1 = sharding.OrchardFleetMetrics(
        mean_pos=s1.base.plant.pos.mean(0),
        num_panicked=(s1.base.logic.panic_reason != 0).sum().astype(jnp.int32),
        num_plans=s1.plan_count.sum().astype(jnp.int32),
        num_landed=(s1.mstage == 2).sum().astype(jnp.int32))
    print(f"  4 cards: {jax.device_get(m4)}\n  1 card:  {jax.device_get(m1)}")
    # counts equal; the mean position to 1 cm (see compare_fleets)
    compare_trees("orchard fleet metrics 4 vs 1 card", jax.device_get(m4),
                  jax.device_get(m1), rtol=1e-3, atol=1e-2)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    failures = []
    print(f"chip_smoke: {'four cards' if four else 'one card'}", flush=True)
    if not four:
        # before this process touches the card: one process on it at a time
        run_phase("gpu-tests", phase_gpu_tests, failures)

    import jax

    from agrifly_tpu import backend

    jax.monitoring.register_event_duration_secs_listener(
        lambda ev, secs, **_: _compile_s.__setitem__(
            0, _compile_s[0] + (secs if ev in COMPILE_EVENTS else 0.0)))
    info = check_device(4 if four else 1)
    print(backend.card_name_power(), flush=True)
    print(f"compile cache: {backend.setup_compile_cache()}", flush=True)
    print(f"device: {info}", flush=True)
    if four:
        run_phase("fleet4", phase_fleet4, failures)
        run_phase("mesh4", phase_mesh4, failures)
        info = dict(info, count=len(jax.devices()))
    else:
        main_one_card(failures)
    if failures:
        print(f"FAILED phases: {', '.join(failures)}", flush=True)
        return 1
    print(result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
