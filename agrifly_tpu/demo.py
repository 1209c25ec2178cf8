"""End-to-end demo: the agrifly.launch equivalent.

`python -m agrifly_tpu.demo` flies the full perception-plan-act loop —
takeoff, RAPPIDS planning against the on-device rendered orchard, receding-
horizon tracking — and prints a vehicle_monitor-style status line per
second of sim time. Optionally writes the demo CSV log and a checkpoint.

Flags:
  --frames N        number of 32 ms frames to fly (default 300 ~ 10 s)
  --goal X Y Z      goal in world frame (default 120 0 3.5)
  --seed S          orchard world seed
  --image WxH       depth image size (default 640x480)
  --candidates N    RAPPIDS candidates per frame (default 256)
  --csv PATH        write flight CSV
  --ckpt PATH       write final-state checkpoint
  --cpu             run on the CPU (small image recommended); without it
                    the demo refuses to start when JAX finds no GPU
  --traj-file PATH  waypoint file (trajectory.txt format: 'x,y,z' lines,
                    agrifly.launch traj_file parity); lands after the last
  --land            descend + idle motors after the last waypoint
"""

from __future__ import annotations

import argparse
import sys
import time


def _teleop_loop(args, params, orchard_env, onboard):
    """Operator-in-the-loop flight: start button arms the mission, red
    button kills through the real radio wire (codec -> 30 ms delay line ->
    onboard decode -> FS_KILLED), mirroring the reference's keyboard/
    joystick operator flow (hiperlab_hardware keyboardmain.cpp:26-78,
    VehicleMonitor/main.cpp:92-143)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from agrifly_tpu import backend
    from agrifly_tpu.io import radio as radio_codec
    from agrifly_tpu.io import teleop
    from agrifly_tpu.sim import delayline

    js = teleop.make(args.teleop)

    # Fly BLK frames per jit call (the scanned fly block) and poll the
    # operator between blocks: one host dispatch per block instead of per
    # frame, and a kill lands within one block (the 30 ms radio delay is
    # 15 ticks < 1 frame, so the onboard FSM sees it inside the same block
    # it was pushed in). 10 frames (320 ms of sim) per operator poll on an
    # accelerator is an untuned default; the CPU keeps short blocks for
    # test granularity.
    BLK = 10 if backend.device_blocks() else 4
    # disarmed: planning/flight gated out until the start button
    disarmed = params._replace(start_flight_step=jnp.int32(2**30))
    cur_params = {False: disarmed}
    fly_fns = {}  # (armed, blk) -> jitted fly

    def _fly_fn(armed, blk):
        fn = fly_fns.get((armed, blk))
        if fn is None:
            p = cur_params[armed]
            fn = jax.jit(lambda s: orchard_env.fly(p, s, blk)[0])
            fly_fns[(armed, blk)] = fn
        return fn

    state = orchard_env.init_state(params, jax.random.PRNGKey(args.seed))
    dt = float(params.base.dt_us) * 1e-6
    armed = killed = False
    print(f"teleop ({args.teleop}): press start to arm, red to kill "
          f"({BLK} frames per block)")
    # Pipelined: dispatch block b, read block b-1's status — the host
    # readback overlaps the in-flight block's compute. Operator time is
    # known statically (start step + frames-flown-so-far), so polls never
    # touch the device; only an arm/kill EVENT syncs the queue. Compile
    # blocks (first call per (armed, blk) shape) are timed out of the
    # steady figure.
    steps_per_frame = int(params.steps_per_frame)
    start_step = int(state.base.step)
    prev = None
    ran = n_excl = 0
    frames_done = 0
    t_excl = 0.0
    t_wall = time.perf_counter()
    b = 0
    while frames_done < max(BLK, args.frames):
        blk = min(BLK, max(BLK, args.frames) - frames_done)
        t = (start_step + frames_done * steps_per_frame) * dt
        jsv = js.poll(t)
        if jsv.buttonStart and not armed:
            armed = True
            cur_params[True] = params._replace(
                start_flight_step=jnp.int32(
                    start_step + frames_done * steps_per_frame + 1))
            print(f"t={t:6.2f}s ARMED — mission start (start button)")
        if jsv.buttonRed and not killed:
            killed = True
            state = jax.block_until_ready(state)  # drain the queue
            ktype, kflags, kfields = radio_codec.make_kill_command()
            state = state._replace(base=state.base._replace(
                ring=delayline.push(state.base.ring, ktype, kflags, kfields,
                                    state.base.step, jnp.bool_(True))))
            print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                  f"(red button)")
        compile_blk = (armed, blk) not in fly_fns
        t_blk = time.perf_counter()
        state = _fly_fn(armed, blk)(state)
        ran += 1
        frames_done += blk
        b += 1
        if compile_blk:
            jax.block_until_ready(state)
            t_excl += time.perf_counter() - t_blk
            n_excl += 1
        fs = None
        if prev is not None and (b % 8 == 0 or killed):
            fs = int(prev.base.logic.fs)
            pos = np.asarray(prev.base.plant.pos)
            panic = int(prev.base.logic.panic_reason)
            print(f"t={t:6.2f}s pos=({pos[0]:7.2f},{pos[1]:6.2f},"
                  f"{pos[2]:5.2f}) fs={fs} "
                  f"panic={onboard.PANIC_REASON_NAMES.get(panic, panic)}")
        prev = state
        if fs == onboard.FS_KILLED:
            break
    if hasattr(js, "close"):
        js.close()
    state = jax.block_until_ready(state)
    wall = time.perf_counter() - t_wall
    if int(state.base.logic.fs) == onboard.FS_KILLED:
        print("vehicle KILLED — motors off")
    sim_time = (int(state.base.step) - start_step) * dt
    msg = (f"teleop flew {sim_time:.1f}s of sim time in {wall:.1f}s wall "
           f"({sim_time / wall:.2f}x realtime incl. compile)")
    if ran > n_excl:
        blk_sim = BLK * steps_per_frame * dt
        steady = (wall - t_excl) / (ran - n_excl)
        msg += (f"; steady state {blk_sim / steady:.2f}x "
                f"realtime (poll every {blk_sim * 1e3:.0f} ms of sim)")
    print(msg)
    return 0


def _realtime_loop(args):
    """Wall-clock real-time sim (the reference's `simulator` ROS node:
    HardwareTimer + ros::Rate(500), Simulator/main.cpp:231,310): pace the
    500 Hz vehicle loop against the wall clock, publish the full topic
    surface at reference cadences, render a live vehicle_monitor line
    each second, and (with --teleop) poll the operator at ~100 Hz — start
    arms a hover, red kills through the real radio wire."""
    import numpy as np

    from agrifly_tpu.io import bridge as bridge_mod
    from agrifly_tpu.io import messages as msgs
    from agrifly_tpu.io import radio as radio_codec
    from agrifly_tpu.io import teleop as teleop_mod
    from agrifly_tpu.sim import env as env_mod
    from agrifly_tpu.utils import monitor as monitor_mod

    params = env_mod.make_params(noise_scale=1.0)
    br = bridge_mod.SimBridge(params, vehicle_id=1, seed=args.seed)
    mon = monitor_mod.VehicleMonitor(br.bus, 1, use_sim_time=False)

    js = teleop_mod.make(args.teleop) if args.teleop else None

    ground = env_mod.hover_command(des_pos=(0.0, 0.0, 0.0))
    hover = env_mod.hover_command(des_pos=(0.0, 0.0, 1.5))
    ctl = {"cmd": hover if js is None else ground,
           "armed": js is None, "killed": False}
    from agrifly_tpu import backend

    rate = float(args.rate)
    block = max(1, int(round(rate / 100.0)))  # ~100 Hz operator quanta
    quanta_per_s = max(1, int(round(rate / block)))
    # On an accelerator each quantum runs as one scanned jit call on the
    # packed carrier, pipelined one deep (per-tick dispatch plus a device
    # read would not fit the 2 ms tick). The 40-tick (80 ms) quantum is an
    # untuned default: operator latency is <= 2 quanta. The CPU keeps
    # per-tick granularity (cmd re-read every tick).
    device_blocks = backend.device_blocks()
    if device_blocks:
        block = max(block, 40)
        quanta_per_s = max(1, int(round(rate / block)))

    def on_quantum(b, k):
        t = k * block / rate
        if js is not None:
            jsv = js.poll(t)
            if jsv.buttonStart and not ctl["armed"]:
                ctl["armed"] = True
                ctl["cmd"] = hover
                print(f"t={t:6.2f}s ARMED — hover setpoint (start button)")
            if jsv.buttonRed and not ctl["killed"]:
                ctl["killed"] = True
                raw = radio_codec.fields_to_bytes(
                    *radio_codec.make_kill_command())
                b.bus.publish("radio_command1", msgs.RadioCommand(raw=raw))
                print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                      f"(red button)")
        if k % quanta_per_s == 0:
            pos = np.asarray(b.state.plant.pos)
            print(f"[{t:5.1f}s wall] {mon.render()}  "
                  f"z={pos[2]:5.2f}m")

    print(f"realtime sim: {rate:.0f} Hz wall-clock pacing, "
          f"block={block} ticks/quantum"
          + (" (device blocks)" if device_blocks else "")
          + f", duration {args.duration}s")
    report = br.run_realtime(
        args.duration, lambda: ctl["cmd"], rate_hz=rate, block=block,
        on_quantum=on_quantum, device_blocks=device_blocks)
    if js is not None and hasattr(js, "close"):
        js.close()
    # pass/fail on the sim's own cadences; the cmd band reflects the
    # attached commander (a teleop kill is not a 50 Hz commander)
    ok = all(report["bands_ok"].get(k, False) for k in ("mocap", "telemetry"))
    print(f"achieved {report['achieved_tick_hz']:.1f} Hz "
          f"(target {rate:.0f}), late {report['late_quanta']}/"
          f"{report['n_quanta']} quanta (max {report['max_late_s']*1e3:.2f} ms)")
    print("topic rates (wall): " + "  ".join(
        f"{k}={v:.1f}Hz" for k, v in report["topic_hz"].items()))
    print("bands " + ("OK" if ok else "VIOLATED") + f": {report['bands_ok']}")
    return 0 if ok else 1


def _realtime_orchard_loop(args, params):
    """Wall-clock-paced full perception-plan-act loop
    (OrchardBridge.run_realtime): the reference's real-time pacing
    (Simulator/main.cpp:231,310) applied to the RAPPIDS pipeline — which
    the reference itself can only run lockstep (sync_simulator waits on
    AirSim images). Frames are paced at the params' own frame rate
    (31.25 Hz at reference cadences, or --rate/16), the topic surface
    publishes live, and --teleop polls each quantum: start arms the
    mission, red kills through the radio wire."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from agrifly_tpu import backend
    from agrifly_tpu.io import bridge as bridge_mod
    from agrifly_tpu.io import messages as msgs
    from agrifly_tpu.io import radio as radio_codec
    from agrifly_tpu.io import teleop as teleop_mod
    from agrifly_tpu.models import logic as onboard

    js = teleop_mod.make(args.teleop) if args.teleop else None
    # operator-armed missions hold planning until the start button
    if js is not None:
        params = params._replace(start_flight_step=jnp.int32(2 ** 30))
    ob = bridge_mod.OrchardBridge(params, vehicle_id=1, seed=args.seed,
                                  publish_images=False)
    frame_hz = 1e6 / (float(params.base.dt_us) * int(params.steps_per_frame))
    # --rate is the TICK rate (reference 500 Hz); frames pace at
    # rate / steps_per_frame (31.25 Hz at reference cadences)
    rate = float(args.rate) / int(params.steps_per_frame)
    # quantum size: 2-frame quanta (64 ms budget for one device read and
    # dispatch) on an accelerator is an untuned default; the CPU keeps
    # per-frame operator granularity
    block = 2 if backend.device_blocks() else 1
    ctl = {"armed": js is None, "killed": False}
    vid = ob.vehicle_id
    quanta_per_s = max(1, int(round(rate / block)))

    def on_quantum(b, k):
        t = k * block / rate
        if js is not None:
            jsv = js.poll(t)
            if jsv.buttonStart and not ctl["armed"]:
                ctl["armed"] = True
                # start_flight_step is traced in the block jit — the arm
                # is recompile-free (no stall inside the paced region)
                b.params = b.params._replace(
                    start_flight_step=jnp.int32(
                        int(b.last_outs["step"][-1]) + 1))
                print(f"t={t:6.2f}s ARMED — mission start (start button)")
            if jsv.buttonRed and not ctl["killed"]:
                ctl["killed"] = True
                raw = radio_codec.fields_to_bytes(
                    *radio_codec.make_kill_command())
                b.bus.publish(f"radio_command{vid}",
                              msgs.RadioCommand(raw=raw))
                print(f"t={t:6.2f}s KILL — emergency-kill on the radio "
                      f"(red button)")
        if k % quanta_per_s == 0:
            row = jax.tree_util.tree_map(lambda x: x[-1], b.last_outs)
            pos = np.asarray(row["pos"])
            panic = int(row["panic"])
            print(f"[{t:5.1f}s wall] t_sim={int(row['step']) * 0.002:6.2f}s "
                  f"pos=({pos[0]:7.2f},{pos[1]:6.2f},{pos[2]:5.2f}) "
                  f"fs={int(row['flight_state'])} "
                  f"panic={onboard.PANIC_REASON_NAMES.get(panic, panic)} "
                  f"plans={int(row['plan_count'])}")

    print(f"realtime orchard sim: {rate:.2f} Hz frame pacing "
          f"(nominal {frame_hz:.2f}), {block} frames/quantum, "
          f"duration {args.duration}s"
          + (f", teleop {args.teleop}" if js else ""))
    report = ob.run_realtime(args.duration, rate_hz=rate, block=block,
                             on_quantum=on_quantum)
    if js is not None and hasattr(js, "close"):
        js.close()
    ok = all(report["bands_ok"].values())
    print(f"achieved {report['achieved_frame_hz']:.2f} Hz frames "
          f"(target {rate:.2f}), late {report['late_quanta']}/"
          f"{report['n_quanta']} quanta "
          f"(max {report['max_late_s'] * 1e3:.2f} ms)")
    print("topic rates (wall): " + "  ".join(
        f"{k}={v:.2f}Hz" for k, v in report["topic_hz"].items()))
    print("bands " + ("OK" if ok else "VIOLATED") + f": {report['bands_ok']}")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--goal", type=float, nargs=3, default=(120.0, 0.0, 3.5))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image", type=str, default="640x480")
    ap.add_argument("--candidates", type=int, default=256)
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; without it the demo refuses to "
                         "start when JAX finds no GPU")
    ap.add_argument("--traj-file", type=str, default=None,
                    help="waypoint file, one 'x,y,z' per line "
                         "(trajectory.txt format); implies landing after "
                         "the last waypoint")
    ap.add_argument("--land", action="store_true",
                    help="descend and idle after the last waypoint")
    ap.add_argument("--fleet", type=int, default=1,
                    help="fly N vehicles abreast as one batched program "
                         "(independent full perception-plan-act loops)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the fleet's vehicle axis over all visible "
                         "devices (shard_map; fleet must divide the device "
                         "count) — the multi-chip scale-out path")
    ap.add_argument("--record-images", action="store_true",
                    help="with --record: also publish + record the depth/"
                         "rgb image topics (base64 in the JSONL; the "
                         "reference's rosbag script excludes images too)")
    ap.add_argument("--record", type=str, default=None,
                    help="record every published topic (truth + planner/"
                         "controller diagnostics) to a JSONL file — the "
                         "rosbag_record workflow; flies pipelined "
                         "32-frame blocks through the topic bridge with "
                         "per-frame topic fidelity (single vehicle)")
    ap.add_argument("--teleop", type=str, default=None,
                    help="operator-in-the-loop mission control "
                         "(keyboardmain.cpp / VehicleMonitor parity): "
                         "'keyboard' ('s' arms, 'b' = red button kills), "
                         "'joystick' (Linux js device: Start arms, B "
                         "kills), or 'scripted:T:BUTTON,...' (e.g. "
                         "'scripted:0.5:buttonStart,3:buttonRed'). The "
                         "mission is NOT auto-started: the start button "
                         "arms it; the red button sends an emergency-kill "
                         "through the real radio codec + delay line")
    ap.add_argument("--realtime-orchard", action="store_true",
                    help="wall-clock real-time FULL perception-plan-act "
                         "loop (OrchardBridge.run_realtime): frames paced "
                         "at --rate/steps_per_frame Hz (31.25 at the "
                         "reference 500 Hz), live topic surface + status "
                         "line; combine with --teleop (start arms, red "
                         "kills). The reference can only run this "
                         "pipeline lockstep")
    ap.add_argument("--realtime", action="store_true",
                    help="wall-clock real-time sim (Simulator/main.cpp "
                         "HardwareTimer + ros::Rate(500) parity): pace "
                         "the 500 Hz vehicle loop against the wall clock, "
                         "publish the topic surface at reference "
                         "cadences, live vehicle_monitor line per "
                         "second; combine with --teleop for operator "
                         "arm/kill at ~100 Hz polls. NB on a GPU the "
                         "ticks run in 40-tick (80 ms) dispatch quanta, "
                         "so operator/radio injection lands on an 80 ms "
                         "grid (~160 ms worst case) vs the reference "
                         "node's 2 ms tick; on CPU injection is "
                         "per-quantum at --rate granularity")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="--realtime flight duration in wall seconds")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="--realtime tick rate target in Hz (the "
                         "reference's 500; reduce on slow hosts)")
    ap.add_argument("--rgb", type=str, default=None,
                    help="write a shaded RGB frame (binary PPM) rendered "
                         "from the final pose — Scene-image parity for both "
                         "the procedural orchard and imported worlds")
    ap.add_argument("--scene-file", type=str, default=None,
                    help="explicit world geometry: .obj (Helios-export "
                         "triangles) or a primitives text file "
                         "(render/meshscene.py); default = procedural "
                         "hashed orchard")
    args = ap.parse_args(argv)

    if args.cpu:
        import os

        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import numpy as np

    from agrifly_tpu import backend

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    backend.require_device(allow_cpu=args.cpu)
    backend.setup_compile_cache()

    if args.realtime:
        return _realtime_loop(args)

    from agrifly_tpu.models import logic as onboard
    from agrifly_tpu.sim import orchard_env

    w, h = (int(x) for x in args.image.split("x"))
    waypoints = None
    if args.traj_file:
        from agrifly_tpu.sim import mission

        waypoints = mission.load_trajectory_file(args.traj_file)
        print(f"loaded {len(waypoints)} waypoints from {args.traj_file}")
    mesh_scene = None
    if args.scene_file:
        from agrifly_tpu.render import meshscene

        if args.scene_file.endswith(".obj"):
            mesh_scene = meshscene.load_obj(args.scene_file)
        else:
            mesh_scene = meshscene.load_primitives(args.scene_file)
        print(f"loaded explicit scene: {mesh_scene.count} primitives "
              f"from {args.scene_file}")
    params = orchard_env.make_params(
        goal_world=tuple(args.goal),
        width=w, height=h,
        n_candidates=args.candidates,
        seed=args.seed,
        waypoints=waypoints,
        land=args.land or args.traj_file is not None,
        mesh_scene=mesh_scene,
    )
    if args.realtime_orchard:
        return _realtime_orchard_loop(args, params)
    if args.record:
        # rosbag_record_airsim.sh workflow: drive the orchard loop through
        # the topic bridge and bus-record everything it publishes
        from agrifly_tpu.io import bridge as bridge_mod

        # image topics are opt-in here: the recorder drops them anyway
        # (rosbag_record_airsim.sh parity), and rendering + transferring
        # ~2 MB/frame of unconsumed images dominates the wall clock
        ob = bridge_mod.OrchardBridge(params, vehicle_id=1, seed=args.seed,
                                      publish_images=args.record_images)
        rec = bridge_mod.MessageRecorder(ob.bus, args.record,
                                         record_images=args.record_images)
        # publish-per-frame fidelity, but fly 32-frame blocks per jit
        # call on an accelerator (an untuned default), pipelined one deep
        # (block k flies while block k-1's topics publish, so the flight
        # hides behind the host's serialization work). Recording is not
        # interactive, so the <=2-block command latency is fine wide.
        BLK = 32 if backend.device_blocks() else 1
        print(f"agrifly_tpu demo (recording): {jax.devices()[0].platform} "
              f"backend, {w}x{h} depth, {BLK} frames/block -> {args.record}")
        t_wall = time.perf_counter()

        def on_block(outs, done):
            # status from the block's own output rows — reading ob.state
            # here would unpack the packed carry every block
            if int(outs["panic"][-1]) != 0:
                print("PANIC — aborting")
                return False
            if done % 32 < outs["step"].shape[0]:
                pos = outs["pos"][-1]
                print(f"t={int(outs['step'][-1]) * 0.002:6.2f}s "
                      f"pos=({pos[0]:7.2f},{pos[1]:6.2f},{pos[2]:5.2f}) "
                      f"plans={int(outs['plan_count'][-1])}")

        ob.fly_frames_pipelined(args.frames, BLK, on_block)
        rec.close()
        wall = time.perf_counter() - t_wall
        sim_s = int(ob.state.base.step) * 0.002
        print(f"recorded {rec.count} messages over {sim_s:.1f}s sim in "
              f"{wall:.1f}s wall ({sim_s / wall:.2f}x realtime incl. compile)")
        return 0

    import jax.numpy as jnp

    if args.teleop:
        return _teleop_loop(args, params, orchard_env, onboard)

    fleet = max(1, args.fleet)
    if fleet == 1:
        state = orchard_env.init_state(params, jax.random.PRNGKey(args.seed))
    else:
        # one batched program, N independent vehicles abreast of each other
        keys = jax.random.split(jax.random.PRNGKey(args.seed), fleet)
        lanes = (jnp.arange(fleet, dtype=jnp.float32) - (fleet - 1) / 2.0) * 3.0
        spawns = jnp.stack([jnp.zeros(fleet), lanes, jnp.zeros(fleet)], axis=1)
        state = jax.vmap(lambda k, p: orchard_env.init_state(params, k, pos=p))(
            keys, spawns
        )

    frames_per_block = 31  # ~1 s of sim time

    def _status_vec(s):
        """Pack the printed status into ONE small array: the host reads a
        single buffer per status line instead of ~6 (each read drains the
        dispatch queue, so fewer+smaller reads matter)."""
        f32 = jnp.float32
        if fleet == 1:
            return jnp.stack([
                s.base.step.astype(f32), s.base.plant.pos[0],
                s.base.plant.pos[1], s.base.plant.pos[2],
                s.base.logic.fs.astype(f32),
                s.base.logic.panic_reason.astype(f32),
                s.plan_count.astype(f32), s.waypoint_idx.astype(f32),
                s.mstage.astype(f32)])
        pos = s.base.plant.pos
        return jnp.stack([
            s.base.step[0].astype(f32), pos[:, 0].min(), pos[:, 0].max(),
            pos[:, 2].min(), pos[:, 2].max(),
            (s.base.logic.panic_reason != 0).sum().astype(f32),
            s.plan_count.sum().astype(f32),
            (s.mstage == 2).sum().astype(f32)])

    if fleet == 1:
        def _fly_status(s):
            s2, outs = orchard_env.fly(params, s, frames_per_block)
            return s2, outs, _status_vec(s2)

        fly_block = jax.jit(_fly_status)
    elif args.mesh:
        # shard the vehicle axis over the device mesh (full perception loop
        # per shard; metrics ride psums)
        from agrifly_tpu.parallel import sharding as shard_mod

        mesh = shard_mod.make_mesh()
        if fleet % mesh.devices.size:
            raise SystemExit(
                f"--fleet {fleet} must divide the {mesh.devices.size}-device mesh")
        state = jax.device_put(
            state, jax.tree_util.tree_map(
                lambda _: shard_mod.env_sharding(mesh), state))
        _mesh_step = shard_mod.make_orchard_fleet_step(
            params, mesh, fleet, n_frames=frames_per_block)
        _mesh_vec = jax.jit(_status_vec)

        def fly_block(s):
            s2, _metrics = _mesh_step(s)
            return s2, None, _mesh_vec(s2)
        print(f"mesh: {mesh.devices.size} devices, "
              f"{fleet // mesh.devices.size} vehicles/device")
    else:
        # fly_fleet batches the perception frame and the tick block with
        # vmap; bit-identical to vmap(fly)
        def _fly_fleet_status(s):
            s2, outs = orchard_env.fly_fleet(params, s, frames_per_block)
            return s2, outs, _status_vec(s2)

        fly_block = jax.jit(_fly_fleet_status)

    print(f"agrifly_tpu demo: {jax.devices()[0].platform} backend, "
          f"{w}x{h} depth, goal {tuple(args.goal)}"
          + (f", fleet of {fleet}" if fleet > 1 else ""))
    def _status(vec):
        """Print one status line from the packed vec; returns
        (panicked, done). One small device read (syncs up to vec's block)."""
        v = np.asarray(vec)
        sim_t = v[0] * 0.002
        if fleet == 1:
            panic = int(v[5])
            mstage = {0: "cruise", 1: "landing", 2: "complete"}[int(v[8])]
            print(
                f"t={sim_t:6.2f}s pos=({v[1]:7.2f},{v[2]:6.2f},{v[3]:5.2f}) "
                f"fs={int(v[4])} "
                f"panic={onboard.PANIC_REASON_NAMES.get(panic, panic)} "
                f"plans={int(v[6])} wp={int(v[7])} {mstage}"
            )
            return panic != 0, int(v[8]) == 2
        print(
            f"t={sim_t:6.2f}s x=[{v[1]:6.2f},{v[2]:6.2f}] "
            f"z=[{v[3]:4.2f},{v[4]:4.2f}] "
            f"panics={int(v[5])}/{fleet} plans={int(v[6])} "
            f"landed={int(v[7])}/{fleet}"
        )
        return int(v[5]) != 0, int(v[7]) == fleet

    # Pipelined block loop: dispatch block b, read block b-READ_EVERY's
    # packed status — any device read drains the dispatch queue, so the
    # loop reads ONE small buffer every READ_EVERY blocks. Status,
    # panic-abort and landing-exit run up to READ_EVERY blocks (~4 s of
    # sim) late.
    READ_EVERY = 4
    t_wall = time.perf_counter()
    blocks = max(1, args.frames // frames_per_block)
    state, outs, vec = fly_block(state)
    jax.block_until_ready(vec)  # compile boundary
    t_compiled = time.perf_counter()
    prev_vec = vec
    ran = 1
    rc = 0
    for b in range(1, blocks):
        state, outs, vec = fly_block(state)
        ran += 1
        if b % READ_EVERY == 0:
            panicked, done = _status(prev_vec)
            if panicked:
                print("PANIC — aborting")
                rc = 1
                break
            if done:
                print("landed — mission complete")
                break
        prev_vec = vec
    jax.block_until_ready(state)
    t_end = time.perf_counter()
    wall = t_end - t_wall
    if _status(vec)[0]:
        rc = 1
    sim_time = int(np.asarray(state.base.step).reshape(-1)[0]) * 0.002
    msg = (f"flew {sim_time:.1f}s of sim time in {wall:.1f}s wall "
           f"({sim_time / wall:.2f}x realtime incl. compile)")
    if ran > 1:
        # first block carries the jit compile; the rest are steady state
        steady_wall = t_end - t_compiled
        steady_sim = frames_per_block * params.steps_per_frame * 0.002 * (ran - 1)
        msg += (f"; steady state {steady_sim / steady_wall:.2f}x realtime "
                f"({steady_wall / (ran - 1) / frames_per_block * 1e3:.1f} ms/frame)")
        if fleet > 1:
            msg += f"; aggregate {fleet * steady_sim / steady_wall:.1f}x realtime over {fleet} vehicles"
    print(msg)

    if args.csv and args.mesh and fleet > 1:
        print("--csv is not supported with --mesh (metrics-only outputs)")
        args.csv = None
    if args.csv:
        # re-fly a short segment recording outputs for the CSV
        from agrifly_tpu.utils import simlog

        _, outs, _ = fly_block(state)
        if fleet > 1:  # log vehicle 0 of the batch (fly_fleet stacks
            # outputs (frames, B, ...))
            outs = jax.tree_util.tree_map(lambda x: x[:, 0], outs)
        import types

        traj = types.SimpleNamespace(
            pos=outs["pos"], vel=outs["vel"], att=outs["att"],
            angvel=np.zeros_like(np.asarray(outs["vel"])),
            motor_speeds=np.zeros((np.asarray(outs["pos"]).shape[0], 4)),
            panic_reason=outs["panic"],
        )
        simlog.write_rollout_csv(args.csv, traj, dt=params.steps_per_frame * 0.002)
        print(f"wrote {args.csv}")
    if args.rgb:
        from agrifly_tpu.render import raycast as rc_mod

        s0 = (jax.tree_util.tree_map(lambda x: x[0], state) if fleet > 1
              else state)
        cam_att = rc_mod.camera_attitude(s0.base.plant.att)
        if params.mesh is not None:
            from agrifly_tpu.render import meshscene as ms_mod

            rgb = ms_mod.render_rgb(params.render_cfg, params.mesh,
                                    s0.base.plant.pos, cam_att)
        else:
            rgb = rc_mod.render_rgb(params.render_cfg, params.scene,
                                    s0.base.plant.pos, cam_att)
        rgb = np.asarray(rgb, np.uint8)
        with open(args.rgb, "wb") as f:
            f.write(f"P6\n{rgb.shape[1]} {rgb.shape[0]}\n255\n".encode())
            f.write(rgb.tobytes())
        print(f"wrote {args.rgb} ({rgb.shape[1]}x{rgb.shape[0]} PPM)")
    if args.ckpt:
        from agrifly_tpu.utils import checkpoint

        path = checkpoint.save(args.ckpt, state)
        print(f"checkpoint saved: {path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
