"""Wall-clock real-time sim mode (io/bridge.SimBridge.run_realtime).

The reference ships a real-time ROS simulator — HardwareTimer wall clock
with ros::Rate(500) pacing (AIFS_ROS/hiperlab_rostools/src/Simulator/
main.cpp:231,310) — alongside the lockstep sync_simulator. These tests
validate the wall-clock mode at a reduced rate on CPU: achieved tick
rate within the (scaled) monitor bands, drift-free absolute deadlines,
topic cadences still exact in sim time, and teleop-style command
retargeting through the callable-cmd hook.
"""

import jax.numpy as jnp
import numpy as np

from agrifly_tpu.io import bridge as bridge_mod
from agrifly_tpu.sim import env as env_mod
from agrifly_tpu.utils import monitor as monitor_mod


def _mk_bridge():
    params = env_mod.make_params(noise_scale=0.0)
    return bridge_mod.SimBridge(params, vehicle_id=1, seed=0)


def test_run_realtime_rates_within_bands():
    """At a reduced 100 Hz wall rate (CPU-friendly), the achieved tick
    rate is within +-2.5% of target (the mocap band 195-205 is +-2.5% of
    nominal) and the wall-clock mocap/telemetry topic rates land inside
    the reference health bands scaled by rate/nominal.

    Wall-clock pacing is inherently load-sensitive: on an oversubscribed
    CI box the scheduler can't honor the deadlines at all (the reference
    real-time node has the same failure mode — vehicle_monitor flags it).
    If most quanta missed their deadline the box was overloaded, not the
    pacing logic: skip instead of flaking."""
    import pytest

    br = _mk_bridge()
    cmd = env_mod.hover_command()
    report = br.run_realtime(1.2, cmd, rate_hz=100.0, block=2)

    if report["late_quanta"] > 0.2 * report["n_quanta"]:
        pytest.skip(f"host overloaded: {report['late_quanta']}/"
                    f"{report['n_quanta']} quanta late")
    target = report["target_tick_hz"]
    assert abs(report["achieved_tick_hz"] - target) / target < 0.025, report
    # scaled reference bands: mocap 195-205 -> 39-41 Hz at 1/5 rate, etc.
    assert report["bands_ok"], report
    assert all(report["bands_ok"].values()), report
    assert report["rate_scale"] == 100.0 / 500.0
    # cmd band is skipped when no commander publishes radio_command
    assert "cmd" not in report["bands_ok"]


def test_run_realtime_sim_cadence_unchanged():
    """Pacing only stretches wall time: per sim second the bridge still
    publishes exactly the reference counts (truth 500, mocap ~200, ...)."""
    br = _mk_bridge()
    cmd = env_mod.hover_command()
    report = br.run_realtime(0.5, cmd, rate_hz=250.0, block=5)
    ticks = report["ticks"] + 10  # + compile warm ticks
    sim_s = ticks * float(br.params.dt_us) * 1e-6
    counts = br.bus.counts
    assert counts["simulator_truth1"] == ticks
    assert abs(counts["mocap_output1"] / sim_s - 200.0) < 5.0
    assert abs(counts["telemetry1"] / sim_s - 100.0) < 5.0


def test_orchard_run_realtime_full_loop_paced():
    """OrchardBridge.run_realtime paces the FULL perception-plan-act loop
    (render -> RAPPIDS plan -> track) against the wall clock — the
    reference can only run this pipeline lockstep (sync_simulator waits
    on AirSim images; the real-time node has no planner in the loop).
    Validated at a reduced 2 Hz frame rate on CPU with a tiny image:
    achieved frame rate within 2.5%, per-frame topics in band, and a
    mid-run radio kill reaches the onboard FSM through the packed-carry
    block path."""
    import pytest

    from agrifly_tpu.io import messages as msgs
    from agrifly_tpu.io import radio as radio_codec
    from agrifly_tpu.models import logic as onboard
    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params(width=32, height=24, n_candidates=8)
    ob = bridge_mod.OrchardBridge(params, vehicle_id=1, seed=0,
                                  publish_images=False)
    rows = []

    def on_quantum(b, k):
        rows.append(int(b.last_outs["step"][-1]))
        if k == 3:
            raw = radio_codec.fields_to_bytes(
                *radio_codec.make_kill_command())
            b.bus.publish("radio_command1", msgs.RadioCommand(raw=raw))

    report = ob.run_realtime(3.0, rate_hz=2.0, on_quantum=on_quantum)

    if report["late_quanta"] > 0.2 * report["n_quanta"]:
        pytest.skip(f"host overloaded: {report['late_quanta']}/"
                    f"{report['n_quanta']} quanta late")
    target = report["target_frame_hz"]
    assert target == 2.0
    assert abs(report["achieved_frame_hz"] - target) / target < 0.025, report
    assert report["bands_ok"] and all(report["bands_ok"].values()), report
    assert report["frames"] == report["n_quanta"]
    # sim time advanced exactly one frame per quantum (cadence unchanged)
    spf = int(params.steps_per_frame)
    assert [r - rows[0] for r in rows] == [spf * i for i in range(len(rows))]
    # the k=3 kill crossed the codec + 30 ms delay line inside the next
    # quantum's block and latched the onboard FSM
    assert int(ob.last_outs["flight_state"][-1]) == onboard.FS_KILLED
    # no images requested -> none published
    assert report["topic_hz"]["depth"] == 0.0


def test_run_blocked_matches_per_tick():
    """The device-block path (one lax.scan jit call per block, packed
    donated carrier, host-side row publishing) publishes message-for-
    message what the per-tick path publishes: same counts on every
    topic, same cadence placement, same telemetry packet numbers, and
    the same trajectory to float tolerance (scan-vs-standalone jit may
    fuse differently; published euler/telemetry decode is host-side)."""
    br_a = _mk_bridge()
    br_b = _mk_bridge()
    # spin the plant so angvel is visibly nonzero on simulator_truth —
    # a path that drops angvel (publishes zeros) must fail the compare
    for br in (br_a, br_b):
        st = br.state
        br.state = st._replace(plant=st.plant._replace(
            angvel=jnp.asarray([0.3, -0.2, 0.1], st.plant.angvel.dtype)))
    cmd = env_mod.hover_command()

    streams = {"a": [], "b": []}
    tel = {"a": [], "b": []}
    br_a.bus.subscribe("simulator_truth1",
                       lambda m: streams["a"].append((m.header.stamp,
                                                      m.posx, m.posy, m.posz,
                                                      m.angvelx, m.angvely,
                                                      m.angvelz)))
    br_b.bus.subscribe("simulator_truth1",
                       lambda m: streams["b"].append((m.header.stamp,
                                                      m.posx, m.posy, m.posz,
                                                      m.angvelx, m.angvely,
                                                      m.angvelz)))
    br_a.bus.subscribe("telemetry1", lambda m: tel["a"].append(m))
    br_b.bus.subscribe("telemetry1", lambda m: tel["b"].append(m))

    n = 40
    br_a.run(n, cmd)
    br_b.run_blocked(n, cmd, block=7)  # deliberately not a divisor of n

    assert dict(br_a.bus.counts) == dict(br_b.bus.counts)
    assert br_a.t_us == br_b.t_us == n * int(br_a.params.dt_us)
    sa = np.asarray(streams["a"], np.float64)
    sb = np.asarray(streams["b"], np.float64)
    assert sa.shape == sb.shape == (n, 7)
    np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-5)
    # angvel must be the real values, not zeros (it moves during takeoff
    # ticks well past the 1e-5 tolerance if one path dropped it)
    assert np.any(sa[:, 4:7] != 0.0)
    # telemetry fired on the same ticks with the same packet counters;
    # values agree to one wire-quantization step (codes can differ by
    # +-1 where the two programs' floats differ by an ulp)
    # period 10 ms, `> period` semantics: fires at ticks 6, 11, ..., 36
    assert len(tel["a"]) == len(tel["b"]) == 7
    for ma, mb in zip(tel["a"], tel["b"]):
        assert ma.header.stamp == mb.header.stamp
        assert ma.packetNumber == mb.packetNumber
        assert ma.panicReason == mb.panicReason
        np.testing.assert_allclose(ma.accelerometer, mb.accelerometer,
                                   atol=2e-3)
        np.testing.assert_allclose(ma.position, mb.position, atol=2e-3)
    # the blocked bridge's state stays consistent: a per-tick run resumes
    # from the carrier transparently (property materializes it)
    br_b.run(3, cmd)
    assert br_b.bus.counts["simulator_truth1"] == n + 3


def test_run_realtime_device_blocks_paced():
    """run_realtime(device_blocks=True) — the accelerator 500 Hz discipline —
    paces correctly at a reduced CPU rate: in-band wall rates, and a
    mid-run radio kill reaches the onboard FSM through the packed-domain
    injection within two quanta (pipeline depth)."""
    import pytest

    from agrifly_tpu.io import messages as msgs
    from agrifly_tpu.io import radio as radio_codec
    from agrifly_tpu.models import logic as onboard

    br = _mk_bridge()
    cmd = env_mod.hover_command()

    def on_quantum(b, k):
        if k == 20:
            raw = radio_codec.fields_to_bytes(
                *radio_codec.make_kill_command())
            b.bus.publish("radio_command1", msgs.RadioCommand(raw=raw))

    report = br.run_realtime(1.2, cmd, rate_hz=100.0, block=2,
                             on_quantum=on_quantum, device_blocks=True)

    if report["late_quanta"] > 0.2 * report["n_quanta"]:
        pytest.skip(f"host overloaded: {report['late_quanta']}/"
                    f"{report['n_quanta']} quanta late")
    target = report["target_tick_hz"]
    assert abs(report["achieved_tick_hz"] - target) / target < 0.025, report
    assert report["bands_ok"]["mocap"] and report["bands_ok"]["telemetry"]
    # a single kill is NOT a 50 Hz commander: the band check flags it,
    # exactly as the reference vehicle_monitor would
    assert report["bands_ok"].get("cmd") is False
    # the kill crossed the codec + packed-domain ring push + 30 ms wire
    assert int(br.state.logic.fs) == onboard.FS_KILLED


def test_run_realtime_monitor_and_teleop_hook():
    """A VehicleMonitor on wall time sees in-band (scaled) rates live,
    and a callable cmd retargets the setpoint mid-run (the teleop path);
    a kill published on radio_command1 mid-run reaches the onboard FSM
    through the real codec + delay line."""
    from agrifly_tpu.io import messages as msgs
    from agrifly_tpu.io import radio as radio_codec
    from agrifly_tpu.models import logic as onboard

    br = _mk_bridge()
    mon = monitor_mod.VehicleMonitor(br.bus, 1, use_sim_time=False)
    ctl = {"cmd": env_mod.hover_command(des_pos=(0.0, 0.0, 0.0))}
    seen = []

    def on_quantum(b, k):
        if k == 10:
            ctl["cmd"] = env_mod.hover_command(des_pos=(0.0, 0.0, 1.5))
        if k == 30:
            raw = radio_codec.fields_to_bytes(
                *radio_codec.make_kill_command())
            b.bus.publish("radio_command1", msgs.RadioCommand(raw=raw))
        if k == 55:
            st = mon.status()
            seen.append(st)

    report = br.run_realtime(
        1.2, lambda: ctl["cmd"], rate_hz=100.0, block=2,
        on_quantum=on_quantum)
    assert report["bands_ok"]["mocap"] and report["bands_ok"]["telemetry"], report
    # the monitor's sliding-window mocap rate was in the scaled band live
    assert seen, "monitor snapshot not taken"
    rate, _ok_unscaled = seen[0]["mocap"][0], seen[0]["mocap"][1]
    lo, hi = monitor_mod.BANDS["mocap"]
    scale = report["rate_scale"]
    assert lo * scale <= rate <= hi * scale, (rate, scale)
    # the mid-run kill reached the onboard state machine over the wire
    assert int(br.state.logic.fs) == onboard.FS_KILLED
    # a single kill is NOT a 50 Hz commander: the band check flags it,
    # exactly as the reference vehicle_monitor would
    assert report["bands_ok"].get("cmd") is False
