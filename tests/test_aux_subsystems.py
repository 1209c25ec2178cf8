"""Auxiliary subsystems: monitor, perf counters, checkpointing, aruco, CSV."""

import numpy as np
import jax
import jax.numpy as jnp

from agrifly_tpu.io import bridge, messages
from agrifly_tpu.sim import aruco, env
from agrifly_tpu.utils import checkpoint, monitor, perf, simlog


def test_monitor_health_bands():
    bus = bridge.TopicBus()
    mon = monitor.VehicleMonitor(bus, 1)
    # feed mocap at exactly 200 Hz (sim time stamps)
    for k in range(200):
        bus.publish("mocap_output1", messages.MocapOutput(header=messages.Header(stamp=k / 200.0)))
    st = mon.status(now=1.0)
    rate, ok = st["mocap"]
    assert ok and 195 <= rate <= 205
    # starved cmd channel is flagged
    _, cmd_ok = st["cmd"]
    assert not cmd_ok
    text = mon.render(now=1.0)
    assert "veh   1" in text


def test_monitor_panic_from_telemetry():
    bus = bridge.TopicBus()
    mon = monitor.VehicleMonitor(bus, 2)
    bus.publish("telemetry2", messages.Telemetry(header=messages.Header(stamp=0.0), panicReason=4))
    st = mon.status(now=0.5)
    name, ok = st["panic"]
    assert name == "RADIO_CMD_TIMEOUT" and not ok


def test_perf_counters():
    perf.reset_all()
    c = perf.alloc(perf.PC_COUNT, "events")
    c.bump(); c.bump(3)
    assert c.count == 4
    with perf.timed("block"):
        pass
    t = perf.alloc(perf.PC_ELAPSED, "block")
    assert t.count == 1 and t.total >= 0
    iv = perf.alloc(perf.PC_INTERVAL, "tick")
    iv.event(); iv.event()
    assert iv.count == 1
    perf.print_all()


def test_checkpoint_roundtrip(tmp_path):
    params = env.make_params(noise_scale=1.0)
    state = env.init_state(params, jax.random.PRNGKey(0))
    cmd = env.hover_command((0.0, 0.0, 1.0))
    rollout = jax.jit(env.rollout, static_argnums=3)
    mid, _ = rollout(params, state, cmd, 500)

    saved = checkpoint.save(tmp_path / "ckpt", mid)
    assert saved == tmp_path / "ckpt.npz" and saved.exists()
    restored = checkpoint.restore(tmp_path / "ckpt", mid)

    # continue both: identical trajectories (bit-exact resume)
    fin_a, _ = rollout(params, mid, cmd, 200)
    fin_b, _ = rollout(params, restored, cmd, 200)
    np.testing.assert_array_equal(np.asarray(fin_a.plant.pos), np.asarray(fin_b.plant.pos))
    np.testing.assert_array_equal(np.asarray(fin_a.logic.kf.cov), np.asarray(fin_b.logic.kf.cov))


def test_aruco_rate_limit():
    p = aruco.make_params(period=0.1)
    s = aruco.init_state()
    fires = 0
    for k in range(250):  # 0.5 s at 2 ms
        s = aruco.step(p, s, jnp.array([1.0, 2.0, 3.0]), jnp.array([1.0, 0, 0, 0]), jnp.int32(2000))
        fires += int(s.has_new)
    assert 4 <= fires <= 5
    assert np.allclose(np.asarray(s.meas_pos), [1, 2, 3])


def test_csv_rollout_log(tmp_path):
    params = env.make_params(noise_scale=0.0)
    state = env.init_state(params, jax.random.PRNGKey(0))
    cmd = env.hover_command((0.0, 0.0, 1.0))
    _, traj = jax.jit(env.rollout, static_argnums=3)(params, state, cmd, 100)
    path = tmp_path / "sim.csv"
    shape = simlog.write_rollout_csv(path, traj, des_pos=(0, 0, 1))
    lines = path.read_text().strip().splitlines()
    assert lines[0].startswith("t,posx,posy,posz")
    assert len(lines) == 101
    assert shape[1] == len(lines[0].split(","))


def test_joystick_monitor():
    """JoystickMonitor.cpp parity: 'No joystick!' until messages arrive,
    then the 95-105 Hz band judges the rate."""
    bus = bridge.TopicBus()
    jm = monitor.JoystickMonitor(bus)
    assert "No joystick" in jm.render(now=0.0)
    for k in range(100):
        bus.publish("joystick_values",
                    messages.JoystickValues(header=messages.Header(stamp=k / 100.0)))
    r, seen, ok = jm.status(now=1.0)
    assert seen and ok and 95 <= r <= 105
    assert "JS @" in jm.render(now=1.0)
    # starved again after the window passes
    assert "No joystick" in jm.render(now=5.0)
