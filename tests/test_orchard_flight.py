"""Config #3: full perception-plan-act orchard flight (demo parity)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from agrifly_tpu.models import logic as onboard
from agrifly_tpu.sim import orchard_env


@pytest.fixture(scope="module")
def flight():
    # small image + reduced candidate count keeps the CPU test tractable
    params = orchard_env.make_params(
        goal_world=(60.0, 0.0, 2.0),
        takeoff_height=2.0,
        start_flight_time=3.0,
        steps_per_frame=16,
        n_candidates=96,
        pyramid_capacity=16,
        planner_rounds=2,
        width=160, height=120,
        seed=0,
        noise_scale=1.0,
    )
    state = orchard_env.init_state(params, jax.random.PRNGKey(0))
    fly = jax.jit(lambda s: orchard_env.fly(params, s, 300))
    # ~10 s: 3 s takeoff + 7 s flight at 31.25 Hz frames
    final, outs = fly(state)
    return params, final, outs


def test_takeoff_then_flies_forward(flight):
    params, final, outs = flight
    pos = np.asarray(outs["pos"])
    # takeoff reached ~2 m before flight start
    pre_flight = pos[:90]  # first 3 s
    assert pre_flight[-1, 2] > 1.5
    # after planning starts the vehicle makes forward (x) progress
    assert pos[-1, 0] > 3.0, pos[-1]
    # never crashed into the ground while flying
    assert np.all(pos[90:, 2] > 0.2), pos[:, 2].min()


def test_no_panic_and_plans_found(flight):
    params, final, outs = flight
    assert int(final.base.logic.panic_reason) == onboard.PANIC_NO_PANIC
    assert int(final.plan_count) > 3
    found = np.asarray(outs["plan_found"])
    assert found.sum() > 3


def test_tracking_keeps_speed_bounded(flight):
    params, final, outs = flight
    vel = np.linalg.norm(np.asarray(outs["vel"]), axis=-1)
    # planner velocity limit is 5 m/s; tracking overshoot margin 1.5x
    assert vel.max() < 7.5, vel.max()


def test_does_not_hit_trees(flight):
    # distance from every flown position to the nearest tree trunk stays
    # above the physical radius (canopy contact is possible in principle
    # but trunks must be cleared)
    from agrifly_tpu.render import orchard as orch

    params, final, outs = flight
    pos = np.asarray(outs["pos"])
    scene = params.scene
    sx = float(scene.tree_spacing)
    sy = float(scene.row_spacing)
    bad = 0
    for p in pos[90:]:
        ix = int(np.floor(p[0] / sx))
        iy = int(np.floor(p[1] / sy))
        for dx_ in (-1, 0, 1):
            for dy_ in (-1, 0, 1):
                f = orch.tree_fields(scene, jnp.int32(ix + dx_), jnp.int32(iy + dy_))
                if not bool(f["present"]):
                    continue
                d = np.hypot(p[0] - float(f["cx"]), p[1] - float(f["cy"]))
                if d < float(f["trunk_r"]) and p[2] < float(f["trunk_h"]):
                    bad += 1
    assert bad == 0


@pytest.mark.slow
def test_waypoint_file_mission_lands(tmp_path):
    """trajectory.txt mission parity (agrifly.launch traj_file,
    ExampleVehicleStateMachine.cpp:450-465,702-730): fly a 3-waypoint file
    through the orchard with 1 m switching, then descend and idle."""
    from agrifly_tpu.sim import mission

    f = tmp_path / "traj.txt"
    f.write_text("# demo waypoints\n8.0,0.0,2.0\n12.0,0.0,2.0\n\n16.0,0.0,2.0\n")
    wps = mission.load_trajectory_file(str(f))
    assert wps == [(8.0, 0.0, 2.0), (12.0, 0.0, 2.0), (16.0, 0.0, 2.0)]

    params = orchard_env.make_params(
        waypoints=wps, land=True,
        takeoff_height=2.0, start_flight_time=3.0, steps_per_frame=16,
        n_candidates=64, pyramid_capacity=16, planner_rounds=2,
        width=160, height=120, seed=0, noise_scale=1.0,
    )
    state = orchard_env.init_state(params, jax.random.PRNGKey(0))
    fly = jax.jit(lambda s: orchard_env.fly(params, s, 155))
    # ~5 s blocks so the test can stop as soon as the mission completes
    for _ in range(5):  # up to ~25 s sim
        state, outs = fly(state)
        if int(state.mstage) == orchard_env.MSTAGE_COMPLETE:
            break
        assert int(state.base.logic.panic_reason) == onboard.PANIC_NO_PANIC

    assert int(state.waypoint_idx) == 2  # reached the last waypoint
    assert int(state.mstage) == orchard_env.MSTAGE_COMPLETE
    pos = np.asarray(state.base.plant.pos)
    assert pos[2] < 0.3, pos  # on the ground
    assert abs(pos[0] - 16.0) < 2.5, pos  # landed near the last waypoint
    assert int(state.base.logic.panic_reason) == onboard.PANIC_NO_PANIC
    # idle command shuts the motors off (FS_IDLE)
    assert int(state.base.logic.fs) == onboard.FS_IDLE
