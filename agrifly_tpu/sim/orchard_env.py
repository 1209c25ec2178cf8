"""Config #3: depth-camera orchard flight — render + RAPPIDS + tracking.

The full perception-plan-act loop of the single-thread demo
(Simulator/Rappids_Simulator/main.cpp:330-760), fused on-device with no
process boundaries: where the reference blocks on Unity RPC pose-sync every
2 ms step and waits for 30 Hz images from another process, here one
`frame_step` renders a depth frame from the current pose (`render_frame`;
the Triton raycaster on a GPU), runs the batched RAPPIDS planner, then
scans `steps_per_frame` physics ticks
that track the planned trajectory through the same quantized radio channel
as the reference (200 Hz mocap estimator -> receding-horizon RunTracking ->
rates command -> 30 ms delay line -> onboard rates controller).

Time structure: frame-major. The reference plans at <= 30 Hz (image rate)
inside a 100 Hz offboard loop; here planning happens exactly once per
frame and tracking references are refreshed inside the tick loop at the
offboard cadence. steps_per_frame = 16 gives a 31.25 Hz frame rate vs the
reference's 30 Hz.

The mission profile matches the demo: climb to `takeoff_height` until
`start_flight_time`, then plan/track toward `goal_world`; if no plan
exists yet, hover at 2 m (main.cpp:565-569).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from agrifly_tpu.io import radio
from agrifly_tpu.offboard import controller as offboard_ctrl
from agrifly_tpu.offboard import estimators
from agrifly_tpu.ops import lin3
from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.planner import rappids, traj as traj_mod
from agrifly_tpu.render import orchard as orch
from agrifly_tpu.render import raycast
from agrifly_tpu.sim import delayline, env as env_mod

GRAV_W = jnp.array([0.0, 0.0, -9.81], jnp.float32)


class OrchardEnvParams(NamedTuple):
    base: env_mod.EnvParams
    scene: orch.OrchardParams
    render_cfg: raycast.RenderConfig
    planner: rappids.PlannerParams
    waypoints: jnp.ndarray  # (mission.MAX_WAYPOINTS, 3) world-frame goals
    num_waypoints: jnp.ndarray  # int32
    takeoff_height: jnp.ndarray
    start_flight_step: jnp.ndarray  # int32 sim step when planning begins
    steps_per_frame: int  # static
    n_candidates: int  # static
    pyramid_capacity: int  # static
    planner_rounds: int  # static
    inflation_downsample: int  # static: pooled pyramid inflation factor
    track_lookahead: jnp.ndarray  # 0.04 s (main.cpp:571)
    land: bool  # static: descend + settle after the last waypoint
    mesh: object = None  # Optional[meshscene.MeshScene]: explicit imported
    # world (Helios-export etc.); None = procedural hashed orchard


class PlannedTraj(NamedTuple):
    """The currently tracked camera-frame trajectory + world transform."""

    planned: jnp.ndarray  # bool
    alpha: jnp.ndarray  # (3,)
    beta: jnp.ndarray
    gamma: jnp.ndarray
    a0: jnp.ndarray
    v0: jnp.ndarray
    p0: jnp.ndarray
    tf: jnp.ndarray
    att: jnp.ndarray  # (4,) trajAtt = estAtt * camAtt
    offset: jnp.ndarray  # (3,) estPos at plan time
    start_step: jnp.ndarray  # int32 sim step of trajectory reset
    grav_cam: jnp.ndarray  # (3,) gravity at plan time (for thrust/omega)


def _null_planned() -> PlannedTraj:
    z3 = jnp.zeros(3, jnp.float32)
    return PlannedTraj(
        planned=jnp.bool_(False), alpha=z3, beta=z3, gamma=z3, a0=z3, v0=z3,
        p0=z3, tf=jnp.float32(1.0), att=rot.identity(), offset=z3,
        start_step=jnp.int32(0), grav_cam=z3,
    )


# mission sub-stages of the orchard profile (waypoint flight per
# ExampleVehicleStateMachine.cpp:702-730 switching; landing per :744-770)
MSTAGE_CRUISE = 0
MSTAGE_LANDING = 1
MSTAGE_COMPLETE = 2


class OrchardEnvState(NamedTuple):
    base: env_mod.EnvState
    planned: PlannedTraj
    plan_count: jnp.ndarray  # int32 successful plans
    frame_count: jnp.ndarray  # int32
    waypoint_idx: jnp.ndarray  # int32
    mstage: jnp.ndarray  # int32 MSTAGE_*
    land_pos: jnp.ndarray  # (3,) est position at landing entry
    land_start_step: jnp.ndarray  # int32


def make_params(
    goal_world=(120.0, 0.0, 3.5),
    takeoff_height=3.5,
    start_flight_time=5.0,
    steps_per_frame=16,
    n_candidates=256,
    pyramid_capacity=32,
    planner_rounds=2,
    inflation_downsample=2,
    width=640, height=480,
    seed=0,
    noise_scale=1.0,
    waypoints=None,
    land=False,
    mesh_scene=None,
) -> OrchardEnvParams:
    """waypoints: optional sequence of (x, y, z) goals flown in order with
    the reference's 1 m switching radius (trajectory.txt missions,
    ExampleVehicleStateMachine.cpp:450-465,702-730); defaults to the single
    `goal_world`. land=True descends at 0.5 m/s after the last waypoint and
    idles the motors on touchdown. mesh_scene: an explicit imported world
    (render/meshscene.py — Helios-export OBJ, primitive files, or a baked
    orchard) rendered instead of the procedural hashed orchard."""
    base = env_mod.make_params(noise_scale=noise_scale)
    scene = orch.make_params(seed=seed)
    cfg = raycast.make_config(width, height, far=10.0, dda_steps=8)
    cam = rappids.make_camera(width, height, focal=width / 2.0, depth_scale=10.0 / 256.0)
    # radii from arm length (ExampleVehicleStateMachine.cpp:441-443 /
    # Rappids demo main.cpp:167-169)
    from agrifly_tpu.models import constants as qconst

    v = qconst.vehicle_params(qconst.QC_TYPE_CF_MINIQUAD)
    planner = rappids.make_params(
        cam, true_radius=2 * v.arm_length, plan_radius=3 * v.arm_length,
        min_check_dist=0.5,
    )
    import numpy as np

    from agrifly_tpu.sim import mission as mission_mod

    if waypoints is None:
        waypoints = (tuple(goal_world),)
    wps = np.asarray(waypoints, np.float32)
    if len(wps) > mission_mod.MAX_WAYPOINTS:
        raise ValueError(f"{len(wps)} waypoints > {mission_mod.MAX_WAYPOINTS}")
    wp = np.zeros((mission_mod.MAX_WAYPOINTS, 3), np.float32)
    wp[: len(wps)] = wps

    return OrchardEnvParams(
        base=base, scene=scene, render_cfg=cfg, planner=planner,
        waypoints=jnp.asarray(wp),
        num_waypoints=jnp.int32(len(wps)),
        takeoff_height=jnp.float32(takeoff_height),
        start_flight_step=jnp.int32(round(start_flight_time * 500)),
        steps_per_frame=int(steps_per_frame),
        n_candidates=int(n_candidates),
        pyramid_capacity=int(pyramid_capacity),
        planner_rounds=int(planner_rounds),
        inflation_downsample=int(inflation_downsample),
        track_lookahead=jnp.float32(0.04),
        land=bool(land),
        mesh=mesh_scene,
    )


def init_state(params: OrchardEnvParams, key, pos=(0.0, 0.0, 0.0)) -> OrchardEnvState:
    return OrchardEnvState(
        base=env_mod.init_state(params.base, key, pos=pos),
        planned=_null_planned(),
        plan_count=jnp.int32(0),
        frame_count=jnp.int32(0),
        waypoint_idx=jnp.int32(0),
        mstage=jnp.int32(MSTAGE_CRUISE),
        land_pos=jnp.zeros(3, jnp.float32),
        land_start_step=jnp.int32(0),
    )


def _planned_as_traj(p: PlannedTraj) -> traj_mod.Traj:
    return traj_mod.Traj(
        alpha=p.alpha, beta=p.beta, gamma=p.gamma, a0=p.a0, v0=p.v0, p0=p.p0,
        tf=p.tf, cost=jnp.float32(0.0),
    )


def _tracking_refs(params: OrchardEnvParams, pl: PlannedTraj, step):
    """Receding-horizon reference state at sim step (main.cpp:560-605)."""
    tr = _planned_as_traj(pl)
    t = (step - pl.start_step).astype(jnp.float32) * (
        params.base.dt_us.astype(jnp.float32) * 1e-6
    )
    running = t < pl.tf
    t_la = jnp.minimum(t + params.track_lookahead, pl.tf)
    t_eval = jnp.where(running, t_la, pl.tf)

    pos_c = traj_mod.position(tr, t_eval)
    vel_c = jnp.where(running, traj_mod.velocity(tr, t_eval), jnp.zeros(3, jnp.float32))
    acc_c = jnp.where(running, traj_mod.acceleration(tr, t_eval), jnp.zeros(3, jnp.float32))

    # disallow going backwards through the camera plane (main.cpp:578-597)
    ez = jnp.arange(3) == 2
    z_neg = pos_c[2] < 0
    pos_c = jnp.where(ez & z_neg, 0.0, pos_c)
    vel_c = jnp.where(ez & (z_neg & (vel_c[2] < 0)), 0.0, vel_c)
    acc_c = jnp.where(ez & (z_neg & (acc_c[2] < 0)), 0.0, acc_c)

    R = rot.to_matrix(pl.att)
    # lin3.mv3 broadcast-sums, not `@` (tiny dots may run in reduced
    # precision on matrix units)
    ref_pos = lin3.mv3(R, pos_c) + pl.offset
    ref_vel = lin3.mv3(R, vel_c)
    ref_acc = lin3.mv3(R, acc_c)
    t_thr = jnp.clip(t, 0.0, pl.tf)
    ref_thrust = traj_mod.thrust(tr, t_thr, pl.grav_cam)
    omega_cam = traj_mod.omega(tr, jnp.minimum(t_thr, pl.tf - 0.02), 0.02, pl.grav_cam)
    ref_angvel_world = lin3.mv3(R, omega_cam)
    return ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_world


def _sim_tick(params: OrchardEnvParams, s: OrchardEnvState,
              noise=None) -> OrchardEnvState:
    """One 2 ms tick with tracking/takeoff offboard control.

    noise: optional (2, 3) pre-drawn unit normals (gyro, acc) for this
    tick's IMU — see frame_step, which draws the whole frame at once."""
    base = s.base
    p = params.base
    z3 = jnp.zeros(3, jnp.float32)

    half = env_mod.physics_tick(
        base, p, z3, z3, use_estimator=True,
        noise=None if noise is None else (noise[0], noise[1]))
    est_pos, est_vel, est_att, est_angvel = half["est"]

    # offboard loop cadence
    acc_us = base.offboard_acc_us + p.dt_us
    fire = acc_us > p.offboard_period_us
    acc_us = jnp.where(fire, acc_us - p.offboard_period_us, acc_us)

    in_flight = base.step >= params.start_flight_step

    # takeoff / no-plan hover target
    hover_pos = jnp.where(
        in_flight,
        jnp.array([0.0, 0.0, 2.0], jnp.float32),
        jnp.stack([jnp.float32(0.0), jnp.float32(0.0), params.takeoff_height]),
    )

    # landing descent target (mission.py semantics: 0.5 m/s with a blend-in)
    from agrifly_tpu.sim import mission as mission_mod

    landing = s.mstage == MSTAGE_LANDING
    t_land = jnp.maximum(base.step - s.land_start_step, 0).astype(jnp.float32) * (
        p.dt_us.astype(jnp.float32) * 1e-6
    )
    frac_ld = jnp.clip(t_land / mission_mod.LANDING_BLEND_TIME, 0.0, 1.0)
    descend = jnp.array([0.0, 0.0, -mission_mod.LANDING_SPEED], jnp.float32)
    pos_land = s.land_pos + frac_ld * t_land * descend
    vel_land = frac_ld * descend
    settled = s.mstage == MSTAGE_COMPLETE
    not_cruise = landing | settled
    hover_pos = jnp.where(not_cruise, pos_land, hover_pos)
    hover_vel = jnp.where(not_cruise, vel_land, jnp.zeros(3, jnp.float32))
    angvel_hover, thrust_hover = offboard_ctrl.run(
        p.ctrl, est_pos, est_vel, est_att, hover_pos, hover_vel,
    )

    # touchdown -> complete (motors idled below)
    mstage = jnp.where(landing & (pos_land[2] < 0.0),
                       jnp.int32(MSTAGE_COMPLETE), s.mstage)

    # tracking control
    ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_w = _tracking_refs(
        params, s.planned, base.step
    )
    ref_angvel_body = rot.rotate_back(est_att, ref_angvel_w)
    angvel_track, thrust_track, _ = offboard_ctrl.run_tracking(
        p.ctrl, est_pos, est_vel, est_att, ref_pos, ref_vel, ref_acc,
        jnp.float32(0.0), ref_thrust, ref_angvel_body,
    )

    track = in_flight & s.planned.planned & (mstage == MSTAGE_CRUISE)
    cmd_angvel = jnp.where(track, angvel_track, angvel_hover)
    cmd_thrust = jnp.where(track, thrust_track, thrust_hover)

    rtype, rflags, rfields = radio.make_rates_command(cmd_thrust, cmd_angvel)
    itype, iflags, ifields = radio.make_idle_command()
    idle = mstage == MSTAGE_COMPLETE
    rtype = jnp.where(idle, itype, rtype)
    rflags = jnp.where(idle, iflags, rflags)
    rfields = jnp.where(idle, ifields, rfields)
    ring = delayline.push(half["ring"], rtype, rflags, rfields, base.step, fire)

    # latency-compensation feedback into the estimator pipe
    pred_acc = rot.rotate(est_att, jnp.array([0.0, 0.0, 1.0], jnp.float32)) * cmd_thrust + GRAV_W
    mocap = estimators.mocap_set_predicted_values(
        half["mocap"], half["now_us"], p.est_latency_us, cmd_angvel, pred_acc, fire
    )

    new_base = env_mod.EnvState(
        plant=half["plant"], logic=half["logic"], ring=ring,
        offboard_acc_us=acc_us, step=base.step + 1, key=half["key"],
        last_cmd_thrust=jnp.where(fire, cmd_thrust, base.last_cmd_thrust),
        last_cmd_angvel=jnp.where(fire, cmd_angvel, base.last_cmd_angvel),
        mocap=mocap, mocap_acc_us=half["mocap_acc_us"],
        gpsimu=half["gpsimu"], gps_acc_us=half["gps_acc_us"], uwb=half["uwb"],
    )
    return s._replace(base=new_base, mstage=mstage)


def frame_ticks(params: OrchardEnvParams, s: OrchardEnvState, noise):
    """The 16-tick physics/tracking loop of one frame, scanned."""

    def body(carry, n):
        return _sim_tick(params, carry, n), None

    s, _ = jax.lax.scan(body, s, noise)
    return s


def render_frame(params: OrchardEnvParams, cam_pos, cam_att):
    """The depth frame the planner sees from one camera pose: the imported
    world (meshscene) when params.mesh is set, else the procedural orchard
    through the single batch render entry."""
    if params.mesh is not None:
        from agrifly_tpu.render import meshscene

        return meshscene.render_depth(params.render_cfg, params.mesh,
                                      cam_pos, cam_att)
    return raycast.render_depth_batch(params.render_cfg, params.scene,
                                      cam_pos[None], cam_att[None])[0]


def _frame_percept(params: OrchardEnvParams, s: OrchardEnvState):
    """Render -> plan -> mission bookkeeping (everything before the tick
    block). Returns (state, noise_key, plan_info); pure code motion out of
    frame_step so the fleet path can batch the tick block separately."""
    base = s.base
    p = params.base

    # current estimator view (what the planner gets, main.cpp:469,489-495)
    now_us = base.step * p.dt_us
    est_pos, est_vel, est_att, est_angvel = estimators.mocap_get_prediction(
        base.mocap, now_us, p.est_latency_us
    )
    est_att_n = rot.qnormalize(est_att)

    # 1. render a depth frame from the *true* pose (the renderer plays
    # Unity's role; the reference pushes the true kinematics to Unity)
    cam_att = raycast.camera_attitude(base.plant.att)
    depth = render_frame(params, base.plant.pos, cam_att)

    # 2. plan in the camera frame (main.cpp:484-508)
    cam_att_est = rot.qmul(est_att_n, rot.from_euler_ypr(*raycast.DEPTH_CAM_YPR))
    R_wc = rot.to_matrix(cam_att_est)  # world-from-camera
    # broadcast-sum transposed matvecs (full f32: tiny dots may run in
    # reduced precision on matrix units)
    vel_cam = lin3.mv3t(R_wc, est_vel)
    acc_cam = lin3.mv3t(R_wc, (
        rot.rotate(est_att_n, jnp.array([0.0, 0.0, 1.0], jnp.float32))
        * base.last_cmd_thrust + GRAV_W
    ))
    grav_cam = lin3.mv3t(R_wc, GRAV_W)

    # waypoint switching at the reference's 1 m radius
    # (ExampleVehicleStateMachine.cpp:702-730); after the last waypoint,
    # optionally enter the landing descent
    from agrifly_tpu.sim import mission as mission_mod

    in_flight_wp = base.step >= params.start_flight_step
    wp_iota = jnp.arange(params.waypoints.shape[0])
    goal_world = (params.waypoints * (wp_iota == s.waypoint_idx)[:, None]).sum(0)
    at_wp = (
        in_flight_wp & (s.mstage == MSTAGE_CRUISE)
        & (jnp.linalg.norm(goal_world - est_pos) < mission_mod.WAYPOINT_RADIUS)
    )
    has_next = s.waypoint_idx + 1 < params.num_waypoints
    waypoint_idx = jnp.where(at_wp & has_next, s.waypoint_idx + 1, s.waypoint_idx)
    mstage = s.mstage
    land_pos = s.land_pos
    land_start_step = s.land_start_step
    if params.land:
        enter_land = at_wp & ~has_next
        mstage = jnp.where(enter_land, jnp.int32(MSTAGE_LANDING), mstage)
        land_pos = jnp.where(enter_land, est_pos, land_pos)
        land_start_step = jnp.where(enter_land, base.step, land_start_step)
    goal_world = (params.waypoints * (wp_iota == waypoint_idx)[:, None]).sum(0)
    goal_cam = lin3.mv3t(R_wc, goal_world - est_pos)

    key, sub, k_noise = jax.random.split(base.key, 3)
    res = rappids.plan(
        params.planner, depth, sub, vel_cam, acc_cam, grav_cam, goal_cam,
        n_candidates=params.n_candidates,
        pyramid_capacity=params.pyramid_capacity,
        rounds=params.planner_rounds,
        inflation_downsample=params.inflation_downsample,
    )

    in_flight = base.step >= params.start_flight_step
    adopt = res.found & in_flight & (mstage == MSTAGE_CRUISE)
    new_planned = PlannedTraj(
        planned=jnp.where(adopt, jnp.bool_(True), s.planned.planned),
        alpha=jnp.where(adopt, res.traj.alpha, s.planned.alpha),
        beta=jnp.where(adopt, res.traj.beta, s.planned.beta),
        gamma=jnp.where(adopt, res.traj.gamma, s.planned.gamma),
        a0=jnp.where(adopt, res.traj.a0, s.planned.a0),
        v0=jnp.where(adopt, res.traj.v0, s.planned.v0),
        p0=jnp.where(adopt, res.traj.p0, s.planned.p0),
        tf=jnp.where(adopt, res.traj.tf, s.planned.tf),
        att=jnp.where(adopt, cam_att_est, s.planned.att),
        offset=jnp.where(adopt, est_pos, s.planned.offset),
        start_step=jnp.where(adopt, base.step, s.planned.start_step),
        grav_cam=jnp.where(adopt, grav_cam, s.planned.grav_cam),
    )

    s = s._replace(
        base=base._replace(key=key),
        planned=new_planned,
        plan_count=s.plan_count + adopt.astype(jnp.int32),
        frame_count=s.frame_count + 1,
        waypoint_idx=waypoint_idx,
        mstage=mstage,
        land_pos=land_pos,
        land_start_step=land_start_step,
    )

    plan_info = dict(
        plan_found=res.found, num_collision_free=res.num_collision_free,
        num_pyramids=res.num_pyramids, best_cost=res.best_cost,
        num_feasible=res.num_feasible,
        num_velocity_admissible=res.num_velocity_admissible,
        plan_vel_cam=vel_cam, plan_acc_cam=acc_cam, plan_grav_cam=grav_cam,
        goal_world=goal_world,
    )
    return s, k_noise, plan_info


def _frame_outputs(s: OrchardEnvState, plan_info: dict) -> dict:
    return dict(
        pos=s.base.plant.pos, vel=s.base.plant.vel, att=s.base.plant.att,
        flight_state=s.base.logic.fs, panic=s.base.logic.panic_reason,
        **plan_info,
    )


def frame_step(params: OrchardEnvParams, s: OrchardEnvState):
    """One 33 ms frame: render -> plan -> 16 tracked physics ticks.

    Returns (state, FrameOutputs-dict).
    """
    s, k_noise, plan_info = _frame_percept(params, s)

    # physics ticks — IMU noise for the whole frame drawn in one batched
    # call (16 sequential threefry chains cost ~30 fused kernels; one
    # (16,2,3) draw costs ~3), then the tick loop
    noise = jax.random.normal(
        k_noise, (params.steps_per_frame, 2, 3), jnp.float32)
    s = frame_ticks(params, s, noise)
    return s, _frame_outputs(s, plan_info)


def frame_step_fleet(params: OrchardEnvParams, s: OrchardEnvState):
    """One frame for a B-vehicle fleet (leading batch axis on every leaf):
    jax.vmap(frame_step); the batched render is one kernel call."""
    return jax.vmap(lambda st: frame_step(params, st))(s)


def fly_fleet(params: OrchardEnvParams, s: OrchardEnvState, n_frames: int):
    """Scan frame_step_fleet over a batched state (see fly's NB on params)."""

    def body(carry, _):
        return frame_step_fleet(params, carry)

    return jax.lax.scan(body, s, None, length=n_frames)


def _diag_extras(params: OrchardEnvParams, s: OrchardEnvState) -> dict:
    """Per-frame extras for the topic bridge: everything OrchardBridge
    publishes that isn't already in _frame_outputs — the planned-traj
    subtree, the controller-diagnostics snapshot (mocap prediction +
    tracking refs, ExampleVehicleStateMachine.cpp:666-696), and the last
    wire command. Same device math the bridge's per-frame path ran."""
    from agrifly_tpu.offboard import estimators
    from agrifly_tpu.ops import filters

    p = params.base
    now_us = s.base.step * p.dt_us
    est_pos, est_vel, est_att, _ = estimators.mocap_get_prediction(
        s.base.mocap, now_us, p.est_latency_us)
    ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_w = _tracking_refs(
        params, s.planned, s.base.step)
    lg = s.base.logic
    return dict(
        step=s.base.step, planned=s.planned, plan_count=s.plan_count,
        mstage=s.mstage, waypoint_idx=s.waypoint_idx,
        # telemetry-packet sources (io/telemetry.encode_from_logic reads
        # the same LogicState fields) — lets the topic bridge publish the
        # 100 Hz telemetry wire from host rows without touching the state
        tel_acc=filters.lp2_value(lg.acc_lp),
        tel_gyro=filters.lp2_value(lg.gyro_lp),
        tel_motor_forces=lg.des_motor_forces,
        tel_kf_pos=lg.kf.pos, tel_kf_vel=lg.kf.vel, tel_kf_att=lg.kf.att,
        tel_batt=lg.batt_voltage, tel_debug=lg.debug,
        tel_warnings=lg.warnings,
        est_pos=est_pos, est_vel=est_vel, est_att=est_att,
        ref_pos=ref_pos, ref_vel=ref_vel, ref_acc=ref_acc,
        ref_thrust=ref_thrust,
        ref_angvel_b=rot.rotate_back(est_att, ref_angvel_w),
        last_cmd_thrust=s.base.last_cmd_thrust,
        last_cmd_angvel=s.base.last_cmd_angvel,
    )


def fly_diag(params: OrchardEnvParams, s: OrchardEnvState, n_frames: int):
    """fly() with bridge-grade outputs: each frame's stacked outs carry
    the full topic surface (truth + planner diagnostics inputs + the
    controller snapshot + the planned-traj subtree), so the topic bridge
    can fly a whole block in ONE jit call and publish every frame from
    the stacked rows (io/bridge.OrchardBridge.fly_frames_block)."""

    def body(carry, _):
        s2, outs = frame_step(params, carry)
        return s2, dict(outs, **_diag_extras(params, s2))

    return jax.lax.scan(body, s, None, length=n_frames)


def fly(params: OrchardEnvParams, s: OrchardEnvState, n_frames: int):
    """Scan frame_step. Returns (state, stacked frame outputs).

    NB: OrchardEnvParams mixes arrays with static python config
    (steps_per_frame, n_candidates, ...). Close over `params` when jitting:
        step = jax.jit(lambda s: fly(params, s, n))
    rather than passing params as a traced argument.
    """

    def body(carry, _):
        return frame_step(params, carry)

    return jax.lax.scan(body, s, None, length=n_frames)
