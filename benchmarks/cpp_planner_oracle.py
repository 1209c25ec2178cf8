"""Head-to-head vs the REAL reference planner (compiled DepthImagePlanner).

`native/golden/planner_oracle` compiles the reference's
DepthImagePlanner.cpp + RapidTrajectoryGenerator.cpp UNMODIFIED and
evaluates an explicit candidate list through the exact anytime loop
(FindLowestCostTrajectory, DepthImagePlanner.cpp:91-212) plus an
exhaustive per-candidate pass and the reference's own ray-tracing ground
truth (IsCollisionFreeGroundTruth). This retires seq_oracle's geometry
blindness: seq_oracle reuses the framework's kernels (control-flow-only
check), while this harness compares against the true reference geometry.

Both planners see the IDENTICAL candidate list (px, py, depth, tf) and
the identical depth image rendered by the framework.

    python -m benchmarks.cpp_planner_oracle [--cpu] [--candidates N]
           [--image WxH] [--scenes K] [--budget]

--budget additionally runs BOTH planners at the reference node's replan
budget (ExampleVehicleStateMachine.cpp:183: 15 ms): the reference
free-runs its anytime loop for 15 ms of wall clock; the framework runs
floor(15 / fw_plan_ms) independent plans (--fw-plan-ms, required: the
per-plan latency measured on the device that is being compared, e.g. by
benchmarks/bench_plan.py) and keeps the best free candidate,
GT-checked through the compiled reference oracle. Reports chosen-cost
quality and GT soundness of both choices per scene.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
ORACLE = ROOT / "native" / "golden" / "build" / "planner_oracle"


def ensure_oracle():
    if not ORACLE.exists():
        subprocess.run([str(ROOT / "native" / "golden" / "build_planner.sh")],
                       check=True)
    return ORACLE


def run_oracle_inject(depth_u16, depth_scale, focal, vel0, acc0, grav,
                      goal_cam, radii, samples, workdir):
    """Run the reference planner on explicit candidates. Returns
    (per-candidate record array, summary dict)."""
    h, w = depth_u16.shape
    wd = pathlib.Path(workdir)
    np.asarray(depth_u16, "<u2").tofile(wd / "depth.bin")
    with open(wd / "state.txt", "w") as f:
        f.write(" ".join(f"{float(x):.17g}" for x in (
            *vel0, *acc0, *grav, *goal_cam, *radii)))
    px, py, depth, tf = samples
    with open(wd / "cands.csv", "w") as f:
        for row in zip(px, py, depth, tf):
            f.write(",".join(f"{float(x):.17g}" for x in row) + "\n")
    out = subprocess.run(
        [str(ensure_oracle()), "inject", str(wd / "depth.bin"), str(w),
         str(h), f"{depth_scale:.17g}", f"{focal:.17g}",
         str(wd / "state.txt"), str(wd / "cands.csv"), str(wd / "out.csv")],
        check=True, capture_output=True, text=True)
    toks = out.stdout.split()
    summary = dict(found=int(toks[1]), ncand=int(toks[3]),
                   best_cost=float(toks[5]),
                   best_end=[float(toks[7]), float(toks[8]), float(toks[9])],
                   best_tf=float(toks[11]), npyr=int(toks[13]))
    rec = np.genfromtxt(wd / "out.csv", delimiter=",", names=True)
    return rec, summary


def run_oracle_budget(depth_u16, depth_scale, focal, vel0, acc0, grav,
                      goal_cam, radii, seed, budget_s, workdir):
    h, w = depth_u16.shape
    wd = pathlib.Path(workdir)
    np.asarray(depth_u16, "<u2").tofile(wd / "depth.bin")
    with open(wd / "state.txt", "w") as f:
        f.write(" ".join(f"{float(x):.17g}" for x in (
            *vel0, *acc0, *grav, *goal_cam, *radii)))
    out = subprocess.run(
        [str(ensure_oracle()), "budget", str(wd / "depth.bin"), str(w),
         str(h), f"{depth_scale:.17g}", f"{focal:.17g}",
         str(wd / "state.txt"), str(seed), f"{budget_s:.17g}",
         str(wd / "out.csv")],
        check=True, capture_output=True, text=True)
    toks = out.stdout.split()
    return dict(found=int(toks[1]), ncand=int(toks[3]),
                best_cost=float(toks[5]), best_tf=float(toks[11]),
                npyr=int(toks[13]), gt_free_best=int(toks[15]))


def sample_explicit(key, n, w, h, min_depth=1.5, max_depth=3.0,
                    min_time=2.0, max_time=3.0):
    """The sampler distributions of both planners (central 80% of the
    image, U(1.5,3) m, U(2,3) s), drawn once and INJECTED into both."""
    import jax

    k1, k2, k3, k4 = jax.random.split(key, 4)
    px = np.asarray(jax.random.uniform(k1, (n,), np.float32, 0.1 * w, 0.9 * w))
    py = np.asarray(jax.random.uniform(k2, (n,), np.float32, 0.1 * h, 0.9 * h))
    depth = np.asarray(jax.random.uniform(k3, (n,), np.float32, min_depth, max_depth))
    tf = np.asarray(jax.random.uniform(k4, (n,), np.float32, min_time, max_time))
    return px, py, depth, tf


def compare_on_scene(params, depth_u16, key, vel0, acc0, grav, goal_cam,
                     n_candidates, pyramid_capacity, radii, workdir):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids

    cam = params.cam
    samples = sample_explicit(key, n_candidates, int(cam.width), int(cam.height))

    tr, cost, feas, vel_ok, gate, collision_free, pyrs = rappids.plan_debug(
        params, depth_u16, None, vel0, acc0, grav, goal_cam,
        pyramid_capacity=pyramid_capacity,
        samples=tuple(jnp.asarray(s) for s in samples))
    cost = np.asarray(cost, np.float64)
    gate = np.asarray(gate)
    feas = np.asarray(feas)
    vel_ok = np.asarray(vel_ok)
    free = np.asarray(collision_free)
    ok = gate & free
    fw_best = int(np.argmin(np.where(ok, cost, np.inf))) if ok.any() else -1
    fw_cost = float(cost[fw_best]) if fw_best >= 0 else np.nan

    rec, summary = run_oracle_inject(
        np.asarray(depth_u16, np.uint16), float(cam.depth_scale),
        float(cam.focal), np.asarray(vel0, np.float64),
        np.asarray(acc0, np.float64), np.asarray(grav, np.float64),
        np.asarray(goal_cam, np.float64), radii, samples, workdir)

    cpp_cost = rec["cost"]
    cpp_feas = rec["feas"] == 0  # InputFeasible == 0
    cpp_vel = rec["velok"] == 1
    cpp_free = rec["cf_exhaustive"] == 1
    cpp_gt = rec["gt_free"] == 1
    bits = rec["resultbits"].astype(int)

    # anytime-loop winner: last candidate with the CollisionFree bit
    cpp_best = int(np.nonzero(bits & 8)[0][-1]) if (bits & 8).any() else -1

    cost_rel = np.abs(cost - cpp_cost) / np.maximum(np.abs(cpp_cost), 1e-9)
    m = dict(
        n=int(n_candidates),
        cost_rel_max=float(cost_rel.max()),
        feas_mismatch=int((feas != cpp_feas).sum()),
        vel_mismatch=int((vel_ok != cpp_vel).sum()),
        # exhaustive collision labels, gated candidates only (the planner
        # never checks gated-out ones)
        label_agreement=float((free[gate] == cpp_free[gate]).mean())
        if gate.any() else 1.0,
        # soundness vs the REFERENCE's own ray-tracing ground truth:
        # candidates we call free that the C++ GT says collide
        fw_false_free=int((gate & free & ~cpp_gt).sum()),
        cpp_false_free=int((gate & cpp_free & ~cpp_gt).sum()),
        fw_n_free=int(ok.sum()),
        cpp_n_free=int((gate & cpp_free).sum()),
        winner_same=bool(fw_best == cpp_best),
        fw_best=fw_best, cpp_best=cpp_best,
        fw_best_cost=fw_cost,
        cpp_best_cost=float(summary["best_cost"]) if summary["found"] else np.nan,
        cpp_npyr=int(summary["npyr"]),
        fw_npyr=int(np.asarray(pyrs.valid).sum()),
    )
    return m


def run_fw_budget(params, depth_u16, base_key, vel0, acc0, grav, goal_cam,
                  n, k_plans, pyramid_capacity, radii, workdir,
                  downsample=2):
    """The framework at the SAME wall-clock budget as the reference node.

    The reference replans at a 15 ms budget (ExampleVehicleStateMachine
    .cpp:183). The framework spends the budget on k independent
    wide-batch plans (fresh keys, fresh candidate draws, fresh pyramid
    sets) and keeps the best free candidate overall: k = floor(15 ms /
    fw_plan_ms) plans of the budget config (n=4096, 96 pyramids,
    downsample 2, lazy 1) at this 320x240 scene shape. Candidate counts are NOT matched to the C++ (it free-runs
    its anytime loop); what is matched is wall-clock spend. The chosen
    trajectory is then verified against the reference's own ray-tracing
    ground truth via the compiled oracle."""
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids

    cam = params.cam
    best = dict(cost=np.inf, sample=None)
    total_free = 0
    for j in range(k_plans):
        key = jax.random.PRNGKey(int(base_key) * 10007 + j)
        samples = sample_explicit(key, n, int(cam.width), int(cam.height))
        tr, cost, feas, vel_ok, gate, free, pyrs = rappids.plan_debug(
            params, depth_u16, None, vel0, acc0, grav, goal_cam,
            pyramid_capacity=pyramid_capacity,
            inflation_downsample=downsample,
            samples=tuple(jnp.asarray(s) for s in samples))
        cost = np.asarray(cost, np.float64)
        ok = np.asarray(gate) & np.asarray(free)
        total_free += int(ok.sum())
        if ok.any():
            i = int(np.argmin(np.where(ok, cost, np.inf)))
            if cost[i] < best["cost"]:
                best = dict(cost=float(cost[i]),
                            sample=tuple(float(s[i]) for s in samples))
    out = dict(found=int(best["sample"] is not None),
               nplans=int(k_plans), ncand=int(k_plans * n),
               n_free_total=total_free,
               best_cost=best["cost"] if best["sample"] else float("nan"))
    if best["sample"] is not None:
        # GT-check the winner through the compiled reference oracle
        px, py, depth, tf = best["sample"]
        rec, _ = run_oracle_inject(
            np.asarray(depth_u16, np.uint16), float(cam.depth_scale),
            float(cam.focal), np.asarray(vel0, np.float64),
            np.asarray(acc0, np.float64), np.asarray(grav, np.float64),
            np.asarray(goal_cam, np.float64), radii,
            ([px], [py], [depth], [tf]), workdir)
        rec = np.atleast_1d(rec)
        out["gt_free_best"] = int(rec["gt_free"][0])
        out["cpp_cost_of_choice"] = float(rec["cost"][0])
    return out


def make_scenes(w, h, n_scenes):
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.ops import rotation as rot
    from agrifly_tpu.planner import rappids
    from agrifly_tpu.render import orchard, raycast

    cfg = raycast.make_config(w, h, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    cam = rappids.make_camera(w, h, focal=w / 2.0, depth_scale=10.0 / 256.0)
    att = raycast.camera_attitude(rot.identity())
    rng = np.random.default_rng(7)
    out = []
    for k in range(n_scenes):
        pos = jnp.asarray([2.0 + 3.5 * k, float(rng.uniform(-1.5, 1.5)),
                           float(rng.uniform(1.2, 3.2))], jnp.float32)
        depth = jax.block_until_ready(raycast.render_depth(cfg, scene, pos, att))
        out.append((cam, depth))
    return out


def main(argv):
    from benchmarks import _util

    argv = _util.setup(argv)
    n_cand = int(argv[argv.index("--candidates") + 1]) if "--candidates" in argv else 256
    img = argv[argv.index("--image") + 1] if "--image" in argv else "320x240"
    n_scenes = int(argv[argv.index("--scenes") + 1]) if "--scenes" in argv else 10
    # resume support: skip the first K scenes (scene generation is
    # deterministic, so slicing preserves per-scene identity)
    scene_start = int(argv[argv.index("--scene-start") + 1]) \
        if "--scene-start" in argv else 0
    do_budget = "--budget" in argv
    # measured per-plan latency of the budget-mode config (n=4096/cap
    # 96/ds2/lazy1 at 320x240) on the device being compared — sets how
    # many plans fit the 15 ms budget
    fw_plan_ms = (float(argv[argv.index("--fw-plan-ms") + 1])
                  if "--fw-plan-ms" in argv else None)
    if do_budget and fw_plan_ms is None:
        raise SystemExit("--budget needs --fw-plan-ms (the measured "
                         "per-plan latency of the budget config)")
    w, h = (int(x) for x in img.split("x"))

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids

    radii = (0.116, 0.174, 0.5)
    scenes = make_scenes(w, h, n_scenes)[scene_start:]
    vel0 = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    acc0 = jnp.zeros(3, jnp.float32)
    grav = jnp.array([0.0, 9.81, 0.0], jnp.float32)
    goal = jnp.array([0.0, 0.0, 50.0], jnp.float32)

    aggs = []
    with tempfile.TemporaryDirectory() as td:
        for k, (cam, depth) in enumerate(scenes, start=scene_start):
            params = rappids.make_params(cam, true_radius=radii[0],
                                         plan_radius=radii[1],
                                         min_check_dist=radii[2])
            m = compare_on_scene(params, depth, jax.random.PRNGKey(1000 + k),
                                 vel0, acc0, grav, goal, n_cand, 32, radii, td)
            if do_budget:
                b = run_oracle_budget(
                    np.asarray(depth, np.uint16), float(cam.depth_scale),
                    float(cam.focal), np.asarray(vel0, np.float64),
                    np.asarray(acc0, np.float64), np.asarray(grav, np.float64),
                    np.asarray(goal, np.float64), radii, 1000 + k, 0.015, td)
                m["cpp_budget15ms"] = b
                k_plans = max(1, int(15.0 / fw_plan_ms))
                m["fw_budget15ms"] = run_fw_budget(
                    params, depth, 1000 + k, vel0, acc0, grav, goal,
                    4096, k_plans, 96, radii, td)
            print(json.dumps({"scene": k, **m}))
            aggs.append(m)

    _util.report("cpp_oracle_label_agreement",
                 float(np.mean([a["label_agreement"] for a in aggs])), "frac")
    _util.report("cpp_oracle_fw_false_free",
                 int(np.sum([a["fw_false_free"] for a in aggs])), "count")
    if do_budget:
        fw = [a["fw_budget15ms"] for a in aggs]
        cpp = [a["cpp_budget15ms"] for a in aggs]
        print(json.dumps({
            "budget_ms": 15.0,
            "fw_found": int(np.sum([b["found"] for b in fw])),
            "cpp_found": int(np.sum([b["found"] for b in cpp])),
            "fw_gt_free": int(np.sum([b.get("gt_free_best", 0) for b in fw])),
            "cpp_gt_free": int(np.sum([b.get("gt_free_best", 0) for b in cpp])),
            "fw_mean_best_cost": float(np.mean(
                [b["best_cost"] for b in fw if b["found"]])),
            "cpp_mean_best_cost": float(np.mean(
                [b["best_cost"] for b in cpp if b["found"]])),
            "fw_ncand_mean": float(np.mean([b["ncand"] for b in fw])),
            "cpp_ncand_mean": float(np.mean([b["ncand"] for b in cpp])),
        }))
    print(json.dumps({
        "scenes": len(aggs),
        "feas_mismatch_total": int(np.sum([a["feas_mismatch"] for a in aggs])),
        "vel_mismatch_total": int(np.sum([a["vel_mismatch"] for a in aggs])),
        "winner_same": int(np.sum([a["winner_same"] for a in aggs])),
        "cost_rel_max": float(np.max([a["cost_rel_max"] for a in aggs])),
        "fw_false_free": int(np.sum([a["fw_false_free"] for a in aggs])),
        "cpp_false_free": int(np.sum([a["cpp_false_free"] for a in aggs])),
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
