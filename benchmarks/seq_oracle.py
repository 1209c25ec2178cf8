"""Reference-semantics SEQUENTIAL planner oracle + plan-quality benchmark.

`rappids.plan` is a batch redesign of the reference's anytime loop
(DepthImagePlanner.cpp:91-212): where the reference walks candidates one
by one — cost-gated against the best-so-far, lazily inflating a pyramid
at the uncovered deepest point whenever the partition misses
(cpp:270-273) — the batched planner gates/checks all candidates at once with
pre-planned + lazy pyramid rounds. This module ports the reference's
control flow verbatim (slow sequential python; geometry reused from the
same rappids building blocks, so any disagreement is *control flow*, not
geometry) and quantifies the gap:

    python -m benchmarks.seq_oracle [--cpu] [--candidates 256] ...

prints one JSON line per scene with the candidate-label agreement on the
sequentially-checked subset and the chosen-trajectory cost delta, plus a
summary line. Also used by tests/test_rappids.py as a quality pin.
"""

from __future__ import annotations

import sys

import numpy as np


def sequential_plan(params, depth_u16, key, vel0, acc0, grav, goal_cam,
                    n_candidates=256, pyramid_capacity=32,
                    inflation_downsample=1):
    """The reference's anytime loop at fixed seeds.

    Same candidate set as rappids.plan(key=...) (identical sampler +
    key). Walks candidates in generation order; a candidate is examined
    only if its cost beats the best collision-free found so far
    (cpp:183-188); collision checks run against the pyramids inflated so
    far, and an uncovered deepest point triggers on-demand inflation
    there until the pyramid budget is spent (cpp:270-273).

    Returns dict(labels (N,) int: +1 free, -1 collision, 0 skipped/gated;
    best_idx, best_cost, n_pyramids, n_checked).
    """
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids, traj as traj_mod

    tr = rappids.sample_candidates(params, key, n_candidates, vel0, acc0, grav)
    cost = np.asarray(rappids.exploration_cost(
        tr, jnp.asarray(goal_cam, jnp.float32)))
    feas = np.asarray(traj_mod.check_input_feasibility(
        tr, grav, params.fmin, params.fmax, params.wmax,
        float(params.min_section_time), static_max_tf=3.0))
    vel_ok = np.asarray(traj_mod.check_velocity_feasibility(tr, params.vmax))

    check = jax.jit(lambda pyrs, t: rappids.collision_check(params, pyrs, t))
    inflate_one = jax.jit(lambda px, py, z: rappids.build_pyramid_set(
        params, depth_u16, jnp.asarray([px], jnp.float32),
        jnp.asarray([py], jnp.float32), jnp.asarray([z], jnp.float32),
        jnp.asarray([True]), 1, downsample=inflation_downsample))

    pyrs = rappids.empty_pyramid_set(pyramid_capacity)
    n_pyrs = 0
    labels = np.zeros(n_candidates, np.int32)
    best_cost = np.inf
    best_idx = -1
    n_checked = 0
    img_i = np.asarray(depth_u16, np.int64)
    ignore_i = int(float(params.true_radius) / float(params.cam.depth_scale))
    scale = float(params.cam.depth_scale)
    plan_r = float(params.plan_radius)

    for i in range(n_candidates):
        if cost[i] >= best_cost:  # anytime cost gate (cpp:183-188)
            continue
        if not (feas[i] and vel_ok[i]):
            continue
        n_checked += 1
        tr_i = jax.tree_util.tree_map(lambda x: x[i], tr)
        while True:
            free, fpx, fpy, fz = check(pyrs, tr_i)
            if bool(free):
                labels[i] = 1
                best_cost = float(cost[i])
                best_idx = i
                break
            if n_pyrs >= pyramid_capacity or float(fz) <= 0:
                labels[i] = -1
                break
            # on-demand inflation at the uncovered deepest point; a seed
            # whose own pixel is blocked shallower than the required
            # pyramid depth can never inflate -> genuine collision
            pxi = min(max(int(float(fpx)), 0), params.cam.width - 1)
            pyi = min(max(int(float(fpy)), 0), params.cam.height - 1)
            seed_code = img_i[pyi, pxi]
            minpyr_i = int((float(fz) + scale + plan_r) / scale)
            if not (seed_code <= ignore_i or seed_code >= minpyr_i):
                labels[i] = -1
                break
            new_p = inflate_one(float(fpx), float(fpy), float(fz) + scale)
            if not bool(np.asarray(new_p.valid).any()):
                labels[i] = -1
                break
            pyrs = rappids.merge_pyramid_sets(pyrs, new_p)
            n_pyrs += 1

    return dict(labels=labels, best_idx=best_idx, best_cost=best_cost,
                n_pyramids=n_pyrs, n_checked=n_checked, pyramid_set=pyrs)


def compare_on_scene(params, depth, key, vel0, acc0, grav, goal,
                     n_candidates, pyramid_capacity, lazy_rounds=1):
    """Run both planners on identical inputs; return agreement metrics."""
    import jax
    import numpy as np

    from agrifly_tpu.planner import rappids

    res = rappids.plan(params, depth, key, vel0, acc0, grav, goal,
                       n_candidates=n_candidates,
                       pyramid_capacity=pyramid_capacity,
                       rounds=2, lazy_rounds=lazy_rounds)
    seq = sequential_plan(params, depth, key, vel0, acc0, grav, goal,
                          n_candidates=n_candidates,
                          pyramid_capacity=pyramid_capacity)

    # batch labels for every candidate (re-derive from _plan_core pieces)
    tr, cost, feas, vel_ok, gate, cfree, _ = rappids._plan_core(
        params, depth, key, vel0, acc0, grav, goal, n_candidates,
        pyramid_capacity, 2, 1, None, lazy_rounds)
    cost = np.asarray(cost)
    batch_free = np.asarray(gate & cfree)

    checked = seq["labels"] != 0  # the subset the reference loop labeled
    agree = (batch_free[checked] == (seq["labels"][checked] == 1)).mean() \
        if checked.any() else 1.0
    cost_delta = (seq["best_cost"] - float(res.best_cost)
                  if seq["best_idx"] >= 0 and bool(res.found) else np.nan)

    # ---- classify every disagreeing label (round-3 verdict weak #5) ----
    # batch_conservative: batch says collision, sequential says free.
    #   * coverage: the candidate IS free against the sequential loop's
    #     own pyramid set — the batch partition merely inflated pyramids
    #     at different points (pyramid-budget placement, the expected
    #     benign class from the lazy semantics of cpp:270-273).
    #   * geometry: in-collision even against the sequential pyramids —
    #     would indicate a real checker divergence (expected 0).
    #   gt_free counts how many of these the ray-sphere oracle calls
    #   free, i.e. how many are safety-harmless conservatism.
    # batch_optimistic: batch says free, sequential says collision.
    #   * gt_free=True: the BATCH planner is right and the reference's
    #     budget-limited lazy loop was the conservative one.
    #   * gt_free=False: a batch false-free (must be 0: the planner is
    #     pinned conservative vs the oracle by test_rappids).
    from agrifly_tpu.planner import oracle as oracle_mod

    gt_free_fn = jax.jit(
        lambda t: oracle_mod.is_collision_free_ground_truth(params, depth, t))
    check_fn = jax.jit(
        lambda pyrs, t: rappids.collision_check(params, pyrs, t)[0])
    seq_pyrs = seq["pyramid_set"]
    cls = dict(batch_conservative_coverage=0,
               batch_conservative_geometry=0,
               batch_conservative_gt_free=0,
               batch_optimistic_gt_free=0,
               batch_optimistic_false_free=0)
    for i in np.nonzero(checked)[0]:
        seq_free = seq["labels"][i] == 1
        if bool(batch_free[i]) == bool(seq_free):
            continue
        tr_i = jax.tree_util.tree_map(lambda x: x[i], tr)
        gt_free = bool(gt_free_fn(tr_i))
        if seq_free:  # batch conservative
            if bool(check_fn(seq_pyrs, tr_i)):
                cls["batch_conservative_coverage"] += 1
            else:
                cls["batch_conservative_geometry"] += 1
            cls["batch_conservative_gt_free"] += int(gt_free)
        else:  # batch optimistic
            if gt_free:
                cls["batch_optimistic_gt_free"] += 1
            else:
                cls["batch_optimistic_false_free"] += 1

    return dict(
        n_checked=int(seq["n_checked"]),
        label_agreement=float(agree),
        n_disagree=int(sum(cls[k] for k in
                           ("batch_conservative_coverage",
                            "batch_conservative_geometry",
                            "batch_optimistic_gt_free",
                            "batch_optimistic_false_free"))),
        **cls,
        seq_best_cost=float(seq["best_cost"]),
        batch_best_cost=float(res.best_cost),
        # negative = the sequential (reference) loop found a cheaper
        # trajectory; positive = the batch planner did
        chosen_cost_delta=float(cost_delta),
        seq_pyramids=int(seq["n_pyramids"]),
        batch_pyramids=int(res.num_pyramids),
        both_found=bool(res.found) and seq["best_idx"] >= 0,
    )


def main(argv):
    import json

    from benchmarks import _util

    argv = _util.setup(argv)
    n_cand = int(argv[argv.index("--candidates") + 1]) if "--candidates" in argv else 256
    n_pyr = int(argv[argv.index("--pyramids") + 1]) if "--pyramids" in argv else 32
    img = argv[argv.index("--image") + 1] if "--image" in argv else "320x240"
    w, h = (int(x) for x in img.split("x"))

    import jax
    import jax.numpy as jnp

    from agrifly_tpu.planner import rappids
    from agrifly_tpu.render import orchard, raycast
    from agrifly_tpu.ops import rotation as rot

    cfg = raycast.make_config(w, h, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    cam = rappids.make_camera(w, h, focal=w / 2.0, depth_scale=10.0 / 256.0)
    params = rappids.make_params(cam, true_radius=0.116, plan_radius=0.174,
                                 min_check_dist=0.5)
    att = raycast.camera_attitude(rot.identity())

    # cluttered viewpoints inside the orchard rows
    poses = [(5.0, 0.0, 2.5), (12.0, 1.5, 2.0), (20.0, -1.0, 3.0),
             (30.0, 0.5, 1.5)]
    aggs = []
    for k, p in enumerate(poses):
        pos = jnp.asarray(p, jnp.float32)
        depth = jax.block_until_ready(
            raycast.render_depth(cfg, scene, pos, att))
        m = compare_on_scene(
            params, depth, jax.random.PRNGKey(100 + k),
            jnp.array([0.0, 0.0, 1.5], jnp.float32), jnp.zeros(3),
            jnp.array([0.0, 9.81, 0.0], jnp.float32),
            jnp.array([0.0, 0.0, 50.0], jnp.float32),
            n_cand, n_pyr)
        print(json.dumps({"scene": k, **m}))
        aggs.append(m)

    _util.report("seq_oracle_label_agreement",
                 float(np.mean([a["label_agreement"] for a in aggs])), "frac")
    _util.report("seq_oracle_mean_cost_delta",
                 float(np.nanmean([a["chosen_cost_delta"] for a in aggs])),
                 "cost")
    tot = lambda k: int(np.sum([a[k] for a in aggs]))
    print(json.dumps({
        "disagreement_breakdown": {
            k: tot(k) for k in (
                "n_disagree", "batch_conservative_coverage",
                "batch_conservative_geometry", "batch_conservative_gt_free",
                "batch_optimistic_gt_free", "batch_optimistic_false_free")
        }}))


if __name__ == "__main__":
    main(sys.argv[1:])
