"""Explicit (imported) scene geometry: loaders, renderer parity, flight.

The reference's world is a specific Helios-generated orchard rendered by
Unity (README.md:98-104); this framework imports explicit geometry
(render/meshscene.py) and renders it on device. Cross-validation anchor:
baking the procedural orchard into explicit primitives must reproduce the
procedural renderer pixel-for-pixel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.render import meshscene, orchard as orch, raycast


@pytest.fixture(scope="module")
def baked():
    scene = orch.make_params(seed=0)
    cfg = raycast.make_config(160, 112, far=10.0, dda_steps=8)
    mesh = meshscene.from_orchard(scene, (-25, 65), (-25, 25))
    return scene, cfg, mesh


def test_baked_orchard_matches_procedural_renderer(baked):
    scene, cfg, mesh = baked
    assert mesh.count > 50
    att = raycast.camera_attitude(jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32))
    rng = np.random.default_rng(0)
    for _ in range(4):
        pos = jnp.asarray(
            [rng.uniform(-5, 40), rng.uniform(-10, 10), rng.uniform(0.5, 4.0)],
            jnp.float32,
        )
        d_proc = np.asarray(raycast.render_depth(cfg, scene, pos, att)).astype(int)
        d_mesh = np.asarray(meshscene.render_depth(cfg, mesh, pos, att)).astype(int)
        # two separately compiled XLA programs: allow 1-ulp floor-boundary
        # flips (+-1 code) on a vanishing fraction of pixels
        delta = np.abs(d_proc - d_mesh)
        assert delta.max() <= 1, delta.max()
        assert (delta > 0).mean() < 1e-3, (delta > 0).sum()


def test_obj_loader_and_triangle_rendering(tmp_path):
    # an axis-aligned box 2..4 x, -1..1 y, 0..2 z in front of the camera
    obj = tmp_path / "box.obj"
    obj.write_text(
        "v 2 -1 0\nv 2 1 0\nv 4 1 0\nv 4 -1 0\n"
        "v 2 -1 2\nv 2 1 2\nv 4 1 2\nv 4 -1 2\n"
        "f 1 2 3 4\nf 5 6 7 8\nf 1 2 6 5\nf 2 3 7 6\nf 3 4 8 7\nf 4 1 5 8\n"
    )
    mesh = meshscene.load_obj(str(obj))
    assert mesh.count == 12  # 6 quads fan-triangulated

    cfg = raycast.make_config(160, 112, far=10.0)
    att = raycast.camera_attitude(jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32))
    d = np.asarray(meshscene.render_depth(
        cfg, mesh, jnp.array([0.0, 0.0, 1.0], jnp.float32), att))
    # the camera looks along +x: the x=2 face sits at planar depth 2 m
    code_2m = int(2.0 / (cfg.far / 256.0))
    center = d[50:62, 76:84]
    assert np.all(center == code_2m), center
    # box occupies a bounded patch; sky pixels remain
    assert (d == 255).sum() > 1000


def test_primitives_loader(tmp_path):
    f = tmp_path / "scene.txt"
    f.write_text(
        "# test scene\n"
        "sphere 3 0 1.5 0.5\n"
        "cylinder 5 1 0 2 0.2\n"
        "tree 8 -1 0.25 1.8 8 -1 2.5 1.2\n"
    )
    mesh = meshscene.load_primitives(str(f))
    assert mesh.count == 4  # sphere + cylinder + tree(cyl+sphere)

    bad = tmp_path / "bad.txt"
    bad.write_text("sphere 1 2\n")
    with pytest.raises(ValueError, match="bad record"):
        meshscene.load_primitives(str(bad))


def test_rappids_flight_through_explicit_scene(baked):
    """Full perception-plan-act loop against the imported world: the drone
    flies the RAPPIDS loop through the baked orchard (not the procedural
    hash) and makes forward progress without panicking."""
    from agrifly_tpu.models import logic as onboard
    from agrifly_tpu.sim import orchard_env

    scene, _, mesh = baked
    params = orchard_env.make_params(
        goal_world=(60.0, 0.0, 2.0), takeoff_height=2.0,
        start_flight_time=3.0, steps_per_frame=16, n_candidates=64,
        pyramid_capacity=16, width=160, height=120,
        seed=0, noise_scale=1.0, mesh_scene=mesh,
    )
    state = orchard_env.init_state(params, jax.random.PRNGKey(0))
    fly = jax.jit(lambda s: orchard_env.fly(params, s, 220))
    final, outs = fly(state)
    pos = np.asarray(outs["pos"])
    assert int(final.base.logic.panic_reason) == onboard.PANIC_NO_PANIC
    assert int(final.plan_count) > 3
    assert pos[-1, 0] > 2.0, pos[-1]  # forward progress through the trees
    assert np.all(pos[95:, 2] > 0.2)  # never hits the ground mid-flight


def test_strip_culled_window_parity_random_poses(baked):
    """The strip-compacted window render (host-side vector cone culling +
    per-strip trip counts) must match the full-window render pixel for
    pixel over random poses and yaws — the culling is conservative, so
    no possibly-hitting row is ever dropped."""
    scene, cfg, mesh = baked
    reach = cfg.far * meshscene.slant_factor(cfg)
    rng = np.random.default_rng(5)
    for _ in range(4):
        pos = jnp.asarray(
            [rng.uniform(-5, 40), rng.uniform(-10, 10), rng.uniform(0.5, 4.0)],
            jnp.float32,
        )
        att = raycast.camera_attitude(
            rot.from_euler_ypr(jnp.float32(rng.uniform(-np.pi, np.pi)), 0.0, 0.0))
        win = meshscene.select_window(mesh, pos, reach, 96)
        ref = np.asarray(meshscene.render_depth_window(cfg, win, pos, att))
        got = np.asarray(meshscene.render_depth_window_strips(
            cfg, win, pos, att))
        np.testing.assert_array_equal(ref, got)
        # and the compaction is actually doing something
        _, nvis = meshscene.strip_windows(cfg, win, pos, att, 16)
        assert float(np.asarray(nvis).mean()) < 48


def test_rgb_baked_orchard_matches_procedural(baked):
    """RGB for imported worlds: the baked orchard through
    meshscene.render_rgb must produce (near-)the procedural
    raycast.render_rgb picture — same geometry, same materials, same
    shading formulas; differences only at silhouette edges where the two
    traversals resolve grazing rays differently."""
    scene, cfg, mesh = baked
    pos = jnp.array([2.0, 1.0, 1.5], jnp.float32)
    att = raycast.camera_attitude(rot.identity())
    ref = np.asarray(raycast.render_rgb(cfg, scene, pos, att))
    got = np.asarray(meshscene.render_rgb(cfg, mesh, pos, att))
    assert got.shape == ref.shape == (cfg.height, cfg.width, 3)
    same = (np.abs(ref.astype(int) - got.astype(int)) <= 2).all(axis=-1)
    frac = same.mean()
    assert frac > 0.98, f"only {frac:.3f} of pixels match"
    # sanity: the frame actually contains trunk/canopy/ground materials
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 20


def test_strip_culled_jnp_fallback_bit_exact(baked):
    """render_depth's strip-culled path (the CPU default) is bit-identical
    to the plain full-window scan: culling is conservative, min is
    order-independent, and the default chunk=16 matches the plain path's
    fusion shapes (this test pins that)."""
    scene, cfg, mesh = baked
    poses = [
        (jnp.array([5.0, 0.0, 2.5], jnp.float32),
         jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)),
        (jnp.array([20.0, 3.0, 1.2], jnp.float32),     # low, inside rows
         rot.from_euler_ypr(0.7, -0.2, 0.0)),
        (jnp.array([-10.0, -8.0, 6.0], jnp.float32),   # outside, looking in
         rot.from_euler_ypr(-2.2, 0.4, 0.1)),
    ]
    for pos, q in poses:
        att = raycast.camera_attitude(q)
        plain = np.asarray(meshscene.render_depth(
            cfg, mesh, pos, att, strip_cull=False))
        culled = np.asarray(meshscene.render_depth(
            cfg, mesh, pos, att, strip_cull=True))
        np.testing.assert_array_equal(culled, plain)
    # H % tile_h != 0 falls back to the plain scan
    w = meshscene.select_window(
        mesh, poses[0][0], cfg.far * meshscene.slant_factor(cfg), 192)
    att0 = raycast.camera_attitude(poses[0][1])
    odd = np.asarray(meshscene.render_depth_window_strips(
        cfg, w, poses[0][0], att0, tile_h=32))
    np.testing.assert_array_equal(
        odd, np.asarray(meshscene.render_depth_window(cfg, w, poses[0][0], att0)))


def test_strip_culled_rgb_bit_exact(baked):
    """RGB strip-cull path (winner index through the compaction order,
    far-clip disabled: beyond-far hits still shade) matches the plain
    winner-tracking scan bit-for-bit."""
    scene, cfg, mesh = baked
    poses = [
        (jnp.array([5.0, 0.0, 2.5], jnp.float32),
         jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)),
        (jnp.array([20.0, 3.0, 1.2], jnp.float32),
         rot.from_euler_ypr(0.7, -0.2, 0.0)),
    ]
    for pos, q in poses:
        att = raycast.camera_attitude(q)
        plain = np.asarray(meshscene.render_rgb(
            cfg, mesh, pos, att, strip_cull=False))
        culled = np.asarray(meshscene.render_rgb(
            cfg, mesh, pos, att, strip_cull=True))
        np.testing.assert_array_equal(culled, plain)
