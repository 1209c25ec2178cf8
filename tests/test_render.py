"""On-device depth raycaster: geometric correctness from known poses."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.render import orchard, raycast

CFG = raycast.make_config(width=160, height=120, far=10.0, dda_steps=8)
SCALE = 10.0 / 256.0


def empty_scene():
    # presence 0: no trees, just the ground plane
    return orchard.make_params(presence=0.0)


def test_camera_convention_looks_forward():
    # camera mounted forward: at 2 m height looking at flat ground, the top
    # half of the image is sky (255 = far), the bottom half hits the ground
    scene = empty_scene()
    pos = jnp.array([0.0, 0.0, 2.0], jnp.float32)
    att = rot.identity()  # body level, facing +x
    img = np.asarray(raycast.render_depth_body(CFG, scene, pos, att))
    assert img.shape == (120, 160)
    assert np.all(img[:50, :] == 255)  # sky
    # ground enters the far plane where h*f/k < far: k > 2*80/10 = 16 px
    assert np.all(img[80:, :] < 255)  # ground visible


def test_ground_depth_values():
    # pixel (cy + k, cx): ray declination angle theta has tan(theta) = k/f;
    # planar depth to ground from height h is h * f / k
    scene = empty_scene()
    h = 2.0
    pos = jnp.array([0.0, 0.0, h], jnp.float32)
    img = np.asarray(raycast.render_depth_body(CFG, scene, pos, rot.identity()))
    f = CFG.focal
    for k in (30, 45, 59):
        expected = h * f / k
        if expected < 10.0:
            got = img[60 + k, 80] * SCALE
            assert abs(got - expected) < 0.15, (k, got, expected)


def test_single_tree_visible():
    # a dense orchard straight ahead: something closer than far plane in view
    scene = orchard.make_params(presence=1.0, clear_radius=2.0, seed=3)
    pos = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    img = np.asarray(raycast.render_depth_body(CFG, scene, pos, rot.identity()))
    assert img.min() < 200  # trees within ~8 m
    assert (img < 255).mean() > 0.2


def test_yaw_changes_view():
    scene = orchard.make_params(presence=1.0, clear_radius=2.0, seed=5)
    pos = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    img0 = np.asarray(raycast.render_depth_body(CFG, scene, pos, rot.identity()))
    att_yaw = rot.from_euler_ypr(jnp.float32(np.pi / 2), jnp.float32(0), jnp.float32(0))
    img1 = np.asarray(raycast.render_depth_body(CFG, scene, pos, att_yaw))
    assert not np.array_equal(img0, img1)


def test_batched_render():
    scene = orchard.make_params(seed=7)
    poses = jnp.array([[0.0, 0.0, 1.5], [1.0, 0.5, 2.0], [2.0, -1.0, 1.0]], jnp.float32)
    atts = jnp.tile(rot.identity(), (3, 1))
    imgs = jax.vmap(lambda p, a: raycast.render_depth_body(CFG, scene, p, a))(poses, atts)
    assert imgs.shape == (3, 120, 160)


def test_deterministic_scene():
    scene = orchard.make_params(seed=11)
    pos = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    a = np.asarray(raycast.render_depth_body(CFG, scene, pos, rot.identity()))
    b = np.asarray(raycast.render_depth_body(CFG, scene, pos, rot.identity()))
    assert np.array_equal(a, b)
    scene2 = orchard.make_params(seed=12)
    c = np.asarray(raycast.render_depth_body(CFG, scene2, pos, rot.identity()))
    assert not np.array_equal(a, c)


def test_rgb_render():
    scene = orchard.make_params(presence=1.0, clear_radius=2.0, seed=3)
    pos = jnp.array([0.0, 0.0, 1.5], jnp.float32)
    img = np.asarray(raycast.render_rgb_body(CFG, scene, pos, rot.identity()))
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    # sky at top (bluish: B > R), something non-sky below
    assert img[5, 80, 2] > img[5, 80, 0]
    # pure-sky pixels in the RGB image must be beyond the far plane in depth
    depth = np.asarray(raycast.render_depth_body(CFG, scene, pos, rot.identity()))
    sky_color = np.asarray(raycast._COLORS[0] * 255).astype(np.uint8)
    sky_rgb = np.all(img == sky_color, axis=-1)
    assert sky_rgb.any()
    assert np.all(depth[sky_rgb] == 255)
    # near-field content is visibly not sky-colored
    near = depth < 100
    assert near.any()
    ys, xs = np.where(near)
    diff = np.abs(img[ys, xs].astype(int) - sky_color.astype(int)).max()
    assert diff > 20


def _kernel_poses(batch):
    pos = jnp.array([[0.0, 0.0, 1.5], [1.0, 0.5, 2.0], [2.0, -1.0, 1.0]],
                    jnp.float32)[:batch]
    yaws = jnp.array([0.0, 0.4, -0.7], jnp.float32)[:batch]
    att = jax.vmap(lambda y: raycast.camera_attitude(
        rot.from_euler_ypr(y, jnp.float32(0.0), jnp.float32(0.0))))(yaws)
    return pos, att


# (width, height, batch, tile): widths below or off the 128-wide default
# tile exercise the wrapper's padding; small tiles exercise the grid
@pytest.mark.parametrize("w,h,batch,tile", [
    (64, 48, 1, None), (96, 72, 1, None), (160, 120, 1, None),
    (160, 120, 3, None), (100, 60, 2, None), (96, 72, 2, (2, 64, 2)),
    (64, 48, 1, (8, 32, 1)), (160, 120, 1, (4, 256, 8)),
])
def test_triton_kernel_matches_jnp_interpret(w, h, batch, tile):
    from agrifly_tpu.render import pallas_raycast

    cfg = raycast.make_config(w, h, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=7)
    pos, att = _kernel_poses(batch)
    kw = {} if tile is None else dict(bh=tile[0], bw=tile[1], num_warps=tile[2])
    got = np.asarray(pallas_raycast.render_depth_batch(
        cfg, scene, pos, att, interpret=True, **kw))
    ref = np.asarray(jax.vmap(
        lambda p, a: raycast.render_depth(cfg, scene, p, a))(pos, att))
    assert got.shape == (batch, h, w) and got.dtype == np.int32
    # rounding-order differences move a hit distance by an ulp: +-1 code
    # at code boundaries, and a grazing ray on a silhouette can flip from
    # hit to miss (one such pixel of 57,600 here) — so bound the share
    assert (got != ref).mean() <= 1e-3
    assert (ref < 255).mean() > 0.3  # the frame sees ground and trees


def test_triton_kernel_body_mount_wrapper():
    from agrifly_tpu.render import pallas_raycast

    cfg = raycast.make_config(96, 72, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=7)
    pos = jnp.array([[0.0, 0.0, 1.5], [2.0, 1.0, 1.2]], jnp.float32)
    body = jnp.stack([rot.identity(), rot.from_euler_ypr(
        jnp.float32(0.5), jnp.float32(0.0), jnp.float32(0.0))])
    got = np.asarray(pallas_raycast.render_depth_body_batch(
        cfg, scene, pos, body, interpret=True))
    ref = np.asarray(jax.vmap(
        lambda p, q: raycast.render_depth_body(cfg, scene, p, q))(pos, body))
    assert got.shape == (2, 72, 96)
    assert (got != ref).mean() <= 1e-3


@pytest.mark.parametrize("ypr", [(0.0, 0.0, 0.0), (0.7, -0.2, 0.1),
                                 (-2.2, 0.4, -0.3)])
def test_world_ray_dirs_full_f32(ypr):
    """The pinned ray-direction product matches a float64 NumPy reference
    to f32 rounding (a TF32 product would be ~1e-3 off)."""
    cfg = raycast.make_config(160, 120)
    att = raycast.camera_attitude(rot.from_euler_ypr(
        *(jnp.float32(a) for a in ypr)))
    got = np.asarray(raycast.world_ray_dirs(cfg, att), np.float64)
    R = np.asarray(rot.to_matrix(att), np.float64)
    xs = (np.arange(cfg.width) - cfg.width / 2.0) / cfg.focal
    ys = (np.arange(cfg.height) - cfg.height / 2.0) / cfg.focal
    ex, ey = np.meshgrid(xs, ys)
    d_cam = np.stack([ex, ey, np.ones_like(ex)], axis=-1)
    ref = np.einsum("ij,hwj->hwi", R, d_cam)
    assert np.abs(got - ref).max() <= 2e-6
