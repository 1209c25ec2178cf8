"""Tests that need the GPU: they skip elsewhere (the `gpu` fixture) and
chip_smoke.py runs them on the card (`AGRIFLY_TEST_GPU=1 pytest -m gpu`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agrifly_tpu import backend
from agrifly_tpu.ops import rotation as rot
from agrifly_tpu.render import orchard, pallas_raycast, raycast

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def test_backend_picks_gpu_paths():
    assert backend.gpu_raycast()
    assert not backend.strip_cull()
    assert backend.device_blocks()


def test_triton_kernel_matches_jnp_at_full_width():
    cfg = raycast.make_config(640, 480, far=10.0, dda_steps=8)
    scene = orchard.make_params(seed=0)
    pos = jnp.array([[0.0, 0.0, 1.5], [20.0, 3.0, 2.5], [50.0, -6.0, 1.0],
                     [7.0, 1.0, 4.0]], jnp.float32)
    att = jax.vmap(lambda y: raycast.camera_attitude(rot.from_euler_ypr(
        y, jnp.float32(0.0), jnp.float32(0.0))))(
            jnp.array([0.0, 0.3, -0.5, 1.2], jnp.float32))
    got = np.asarray(pallas_raycast.render_depth_batch(cfg, scene, pos, att))
    ref = np.asarray(jax.vmap(
        lambda p, a: raycast.render_depth(cfg, scene, p, a))(pos, att))
    assert got.shape == (4, 480, 640)
    assert (got != ref).mean() <= 1e-3


def test_world_ray_dirs_full_f32_on_card():
    """No TF32 in the pinned ray-direction product on the card."""
    cfg = raycast.make_config(640, 480)
    att = raycast.camera_attitude(rot.from_euler_ypr(
        jnp.float32(0.7), jnp.float32(-0.2), jnp.float32(0.1)))
    got = np.asarray(jax.jit(lambda a: raycast.world_ray_dirs(cfg, a))(att),
                     np.float64)
    R = np.asarray(rot.to_matrix(att), np.float64)
    xs = (np.arange(cfg.width) - cfg.width / 2.0) / cfg.focal
    ys = (np.arange(cfg.height) - cfg.height / 2.0) / cfg.focal
    ex, ey = np.meshgrid(xs, ys)
    ref = np.einsum("ij,hwj->hwi", R,
                    np.stack([ex, ey, np.ones_like(ex)], axis=-1))
    assert np.abs(got - ref).max() <= 2e-6
