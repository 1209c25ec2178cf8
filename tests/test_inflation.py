"""Pyramid inflation soundness (rappids.build_pyramid_set), checked in NumPy.

The contract (rappids.inflate_pyramid): a valid pyramid's base depth is the
minimum unmasked depth code inside its expanded rectangle, less the plan
radius, and the shrink only ever moves edges inward. So no depth pixel
inside a valid pyramid's bounds (codes above the `ignore` threshold) may
be nearer than depth + plan_radius. With downsample k the bounds come back
in full-resolution coordinates and each pooled pixel covers a k x k
block, so the check runs over the whole blocks the bounds touch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from agrifly_tpu.planner import rappids


def make_scene(W, H, n_obstacles, seed):
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 230, np.int32)
    for _ in range(n_obstacles):
        x = rng.integers(5, W - 5)
        y = rng.integers(5, H - 5)
        w = rng.integers(3, max(4, W // 8))
        h = rng.integers(5, max(6, H // 2))
        d = rng.integers(25, 140)
        img[max(0, y - h // 2):y + h // 2, max(0, x - w // 2):x + w // 2] = d
    return img


# (W, H, obstacles, scene seed, seeds P, PRNG key); every case yields
# valid pyramids at both downsample factors
CASES = [
    (160, 120, 8, 3, 24, 1),
    (80, 60, 8, 3, 24, 1),
    (160, 120, 6, 7, 16, 4),
    (160, 120, 8, 3, 13, 13),
    (160, 120, 8, 3, 5, 5),
    (160, 120, 8, 11, 16, 7),
    (80, 60, 8, 11, 16, 41),
]


@pytest.mark.parametrize("downsample", [1, 2])
@pytest.mark.parametrize("W,H,n_obst,scene_seed,P,key", CASES)
def test_valid_pyramids_are_free(W, H, n_obst, scene_seed, P, key, downsample):
    cam = rappids.make_camera(W, H, focal=W / 2.0)
    params = rappids.make_params(cam, 0.116, 0.174)
    img = make_scene(W, H, n_obst, scene_seed)
    x0 = jax.random.randint(jax.random.PRNGKey(key), (P,), 2, W - 2)
    y0 = jax.random.randint(jax.random.PRNGKey(key + 1), (P,), 2, H - 2)
    md = jax.random.uniform(jax.random.PRNGKey(key + 2), (P,), jnp.float32,
                            1.5, 3.0)

    pyrs = rappids.build_pyramid_set(
        params, jnp.asarray(img), x0.astype(jnp.float32),
        y0.astype(jnp.float32), md, jnp.ones((P,), bool), P,
        downsample=downsample)
    valid = np.asarray(pyrs.valid)
    depth = np.asarray(pyrs.depth, np.float64)
    bounds = np.asarray(pyrs.bounds)

    # depth-sorted, unused slots at +inf
    assert np.all(np.diff(depth[np.isfinite(depth)]) >= 0)
    assert np.all(np.isinf(depth[~valid]))

    assert valid.sum() >= 1  # scene sanity
    scale = float(cam.depth_scale)
    ignore = int(float(params.true_radius) / scale)
    k = downsample
    for i in np.flatnonzero(valid):
        right, top, left, bottom = (int(v) for v in bounds[i])
        assert left < right and top < bottom
        region = img[top:min(bottom + k, H), left:min(right + k, W)]
        seen = region[region > ignore]
        if seen.size:
            nearest = seen.min() * scale - float(params.plan_radius)
            assert nearest >= depth[i] - 1e-5, (i, nearest, depth[i])
    if downsample == 1:
        # a valid pyramid keeps its seed strictly inside the buffer
        buf = rappids.PIXEL_BUFFER
        seeds = list(zip(np.asarray(x0).tolist(), np.asarray(y0).tolist()))
        for i in np.flatnonzero(valid):
            right, top, left, bottom = bounds[i]
            assert any(left + buf < a < right - buf and top + buf < b < bottom - buf
                       for a, b in seeds)
