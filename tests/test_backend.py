"""The one backend decision (agrifly_tpu/backend.py) and the entry points
that depend on it: path choices per platform, refusing a CPU-only backend,
the compile-cache directory, and chip_smoke.py's device check and result
line."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agrifly_tpu import backend


def test_cpu_chooses_jnp_paths():
    assert backend.platform() == "cpu"
    assert not backend.gpu_raycast()
    assert backend.strip_cull()
    assert not backend.device_blocks()


def test_gpu_platform_chooses_gpu_paths(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert backend.gpu_raycast()
    assert not backend.strip_cull()
    assert backend.device_blocks()


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_render_entry_follows_backend(monkeypatch, platform):
    """raycast.render_depth_batch runs the Triton kernel (here in interpret
    mode) exactly when the backend says gpu; both paths agree."""
    from agrifly_tpu.ops import rotation as rot
    from agrifly_tpu.render import orchard, pallas_raycast, raycast

    calls = []
    kernel = pallas_raycast.render_depth_batch

    def spy(*a, **kw):
        calls.append(1)
        return kernel(*a, interpret=True, **kw)

    monkeypatch.setattr(backend, "platform", lambda: platform)
    monkeypatch.setattr(pallas_raycast, "render_depth_batch", spy)
    cfg = raycast.make_config(64, 48)
    scene = orchard.make_params(seed=2)
    pos = jnp.array([[0.0, 0.0, 1.5], [3.0, 1.0, 2.0]], jnp.float32)
    att = jax.vmap(raycast.camera_attitude)(jnp.tile(rot.identity(), (2, 1)))
    got = np.asarray(raycast.render_depth_batch(cfg, scene, pos, att))
    ref = np.asarray(jax.vmap(
        lambda p, a: raycast.render_depth(cfg, scene, p, a))(pos, att))
    assert len(calls) == (1 if platform == "gpu" else 0)
    assert got.shape == (2, 48, 64)
    assert (got != ref).mean() <= 1e-3


@pytest.mark.parametrize("platform,strips", [("cpu", True), ("gpu", False)])
def test_mesh_strip_cull_default_follows_backend(monkeypatch, platform, strips):
    from agrifly_tpu.render import meshscene, raycast

    monkeypatch.setattr(backend, "platform", lambda: platform)
    used = []
    for name in ("render_depth_window", "render_depth_window_strips"):
        fn = getattr(meshscene, name)
        monkeypatch.setattr(meshscene, name, functools.partial(
            lambda f, n, *a, **k: used.append(n) or f(*a, **k), fn, name))
    scene = meshscene.build_scene(spheres=[(5.0, 0.0, 1.5, 1.0)])
    cfg = raycast.make_config(32, 32)
    att = raycast.camera_attitude(jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32))
    img = meshscene.render_depth(cfg, scene, jnp.array([0.0, 0.0, 1.5]), att)
    assert img.shape == (32, 32)
    assert used == ["render_depth_window_strips" if strips
                    else "render_depth_window"]


def _demo(argv):
    from agrifly_tpu import demo

    return demo.main(argv)


def _launch(argv):
    from agrifly_tpu import launch

    return launch.main(argv)


def _bench(argv):
    import bench

    return bench.main(argv)


def _benchmarks(argv):
    from benchmarks import _util

    return _util.setup(argv)


@pytest.mark.parametrize("entry", [_demo, _launch, _bench, _benchmarks])
def test_entry_points_refuse_cpu_backend(entry):
    with pytest.raises(SystemExit, match="no GPU found"):
        entry(["--frames", "1"] if entry in (_demo, _launch) else [])


def test_require_device_allows_cpu_when_asked():
    backend.require_device(allow_cpu=True)  # no raise


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env


def test_compile_cache_default_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = backend.setup_compile_cache()
        assert got == str(backend.DEFAULT_CACHE_DIR)
        assert backend.DEFAULT_CACHE_DIR.name == ".jax_cache"
        assert (backend.DEFAULT_CACHE_DIR.parent / "agrifly_tpu").is_dir()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_device_check_refuses_cpu():
    import chip_smoke

    with pytest.raises(SystemExit, match="not 'gpu'"):
        chip_smoke.check_device()


def test_chip_smoke_result_line_contract():
    import chip_smoke

    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": "ignored"})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("leaf,delta,ok", [
    ("fields", 1, True),      # a wire code may flip by one
    ("fields", 2, False),
    ("types", 1, False),      # other discrete leaves must be equal
])
def test_chip_smoke_compare_trees_wire_codes(leaf, delta, ok):
    import chip_smoke

    ref = {"fields": np.arange(6, dtype=np.int32), "types": np.zeros(3, np.int32),
           "x": np.ones(4, np.float32)}
    got = dict(ref, **{leaf: ref[leaf] + np.int32(delta)})
    compare = functools.partial(chip_smoke.compare_trees, "t", got, ref,
                                rtol=1e-4, atol=1e-3, codes=("fields",))
    if ok:
        compare()
    else:
        with pytest.raises(chip_smoke.PhaseFailed):
            compare()
