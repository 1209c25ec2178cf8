import os

# Tests run on the CPU, on a virtual 8-device mesh so the multi-device
# sharding logic is exercised without accelerators; unit tests must be
# fast, deterministic, and float32-exact. AGRIFLY_TEST_GPU=1 leaves JAX on
# its default backend instead: chip_smoke.py sets it to run the tests
# marked `gpu` (`pytest -m gpu tests`) on the card. Must run before jax is
# imported.
ON_CARD = os.environ.get("AGRIFLY_TEST_GPU") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CARD:
    # the environment may pin another platform; the config wins
    jax.config.update("jax_platforms", "cpu")
    # allow float64 golden tests on CPU (the simulator itself is float32)
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="also run tests marked slow (multi-minute: golden flights, "
             "multihost, sharding equivalence)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(reason="slow; enable with --slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Tests marked `gpu` take this fixture: they run only where JAX's
    backend is a GPU (chip_smoke.py runs them there) and skip elsewhere."""
    from agrifly_tpu import backend

    if backend.platform() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
