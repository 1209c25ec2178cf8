"""The one backend decision, and the compile cache of the entry points.

Every choice of code path that depends on the device reads it here, and
this is the only module that asks JAX which backend it runs on:

- `platform()`: "gpu" on an NVIDIA card, "cpu" on the host.
- `gpu_raycast()`: the procedural orchard renders through the Pallas
  (Triton) raycaster on a GPU and through the jnp renderer elsewhere.
- `device_blocks()`: host loops that pace or poll between device calls
  group several frames (or ticks) per call on an accelerator and keep one
  per call on the CPU, where tests want fine granularity.
- `strip_cull()`: the imported-world renderer's strip culling default.

Entry points (demo, launch, bench.py, chip_smoke.py) call
`setup_compile_cache()` and `require_device()`; importing the package does
neither.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

# fixed path: the cache key includes the directory, so it must not move
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def platform() -> str:
    """The default backend's platform name ("gpu", "cpu")."""
    return jax.default_backend()


def gpu_raycast() -> bool:
    return platform() == "gpu"


def device_blocks() -> bool:
    return platform() != "cpu"


def strip_cull() -> bool:
    return platform() == "cpu"


def device_info() -> dict:
    """The device as JAX reports it, for result lines."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip()


def setup_compile_cache() -> str:
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX
    reads it itself), else `.jax_cache/` at the root of the checkout.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_device(allow_cpu: bool) -> None:
    """Refuse to run on the CPU backend unless the caller asked for it
    (--cpu): a missing GPU must fail loudly, not fall back."""
    if platform() == "cpu" and not allow_cpu:
        raise SystemExit(
            "no GPU found (JAX backend is cpu); pass --cpu to run on the CPU")
