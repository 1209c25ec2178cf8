"""Shared timing/reporting helpers for the benchmark scripts.

Each benchmarks/bench_*.py prints one JSON line per metric in the same
shape as the driver's bench.py:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
Each script refuses to run when JAX finds no GPU; pass --cpu to run it on
the CPU on purpose (numbers from such a run are not device numbers). Run
one benchmark process per card: a JAX process reserves most of the card's
memory when it first uses it.
"""

from __future__ import annotations

import json
import time


def setup(argv):
    """Entry set-up of every benchmark script: --cpu forces the CPU
    backend (and is removed from argv), the compile cache is set up, and
    a CPU backend without --cpu is refused. Returns argv."""
    argv = list(argv)
    allow_cpu = "--cpu" in argv
    if allow_cpu:
        import os

        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        argv.remove("--cpu")
    from agrifly_tpu import backend

    backend.require_device(allow_cpu=allow_cpu)
    backend.setup_compile_cache()
    return argv


def best_time(fn, *args, reps=5, warmup=1):
    """Best wall time of fn(*args) with block_until_ready, after warmup."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def report(metric, value, unit, baseline=None):
    from agrifly_tpu import backend

    line = {"metric": metric, "value": value, "unit": unit,
            "device": backend.device_info()}
    if baseline:
        line["vs_baseline"] = value / baseline
    print(json.dumps(line))


def pipelined_time(fn, *args, calls=8, warmup=1):
    """Total wall time of `calls` back-to-back dispatches with ONE final
    block_until_ready — bench.py's throughput methodology (a serialized
    per-call loop pays the full dispatch latency per call and
    understates throughput)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / calls
