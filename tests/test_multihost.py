"""Multi-host path: 2 processes x 4 virtual CPU devices = one 8-device mesh.

Launches two fresh subprocesses (this test process already owns a jax
runtime, so the workers must be clean interpreters), each exposing 4
virtual CPU devices, joined via jax.distributed.initialize through
parallel/multihost.initialize_from_env. Each worker builds the global
env mesh, inits a 64-env fleet sharded across BOTH processes, runs 10
substeps of the fused sim step, and writes its view of the psum'd fleet
metrics. The parent asserts both processes agree bit-for-bit and the
fleet actually flew (hover command gains altitude).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, os, sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

import jax

# the environment may pin an accelerator platform; the config
# update must land before any backend/device query
jax.config.update("jax_platforms", "cpu")

from agrifly_tpu.parallel import multihost

assert multihost.initialize_from_env(), "env launch vars missing"

pid, nproc = multihost.process_info()
assert nproc == 2, nproc
n_global = len(jax.devices())
n_local = len(jax.local_devices())

from agrifly_tpu.parallel import multihost as mh
from agrifly_tpu.parallel import sharding
from agrifly_tpu.sim import env as env_mod

params = env_mod.make_params(noise_scale=0.0)
mesh = mh.global_env_mesh()
N = 64
states = mh.init_global_fleet(params, mesh, N, base_seed=3)
step = mh.make_global_fleet_step(params, mesh, N, n_substeps=10)
cmd = env_mod.hover_command((0.0, 0.0, 1.2))
import jax.numpy as jnp
shard = sharding.env_sharding(mesh)
cmds = jax.jit(
    lambda: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N,) + x.shape), cmd),
    out_shardings=jax.tree_util.tree_map(lambda _: shard, cmd))()
for _ in range(5):
    states, metrics = step(states, cmds)
out = dict(
    process=pid, n_global=n_global, n_local=n_local,
    mean_pos=[float(x) for x in jax.device_get(metrics.mean_pos)],
    mean_speed=float(jax.device_get(metrics.mean_speed)),
    num_panicked=int(jax.device_get(metrics.num_panicked)),
)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


_ORCHARD_WORKER = r"""
import json, os, sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

import jax

jax.config.update("jax_platforms", "cpu")

from agrifly_tpu.parallel import multihost as mh

assert mh.initialize_from_env(), "env launch vars missing"
pid, nproc = mh.process_info()
assert nproc == 2, nproc

from agrifly_tpu.sim import orchard_env

# small frame so 2 frames of render+plan+track stay CPU-friendly
params = orchard_env.make_params(
    width=64, height=48, n_candidates=16, pyramid_capacity=4,
    planner_rounds=1, start_flight_time=0.2)
mesh = mh.global_env_mesh()
N = 8
states = mh.init_global_orchard_fleet(params, mesh, N, base_seed=5)
step = mh.make_global_orchard_step(params, mesh, N, n_frames=2)
for _ in range(2):
    states, metrics = step(states)
out = dict(
    process=pid,
    n_global=len(jax.devices()), n_local=len(jax.local_devices()),
    mean_pos=[float(x) for x in jax.device_get(metrics.mean_pos)],
    num_panicked=int(jax.device_get(metrics.num_panicked)),
    num_plans=int(jax.device_get(metrics.num_plans)),
    num_landed=int(jax.device_get(metrics.num_landed)),
)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.update({
            "AGRIFLY_COORD": f"127.0.0.1:{port}",
            "AGRIFLY_NPROC": "2",
            "AGRIFLY_PROC_ID": str(pid),
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    r0, r1 = (json.load(open(o)) for o in outs)
    # a process-spanning runtime: 8 global devices, 4 local each
    assert r0["n_global"] == r1["n_global"] == 8
    assert r0["n_local"] == r1["n_local"] == 4
    assert {r0["process"], r1["process"]} == {0, 1}
    # psum'd metrics are replicated: both processes see identical values
    assert r0["mean_pos"] == r1["mean_pos"]
    assert r0["mean_speed"] == r1["mean_speed"]
    # the fleet flew: 50 hover ticks with perfect-state control climb
    assert r0["mean_pos"][2] > 0.001
    assert r0["num_panicked"] == 0
    assert np.isfinite(r0["mean_speed"])


@pytest.mark.slow
def test_two_process_orchard_loop(tmp_path):
    """The FULL render->plan->track orchard frame crosses a process
    boundary: 2 procs x 4 CPU devices fly 4 frames of the config-#4
    workload sharded over the global mesh; the psum'd OrchardFleetMetrics
    must be bit-identical on both processes and show real flight."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"orchard{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.update({
            "AGRIFLY_COORD": f"127.0.0.1:{port}",
            "AGRIFLY_NPROC": "2",
            "AGRIFLY_PROC_ID": str(pid),
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _ORCHARD_WORKER, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    r0, r1 = (json.load(open(o)) for o in outs)
    assert r0["n_global"] == r1["n_global"] == 8
    assert r0["n_local"] == r1["n_local"] == 4
    # replicated psums agree bit-for-bit across the process boundary
    assert r0["mean_pos"] == r1["mean_pos"]
    assert r0["num_panicked"] == r1["num_panicked"]
    assert r0["num_plans"] == r1["num_plans"]
    assert r0["num_landed"] == r1["num_landed"]
    # the fleet actually flew the perception loop: climbing off the
    # ground (4 frames = 0.26 s of sim: early takeoff), no panics
    assert r0["mean_pos"][2] > 0.01, r0
    assert r0["num_panicked"] == 0, r0
