"""Full-resolution end-to-end flight verification.

The CPU CI flight (tests/test_orchard_flight.py) runs at 160x120 / 96
candidates; this script flies the PRODUCTION configuration — 640x480
depth, 256 candidates, the backend's render path — and applies the same
acceptance checks (takeoff, forward progress, no panic, bounded speed,
trunk clearance), printing one JSON line per check.

    python -m benchmarks.verify_fullres_flight [--cpu] [--frames 300]
"""

import json
import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    n_frames = int(argv[argv.index("--frames") + 1]) if "--frames" in argv else 300

    import numpy as np
    import jax
    import jax.numpy as jnp

    from agrifly_tpu.models import logic as onboard
    from agrifly_tpu.render import orchard as orch
    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params(
        goal_world=(60.0, 0.0, 2.0),
        takeoff_height=2.0,
        start_flight_time=3.0,
        seed=0,
        noise_scale=1.0,
    )  # production defaults: 640x480, 256 candidates
    state = orchard_env.init_state(params, jax.random.PRNGKey(0))
    fly = jax.jit(lambda s: orchard_env.fly(params, s, n_frames))
    final, outs = jax.block_until_ready(fly(state))

    pos = np.asarray(outs["pos"])
    vel = np.linalg.norm(np.asarray(outs["vel"]), axis=-1)
    pre_flight_frames = min(
        int(3.0 / (params.steps_per_frame * float(params.base.dt_us) * 1e-6)),
        n_frames - 1)

    def trunk_clear():
        scene = params.scene
        sx, sy = float(scene.tree_spacing), float(scene.row_spacing)
        for p in pos[pre_flight_frames:]:
            ix, iy = int(np.floor(p[0] / sx)), int(np.floor(p[1] / sy))
            for dx_ in (-1, 0, 1):
                for dy_ in (-1, 0, 1):
                    f = orch.tree_fields(scene, jnp.int32(ix + dx_),
                                         jnp.int32(iy + dy_))
                    if not bool(f["present"]):
                        continue
                    d = np.hypot(p[0] - float(f["cx"]), p[1] - float(f["cy"]))
                    if d < float(f["trunk_r"]) and p[2] < float(f["trunk_h"]):
                        return False
        return True

    checks = {
        "takeoff_reached": bool(pos[pre_flight_frames - 1, 2] > 1.5),
        "forward_progress_m": float(pos[-1, 0]),
        "no_ground_strike": bool(np.all(pos[pre_flight_frames:, 2] > 0.2)),
        "no_panic": int(final.base.logic.panic_reason) == onboard.PANIC_NO_PANIC,
        "plans_adopted": int(final.plan_count),
        "max_speed_mps": float(vel.max()),
        "trunks_cleared": trunk_clear(),
    }
    ok = (checks["takeoff_reached"] and checks["forward_progress_m"] > 3.0
          and checks["no_ground_strike"] and checks["no_panic"]
          and checks["plans_adopted"] > 3 and checks["max_speed_mps"] < 7.5
          and checks["trunks_cleared"])
    print(json.dumps({"metric": "fullres_flight_ok", "value": bool(ok),
                      "unit": "bool", **checks}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
