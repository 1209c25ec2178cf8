"""Golden-trajectory regression: bit-stability of the fused sim across
rounds of development.

This pins a frozen golden trace of this framework's own CPU float32
rollout (deterministic: fixed PRNG key, fixed cadences). Any future change
that alters the physics, controllers, codecs, estimator, or timing
semantics will show up as a diff here and must be justified.

Comparison against the ACTUAL compiled reference C++ lives in
test_golden_cpp.py (the reference builds in-image with the
tensorflow-bundled Eigen and -std=c++17; see native/golden/). This
self-golden complements it: it locks the framework's own fused-env
composition, which the C++ loop arrangement doesn't cover.

Regenerate with: python -m tests.test_golden  (after intentional changes)
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp

GOLDEN = pathlib.Path(__file__).parent / "golden" / "hover_traj_v1.npz"


def _run_reference_rollout():
    from agrifly_tpu.sim import env

    params = env.make_params(noise_scale=1.0)
    state = env.init_state(params, jax.random.PRNGKey(1234))
    cmd = env.hover_command((0.3, -0.2, 1.2))
    rollout = jax.jit(env.rollout, static_argnums=(3, 4))
    final, traj = rollout(params, state, cmd, 1500, True)  # 3 s, mocap mode
    idx = np.arange(0, 1500, 50)
    return {
        "pos": np.asarray(traj.pos)[idx],
        "vel": np.asarray(traj.vel)[idx],
        "att": np.asarray(traj.att)[idx],
        "motor_speeds": np.asarray(traj.motor_speeds)[idx],
        "final_kf_pos": np.asarray(final.logic.kf.pos),
        "final_mocap_pos": np.asarray(final.mocap.pos),
    }


def test_golden_hover_trajectory():
    if not GOLDEN.exists():
        import pytest

        pytest.skip("golden trace not generated yet")
    got = _run_reference_rollout()
    ref = np.load(GOLDEN)
    for k in ref.files:
        np.testing.assert_allclose(
            got[k], ref[k], rtol=0, atol=1e-5,
            err_msg=f"golden mismatch in {k} — physics/control semantics changed",
        )


if __name__ == "__main__":
    # the golden is pinned on the CPU backend (tests run there via conftest);
    # regeneration must not pick up an accelerator platform
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.parent.mkdir(exist_ok=True)
    data = _run_reference_rollout()
    np.savez_compressed(GOLDEN, **data)
    print(f"wrote {GOLDEN}")
