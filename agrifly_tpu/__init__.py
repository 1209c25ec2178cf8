"""agrifly_tpu — an on-device (JAX) flight simulator for autonomous quadcopter flight
in agricultural environments.

A ground-up JAX/XLA/Pallas re-design of the capabilities of muellerlab/agri-fly:
  - 6-DOF rigid-body quadcopter physics with first-order motor dynamics
  - onboard flight-controller logic (EKF, cascaded controllers, mixer, safety
    state machine) fused into the same jitted step
  - offboard estimators & trajectory-tracking control with modeled radio
    latency and wire quantization
  - closed-form minimum-jerk motion primitives (RAPPIDS candidate generator)
  - depth-image collision-avoidance planning (RAPPIDS pyramids) on-device
  - a Pallas depth raycaster replacing the Unity/AirSim render path

Everything is a pure function over immutable pytrees: `state' = step(params,
state, key)`. The env axis is vmapped (thousands of drones per chip) and
shardable over a `jax.sharding.Mesh` for multi-chip scale-out.
"""

__version__ = "0.1.0"
