"""Simulated ultra-wideband ranging network.

JAX rewrite of Components/Components/Simulation/UWB{Radio,Network}.{hpp,cpp}:
radios are rows of a position table (vehicles first, then fixed anchors);
the network round-robins one ranging transaction per communication period in
two phases (latch a requester/responder pair, then complete the measurement
one period later) and broadcasts the result to every radio — including the
reference's quirk that all vehicles "hear" every ranging. Gaussian range
noise plus an outlier branch with configurable probability/std
(UWBNetwork.cpp:66-82); deterministic under a carried PRNG key (the C++
seeds its global rng with 0 for repeatability).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class UwbParams(NamedTuple):
    comm_period_us: jnp.ndarray  # int32
    noise_std: jnp.ndarray  # f32 range noise
    outlier_prob: jnp.ndarray  # f32
    outlier_std: jnp.ndarray  # f32
    radio_ids: jnp.ndarray  # (R,) int32: vehicles then anchors; 0 = unused slot
    num_radios: jnp.ndarray  # int32
    failure_prob: jnp.ndarray  # f32: transaction completes but is reported failed
    max_range: jnp.ndarray  # f32: beyond this the responder never hears (silence)


class UwbState(NamedTuple):
    acc_us: jnp.ndarray  # int32 accumulator since last network action
    pending: jnp.ndarray  # bool: a transaction is latched
    requester_id: jnp.ndarray  # int32
    responder_id: jnp.ndarray  # int32
    key: jnp.ndarray


class UwbMeasurement(NamedTuple):
    valid: jnp.ndarray  # bool: broadcast happened this step
    range: jnp.ndarray  # f32
    responder_id: jnp.ndarray  # int32
    requester_id: jnp.ndarray  # int32 (who initiated the two-way ranging)
    failure: jnp.ndarray  # bool


def make_params(radio_ids, comm_period=0.01, noise_std=0.0, outlier_prob=0.0,
                outlier_std=0.0, max_radios=None, failure_prob=0.0,
                max_range=jnp.inf) -> UwbParams:
    """failure_prob: probability a completed transaction is reported as
    failed (the reference's UwbMeasurement.failure flag, which its network
    hardwires false with a 'todo: fail like real life' — UWBNetwork.cpp:77;
    onboard consumes it by skipping the KF update, QuadcopterLogic.cpp:253).
    max_range: transactions whose true range exceeds this never complete at
    all — out-of-range radios are silent, so the onboard no-UWB panic
    (QuadcopterLogic.cpp:358-362) can fire from a real network condition."""
    import numpy as np

    ids = np.asarray(radio_ids, np.int32)
    if max_radios is None:
        max_radios = len(ids)
    padded = np.zeros(max_radios, np.int32)
    padded[: len(ids)] = ids
    return UwbParams(
        comm_period_us=jnp.int32(round(comm_period * 1e6)),
        noise_std=jnp.float32(noise_std),
        outlier_prob=jnp.float32(outlier_prob),
        outlier_std=jnp.float32(outlier_std),
        radio_ids=jnp.asarray(padded),
        num_radios=jnp.int32(len(ids)),
        failure_prob=jnp.float32(failure_prob),
        max_range=jnp.float32(max_range),
    )


def init_state(key) -> UwbState:
    return UwbState(
        acc_us=jnp.int32(0),
        pending=jnp.bool_(False),
        requester_id=jnp.int32(0),
        responder_id=jnp.int32(0),
        key=key,
    )


def step(p: UwbParams, s: UwbState, positions, next_target_ids, dt_us):
    """One network tick.

    positions: (R, 3) true radio positions (anchor rows static).
    next_target_ids: (R,) int32 — each radio's desired ranging target
    (0 = none; anchors pass 0). Returns (state, UwbMeasurement).
    """
    acc = jnp.minimum(s.acc_us + dt_us, jnp.int32(10**8))
    due = acc >= p.comm_period_us

    slot_used = jnp.arange(p.radio_ids.shape[0]) < p.num_radios

    # --- phase 1: latch the first radio that wants to range ---
    wants = slot_used & (next_target_ids != 0)
    any_wants = jnp.any(wants)
    first = jnp.argmax(wants)
    latch_req = jnp.where(any_wants, p.radio_ids[first], 0)
    latch_res = jnp.where(any_wants, next_target_ids[first], 0)

    # --- phase 2: complete the pending transaction ---
    req_match = slot_used & (p.radio_ids == s.requester_id)
    res_match = slot_used & (p.radio_ids == s.responder_id)
    have_both = jnp.any(req_match) & jnp.any(res_match)
    req_pos = positions[jnp.argmax(req_match)]
    res_pos = positions[jnp.argmax(res_match)]

    key, k1, k2, k3, k4 = jax.random.split(s.key, 5)
    is_outlier = jax.random.uniform(k1) < p.outlier_prob
    outlier_range = jax.random.normal(k2) * p.outlier_std
    true_range = jnp.linalg.norm(req_pos - res_pos)
    noisy_range = true_range + jax.random.normal(k3) * p.noise_std
    meas_range = jnp.where(is_outlier, outlier_range, noisy_range)

    # out-of-range radios never hear each other: the transaction times out
    # silently (no broadcast), so downstream timeout panics can fire
    in_range = true_range <= p.max_range
    # in-range transactions can still be reported failed (NLOS, interference)
    failed = jax.random.uniform(k4) < p.failure_prob

    complete = due & s.pending & have_both & in_range
    finish = due & s.pending  # transaction cleared even if a party vanished
    latch = due & ~s.pending  # latch attempt (resets the period timer)

    meas = UwbMeasurement(
        valid=complete,
        range=jnp.where(complete & ~failed, meas_range, 0.0).astype(jnp.float32),
        responder_id=jnp.where(complete, s.responder_id, 0).astype(jnp.int32),
        requester_id=jnp.where(complete, s.requester_id, 0).astype(jnp.int32),
        failure=complete & failed,
    )

    # NB: completing a transaction does NOT reset the period timer in the
    # reference (UWBNetwork.cpp:49-90 falls through without Reset), so the
    # next tick immediately latches the next pair; only the latch branch
    # resets it. Transactions therefore complete once per period.
    new_state = UwbState(
        acc_us=jnp.where(latch, jnp.int32(0), acc),
        pending=jnp.where(latch, any_wants, jnp.where(finish, jnp.bool_(False), s.pending)),
        requester_id=jnp.where(latch, latch_req, jnp.where(finish, 0, s.requester_id)).astype(jnp.int32),
        responder_id=jnp.where(latch, latch_res, jnp.where(finish, 0, s.responder_id)).astype(jnp.int32),
        key=key,
    )
    return new_state, meas
