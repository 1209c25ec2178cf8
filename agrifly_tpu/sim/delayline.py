"""Fixed-size FIFO modeling radio transport latency inside the jitted loop.

Replaces the reference's std::queue-based CommunicationsDelay
(Components/Components/Simulation/CommunicationsDelay.hpp:10-52) with a ring
buffer of static capacity: messages become visible `delay` after being
pushed. Delivery uses strict '>' on (now - send)*dt so a command pushed at
step j is consumed by the onboard logic at step j + delay/dt + 1, matching
the reference's end-of-iteration delivery + next-iteration consumption.

All slot addressing is done with one-hot masks and masked reductions
instead of dynamic gather/scatter: under vmap over thousands of envs,
per-row dynamic indices lower to scatter/gather ops, while the one-hot form
stays plain elementwise work over a (CAPACITY,) axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


CAPACITY = 32


class RadioRing(NamedTuple):
    types: jnp.ndarray  # (K,) int32
    flags: jnp.ndarray  # (K,) int32
    fields: jnp.ndarray  # (K, 10) int32
    send_step: jnp.ndarray  # (K,) int32
    head: jnp.ndarray  # int32
    count: jnp.ndarray  # int32


def init() -> RadioRing:
    return RadioRing(
        types=jnp.zeros(CAPACITY, jnp.int32),
        flags=jnp.zeros(CAPACITY, jnp.int32),
        fields=jnp.zeros((CAPACITY, 10), jnp.int32),
        send_step=jnp.zeros(CAPACITY, jnp.int32),
        head=jnp.int32(0),
        count=jnp.int32(0),
    )


def _onehot(idx):
    return jnp.arange(CAPACITY, dtype=jnp.int32) == idx


def _col(mask):
    """mask[:, None] as an int round-trip (value-identical)."""
    return mask.astype(jnp.int32)[:, None] != 0


def push(ring: RadioRing, msg_type, msg_flags, msg_fields, step, do_push):
    """Append a message (dropped silently if full, like a saturated radio)."""
    slot = (ring.head + ring.count) % CAPACITY
    can = do_push & (ring.count < CAPACITY)
    # int delta-blends `old + mask*(new-old)` (bit-exact for ints): a
    # gather/scatter-free slot write
    si = _onehot(slot).astype(jnp.int32) * jnp.asarray(can).astype(jnp.int32)
    types = ring.types + si * (msg_type - ring.types)
    flags = ring.flags + si * (msg_flags - ring.flags)
    fields = ring.fields + si[:, None] * (msg_fields[None, :] - ring.fields)
    send_step = ring.send_step + si * (step - ring.send_step)
    return ring._replace(
        types=types, flags=flags, fields=fields, send_step=send_step,
        count=ring.count + can.astype(jnp.int32),
    )


def pop_due(ring: RadioRing, step, dt_us, delay_us):
    """Pop the front message if its transport delay has elapsed.

    Returns (ring, delivered: bool, type, flags, fields).
    """
    has = ring.count > 0
    front = _onehot(ring.head)  # (K,)
    front_send = jnp.where(front, ring.send_step, 0).sum(dtype=jnp.int32)
    age_us = (step - front_send) * dt_us
    due = has & (age_us > delay_us)
    mtype = jnp.where(front, ring.types, 0).sum(dtype=jnp.int32)
    mflags = jnp.where(front, ring.flags, 0).sum(dtype=jnp.int32)
    mfields = jnp.where(_col(front), ring.fields, 0).sum(axis=0, dtype=jnp.int32)
    new_ring = ring._replace(
        head=jnp.where(due, (ring.head + 1) % CAPACITY, ring.head),
        count=jnp.where(due, ring.count - 1, ring.count),
    )
    return new_ring, due, mtype, mflags, mfields
