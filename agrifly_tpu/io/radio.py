"""Radio command wire codec.

The only channel from offboard to onboard is a 23-byte packet: 1 type byte,
1 reserved, 1 flags, then 10 big-endian uint16 scaled floats
(Common/Common/DataTypes/RadioTypes.hpp:39-248). The quantization is part of
sim fidelity — the onboard controller sees the decoded (lossy) command.

Two implementations:
  * device path (jnp): commands carried as (type:int32, flags:int32,
    u16 fields:(10,) int32). `encode_field`/`decode_field` reproduce the
    uint16 scaling exactly, so the jitted loop sees the same quantization
    error as the reference without materializing byte strings.
  * host path (numpy): full 23-byte packets for the AIFS_ROS-schema bridge.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# message types (RadioTypes.hpp:17-25)
TYPE_INVALID = 0
TYPE_RESERVED = 1
TYPE_EMERGENCY_KILL = 2
TYPE_POSITION_CMD = 3
TYPE_EXTERNAL_ACC_CMD = 4
TYPE_EXTERNAL_RATES_CMD = 5
TYPE_IDLE_CMD = 6

# reserved flag bits (RadioTypes.hpp:28-37)
FLAG_CALIBRATE_MOTORS = 0x01
FLAG_DISABLE_SAFETY_CHECKS = 0x02

# field scaling limits (RadioTypes.hpp:54-61)
MAX_CMD_THRUST = 35.0
MAX_CMD_ANG_RATES = 35.0
MAX_CMD_POS = 20.0
MAX_CMD_VEL = 10.0
MAX_CMD_ACC = 30.0
MAX_DEFAULT = 1.0

NUM_FIELDS = 10
_HALF = 32768  # 2^15
_MAX = 65536

RAW_PACKET_SIZE = 23


def encode_field(val, limit):
    """float -> uint16 code, matching encodeToRadioByte (RadioTypes.hpp:75-98)."""
    val = jnp.asarray(val, jnp.float32)
    in_range = (val > -limit) & (val < limit)
    code = (val * _HALF / limit + 0.5).astype(jnp.int32) + _HALF
    hi = val >= limit  # saturate high (also NaN-safe: NaN fails all compares -> 0)
    out = jnp.where(in_range, code, jnp.where(hi, _MAX - 1, 0))
    return out.astype(jnp.int32)


def decode_field(code, limit):
    """uint16 code -> float, matching decodeFromRadioBytes (RadioTypes.hpp:100-113)."""
    return limit * (code.astype(jnp.float32) - _HALF) / float(_HALF)


def quantize(val, limit):
    """Round-trip a float through the wire quantization."""
    return decode_field(encode_field(val, limit), limit)


# per-slot limit vectors + used-slot masks: the whole 10-field packet
# encodes/decodes as ONE elementwise op (fewer fusions under vmap). Unused
# slots stay raw 0 like the reference's zero-initialized packet
# (encode_field(0) would be 32768).
_LIM_RATES = jnp.array([MAX_CMD_THRUST] + [MAX_CMD_ANG_RATES] * 9, jnp.float32)
_LIM_POS = jnp.array([MAX_CMD_POS] * 3 + [MAX_CMD_VEL] * 3
                     + [MAX_CMD_ACC] * 3 + [MAX_DEFAULT], jnp.float32)
_LIM_ACC = jnp.array([MAX_CMD_ACC] * 3 + [MAX_CMD_ANG_RATES]
                     + [MAX_DEFAULT] * 6, jnp.float32)
_USED4 = jnp.arange(NUM_FIELDS) < 4
_USED9 = jnp.arange(NUM_FIELDS) < 9


def _scal(x):
    return jnp.asarray(x, jnp.float32)


def make_rates_command(thrust, ang_vel, flags=0):
    """Device-side rates command: fields[0]=thrust, 1:4=angvel (RadioTypes.hpp:160-175)."""
    z = jnp.float32(0.0)
    vals = jnp.stack([_scal(thrust), _scal(ang_vel[0]), _scal(ang_vel[1]),
                      _scal(ang_vel[2]), z, z, z, z, z, z])
    fields = jnp.where(_USED4, encode_field(vals, _LIM_RATES), 0)
    return jnp.int32(TYPE_EXTERNAL_RATES_CMD), jnp.asarray(flags, jnp.int32), fields


def make_position_command(des_pos, des_vel, des_acc, flags=0):
    z = jnp.float32(0.0)
    vals = jnp.stack([
        _scal(des_pos[0]), _scal(des_pos[1]), _scal(des_pos[2]),
        _scal(des_vel[0]), _scal(des_vel[1]), _scal(des_vel[2]),
        _scal(des_acc[0]), _scal(des_acc[1]), _scal(des_acc[2]), z])
    fields = jnp.where(_USED9, encode_field(vals, _LIM_POS), 0)
    return jnp.int32(TYPE_POSITION_CMD), jnp.asarray(flags, jnp.int32), fields


def make_acceleration_command(acc, yaw_rate, flags=0):
    z = jnp.float32(0.0)
    vals = jnp.stack([_scal(acc[0]), _scal(acc[1]), _scal(acc[2]),
                      _scal(yaw_rate), z, z, z, z, z, z])
    fields = jnp.where(_USED4, encode_field(vals, _LIM_ACC), 0)
    return jnp.int32(TYPE_EXTERNAL_ACC_CMD), jnp.asarray(flags, jnp.int32), fields


def make_kill_command(flags=0):
    return jnp.int32(TYPE_EMERGENCY_KILL), jnp.asarray(flags, jnp.int32), jnp.zeros((NUM_FIELDS,), jnp.int32)


def make_idle_command(flags=0):
    return jnp.int32(TYPE_IDLE_CMD), jnp.asarray(flags, jnp.int32), jnp.zeros((NUM_FIELDS,), jnp.int32)


def decode_message(msg_type, fields):
    """uint16 codes -> 10 floats, per-type limits (RadioTypes.hpp:189-240).

    Works under jit for traced msg_type: computes all decodings and selects.
    """
    # one elementwise decode per message type via the per-slot limit
    # vectors (bitwise identical to the per-slice decode; no concats)
    f_pos = decode_field(fields, _LIM_POS)
    f_rates = decode_field(fields, _LIM_RATES)
    f_acc = decode_field(fields, _LIM_ACC)
    f_default = decode_field(fields, MAX_DEFAULT)
    out = jnp.where(msg_type == TYPE_POSITION_CMD, f_pos, f_default)
    out = jnp.where(msg_type == TYPE_EXTERNAL_RATES_CMD, f_rates, out)
    out = jnp.where(msg_type == TYPE_EXTERNAL_ACC_CMD, f_acc, out)
    return out


# ----------------------------------------------------------------------------
# host-side byte packets (for the ROS-schema bridge / logging)
# ----------------------------------------------------------------------------

def encode_field_np(val, limit):
    """Host-numpy encode_field (same codes, f32 math like the device)."""
    val = np.asarray(val, np.float32)
    limit = np.asarray(limit, np.float32)
    code = (val * np.float32(_HALF) / limit
            + np.float32(0.5)).astype(np.int32) + _HALF
    in_range = (val > -limit) & (val < limit)
    return np.where(in_range, code,
                    np.where(val >= limit, _MAX - 1, 0)).astype(np.int32)


def make_rates_command_np(thrust, ang_vel, flags=0):
    """Host-numpy rates command — the wire codes of make_rates_command
    without a device dispatch. The orchard topic bridge publishes the
    offboard node's 50 Hz command stream (quad_rappids_planner_controller
    → radio_command{id}) from host frame rows; a jitted encode per
    message would cost a device round trip each."""
    vals = np.array([thrust, ang_vel[0], ang_vel[1], ang_vel[2]],
                    np.float32)
    lims = np.array([MAX_CMD_THRUST] + [MAX_CMD_ANG_RATES] * 3, np.float32)
    fields = np.zeros(NUM_FIELDS, np.int32)
    fields[:4] = encode_field_np(vals, lims)
    return TYPE_EXTERNAL_RATES_CMD, int(flags), fields


def fields_to_bytes(msg_type: int, flags: int, fields: np.ndarray) -> bytes:
    """Pack into the 23-byte wire format (big-endian u16 fields)."""
    raw = np.zeros(RAW_PACKET_SIZE, np.uint8)
    raw[0] = msg_type
    raw[1] = 0
    raw[2] = flags
    f = np.asarray(fields, np.int64)
    raw[3::2] = (f >> 8) & 0xFF
    raw[4::2] = f & 0xFF
    return raw.tobytes()


def bytes_to_fields(raw: bytes):
    b = np.frombuffer(raw, np.uint8)
    msg_type, flags = int(b[0]), int(b[2])
    fields = (b[3::2].astype(np.int64) << 8) + b[4::2].astype(np.int64)
    return msg_type, flags, fields.astype(np.int32)
