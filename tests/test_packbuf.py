"""Host-boundary packing (io/packbuf.py): bit-exact roundtrip + packed fly.

The packer exists to cut per-buffer host dispatch (the orchard state has
126 leaves); these tests pin its correctness on CPU —
bit-exact roundtrips (NaN payloads, -0.0, bool, mixed itemsize under x64)
and value-identical flight when the whole fly block runs packed->packed
with donated carriers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agrifly_tpu.io import packbuf
from agrifly_tpu.sim import orchard_env


def _bits(x):
    x = np.asarray(x).reshape(-1)
    if x.dtype == np.bool_:
        return x
    return x.view(np.uint8)


def assert_tree_bitexact(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for xa, xb in zip(la, lb):
        assert xa.shape == xb.shape and xa.dtype == xb.dtype
        np.testing.assert_array_equal(_bits(xa), _bits(xb))


def test_roundtrip_mixed_dtypes_bitexact():
    tree = {
        "f32": jnp.array([1.5, -0.0, np.nan, np.inf], jnp.float32),
        "nanpayload": jax.lax.bitcast_convert_type(
            jnp.uint32(0x7FC00123), jnp.float32),
        "i32": jnp.array([[-1, 2], [3, -2**31]], jnp.int32),
        "bool": jnp.array([True, False, True]),
        "u32": jnp.arange(5, dtype=jnp.uint32),
        "f64": jnp.array([1e300, -0.0], jnp.float64),
        "u8": jnp.arange(7, dtype=jnp.uint8),
        "scalar": jnp.float32(3.25),
    }
    p = packbuf.Packer(tree)
    bufs = p.pack(tree)
    assert len(bufs) == p.n_buffers == 3  # u8 / u32-class / u64-class
    assert_tree_bitexact(p.unpack(bufs), tree)
    # abstract spec matches the concrete buffers
    for buf, ab in zip(bufs, p.abstract_buffers()):
        assert buf.shape == ab.shape and buf.dtype == ab.dtype


def test_roundtrip_orchard_state_single_u32_buffer():
    params = orchard_env.make_params(width=32, height=24, n_candidates=8)
    state = orchard_env.init_state(params, jax.random.PRNGKey(0))
    p = packbuf.Packer(state)
    # the production property: the whole state crosses as ONE uint32 buffer
    assert p.n_buffers == 1
    (buf,) = p.pack(state)
    assert buf.dtype == jnp.uint32 and buf.ndim == 1
    assert_tree_bitexact(p.unpack((buf,)), state)
    # and under jit
    rt = jax.jit(lambda b: p.pack(p.unpack((b,)))[0])(buf)
    np.testing.assert_array_equal(np.asarray(rt), np.asarray(buf))


def test_packed_fly_matches_unpacked_with_donation():
    params = orchard_env.make_params(width=32, height=24, n_candidates=8)
    state = orchard_env.init_state(params, jax.random.PRNGKey(1))
    p = packbuf.Packer(state)

    n_frames = 3
    ref, _ = jax.jit(lambda s: orchard_env.fly(params, s, n_frames))(state)

    step = p.wrap_step(lambda s: orchard_env.fly(params, s, n_frames)[0])
    packed_step = jax.jit(
        lambda *b: step(*b), donate_argnums=tuple(range(p.n_buffers)))
    bufs = p.pack(state)
    out_bufs = packed_step(*bufs)
    got = p.unpack(out_bufs)
    assert_tree_bitexact(got, ref)
    # donated input must be unusable (the carry really is zero-copy)
    with pytest.raises(RuntimeError):
        np.asarray(bufs[0])


def test_wrap_step_passes_aux_through():
    params = orchard_env.make_params(width=32, height=24, n_candidates=8)
    state = orchard_env.init_state(params, jax.random.PRNGKey(2))
    p = packbuf.Packer(state)
    step = p.wrap_step(lambda s: orchard_env.fly(params, s, 2))
    bufs, outs = jax.jit(step)(*p.pack(state))
    assert outs["pos"].shape[0] == 2
    _, ref_outs = jax.jit(lambda s: orchard_env.fly(params, s, 2))(state)
    np.testing.assert_array_equal(np.asarray(outs["pos"]),
                                  np.asarray(ref_outs["pos"]))


def test_fleet_state_packs_too():
    params = orchard_env.make_params(width=32, height=24, n_candidates=8)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    state = jax.vmap(lambda k: orchard_env.init_state(params, k))(keys)
    p = packbuf.Packer(state)
    assert p.n_buffers == 1
    assert_tree_bitexact(p.unpack(p.pack(state)), state)


def test_unpack_np_matches_device_unpack():
    # the host-read path: one np.asarray per carrier, leaves are views
    tree = {
        "f32": jnp.array([1.5, -0.0, np.nan], jnp.float32),
        "i32": jnp.array([[-7, 2**31 - 1]], jnp.int32),
        "bool": jnp.array([True, False]),
        "f64": jnp.array([-1e300], jnp.float64),
    }
    p = packbuf.Packer(tree)
    bufs = p.pack(tree)
    host = p.unpack_np(tuple(np.asarray(b) for b in bufs))
    assert_tree_bitexact(host, tree)
    assert all(isinstance(x, np.ndarray)
               for x in jax.tree_util.tree_leaves(host))
    with pytest.raises(ValueError):
        p.unpack_np((np.zeros(4, np.uint32),))


def test_shape_mismatch_is_loud():
    tree = {"a": jnp.zeros((3,), jnp.float32)}
    p = packbuf.Packer(tree)
    with pytest.raises(ValueError):
        p.unpack((jnp.zeros((2,), jnp.uint32), jnp.zeros((1,), jnp.uint8)))
