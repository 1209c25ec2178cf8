"""Host-boundary pytree packing: ship ONE buffer per jit call, not 126.

Why this exists (no reference counterpart): every jit call pays host
dispatch per argument buffer, and the 126-leaf orchard state is 126
buffers. The state totals ~3.5 KB, so it crosses the host boundary as a
single flat buffer and unpacks/repacks INSIDE the jit, where
slices/concats are free (XLA fuses them and the buffers never touch the
host).

The packing is bit-exact: 4-byte dtypes are bitcast to uint32 (NaN
payloads and -0.0 survive), 8-byte dtypes to uint64 (x64 test mode),
bools ride as uint32 0/1. One carrier buffer per itemsize class — the
orchard state (f32/i32/bool/u32) packs to a single uint32[~880].

Usage:
    packer = Packer(example_state)           # static spec from shapes
    buf,  = packer.pack(state)               # jittable; tuple of carriers
    state = packer.unpack((buf,))            # jittable; bit-exact
    step  = packer.wrap_step(lambda s: fly(params, s, n))   # packed->packed
    step  = jax.jit(step, donate_argnums=0)  # 1-2 handles/call, donated

The reference has no analogous machinery because its simulator state
lives in one process (AIFS_ROS Simulator/main.cpp keeps everything in
C++ objects); here the host<->device boundary is the wire we optimize.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# carrier dtype per itemsize class; bools are converted to uint32 first
_CARRIERS = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32, 8: jnp.uint64}


class _LeafSpec(NamedTuple):
    shape: tuple
    dtype: object        # numpy dtype of the original leaf
    itemsize: int        # carrier class (bool -> 4)
    offset: int          # element offset inside the carrier buffer
    size: int            # element count


class Packer:
    """Static pack/unpack spec for one pytree structure.

    Built from an example tree (concrete or ShapeDtypeStruct leaves); pack
    and unpack are pure jnp functions safe to call inside jit. Leaves must
    have the example's exact shapes/dtypes — the spec is static.
    """

    def __init__(self, example_tree):
        leaves, self.treedef = jax.tree_util.tree_flatten(example_tree)
        self.specs = []
        self.group_sizes = {}  # itemsize -> total elements
        for leaf in leaves:
            dt = np.dtype(leaf.dtype)
            itemsize = 4 if dt == np.bool_ else dt.itemsize
            if itemsize not in _CARRIERS:
                raise TypeError(f"unsupported leaf dtype {dt}")
            off = self.group_sizes.get(itemsize, 0)
            size = int(np.prod(leaf.shape, dtype=np.int64))
            self.specs.append(_LeafSpec(tuple(leaf.shape), dt, itemsize,
                                        off, size))
            self.group_sizes[itemsize] = off + size
        # stable carrier order: ascending itemsize of the groups present
        self.group_order = sorted(self.group_sizes)

    @property
    def n_buffers(self) -> int:
        return len(self.group_order)

    def abstract_buffers(self):
        """ShapeDtypeStructs of the packed representation."""
        return tuple(
            jax.ShapeDtypeStruct((self.group_sizes[g],), _CARRIERS[g])
            for g in self.group_order)

    def pack(self, tree):
        """tree -> tuple of flat carrier buffers (one per itemsize class)."""
        leaves = jax.tree_util.tree_leaves(tree)
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"tree has {len(leaves)} leaves, spec has {len(self.specs)}")
        groups = {g: [] for g in self.group_order}
        for leaf, spec in zip(leaves, self.specs):
            carrier = _CARRIERS[spec.itemsize]
            x = jnp.asarray(leaf)
            if x.dtype == jnp.bool_:
                flat = x.reshape(-1).astype(carrier)
            elif x.dtype == carrier:
                flat = x.reshape(-1)
            else:
                flat = jax.lax.bitcast_convert_type(
                    x, carrier).reshape(-1)
            groups[spec.itemsize].append(flat)
        return tuple(
            jnp.concatenate(groups[g]) if len(groups[g]) > 1 else groups[g][0]
            for g in self.group_order)

    def unpack(self, buffers):
        """tuple of carrier buffers -> tree, bit-exact vs the original."""
        if len(buffers) != len(self.group_order):
            raise ValueError(
                f"got {len(buffers)} buffers, expected {len(self.group_order)}")
        bufs = dict(zip(self.group_order, buffers))
        leaves = []
        for spec in self.specs:
            flat = jax.lax.slice_in_dim(bufs[spec.itemsize], spec.offset,
                                        spec.offset + spec.size)
            if spec.dtype == np.bool_:
                leaf = (flat != 0).reshape(spec.shape)
            elif spec.dtype == _CARRIERS[spec.itemsize]:
                leaf = flat.reshape(spec.shape)
            else:
                leaf = jax.lax.bitcast_convert_type(
                    flat, jnp.dtype(spec.dtype)).reshape(spec.shape)
            leaves.append(leaf)
        return jax.tree_util.tree_unflatten(self.treedef, leaves)

    def unpack_np(self, buffers):
        """Host-side unpack: numpy carrier buffers -> tree of numpy VIEWS
        (zero-copy reinterpret; bools materialize). One np.asarray(buf)
        device read gives the whole state — per-leaf device_get costs a
        device read per leaf."""
        if len(buffers) != len(self.group_order):
            raise ValueError(
                f"got {len(buffers)} buffers, expected {len(self.group_order)}")
        bufs = {g: np.asarray(b) for g, b in zip(self.group_order, buffers)}
        leaves = []
        for spec in self.specs:
            flat = bufs[spec.itemsize][spec.offset:spec.offset + spec.size]
            if spec.dtype == np.bool_:
                leaf = (flat != 0).reshape(spec.shape)
            else:
                leaf = flat.view(spec.dtype).reshape(spec.shape)
            leaves.append(leaf)
        return jax.tree_util.tree_unflatten(self.treedef, leaves)

    def wrap_step(self, fn):
        """Lift `state -> state` (or `state -> (state, aux)`) to operate on
        packed buffers: `(*bufs) -> (*bufs)` or `(*bufs) -> ((*bufs), aux)`.
        jit the result with donate_argnums=tuple(range(n_buffers)) for a
        zero-copy on-device carry."""

        def packed_fn(*bufs):
            out = fn(self.unpack(bufs))
            if isinstance(out, tuple) and len(out) == 2:
                new_state, aux = out
                return self.pack(new_state), aux
            return self.pack(out)

        return packed_fn
