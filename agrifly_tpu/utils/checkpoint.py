"""Checkpoint / resume: snapshot the whole sim as one pytree.

The reference has no checkpointing (SURVEY.md §5) — its closest artifact is
CSV logs. Because this framework keeps the entire simulation (plant,
onboard logic, estimators, radio rings, planner state, RNG keys) in one
immutable pytree, a snapshot is its leaves in one numpy .npz file.
Restoring reproduces the run bit-exactly (the PRNG key is part of the
state).
"""

from __future__ import annotations

import pathlib

import jax
import numpy as np


def _npz_path(path) -> pathlib.Path:
    path = pathlib.Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name + ".npz")


def save(path, state) -> pathlib.Path:
    """Save any state pytree as `path` (+ ".npz"); returns the file."""
    out = _npz_path(path)
    leaves = jax.tree_util.tree_leaves(state)
    np.savez_compressed(
        out, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    return out


def restore(path, template):
    """Restore into the structure of `template` (same pytree shape)."""
    npz = np.load(_npz_path(path))
    leaves, treedef = jax.tree_util.tree_flatten(template)
    new_leaves = [jax.numpy.asarray(npz[f"leaf_{i}"], dtype=leaf.dtype)
                  for i, leaf in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
