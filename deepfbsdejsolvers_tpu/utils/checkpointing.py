"""Checkpoint / deterministic resume.

The reference has no checkpointing: training is restart-from-scratch and
trained weights live only in Keras objects held in Python lists
(mainMFGComparison.py:113,143 — SURVEY.md §5).  Here the full train state
``(params, opt_state, rng_key, step)`` is a pytree whose flattened leaves are
written with ``np.savez`` (no pickled objects), so any run can resume
bit-exactly: the rng key is part of the state and per-step keys are derived
by ``fold_in``, making the noise stream a pure function of (saved key, step).

The tree structure is not stored: restoring takes an ``example`` pytree of
the same structure (a fresh init) and refills its leaves.  JAX typed PRNG
keys are an extended dtype ``np.savez`` cannot store; they are converted
through ``jax.random.key_data`` on save and rewrapped on restore.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np


def _pack_keys(tree: Any) -> Any:
    """Replace typed PRNG key leaves with a serializable marker dict."""

    def pack(leaf):
        if isinstance(leaf, jax.Array) and jax.dtypes.issubdtype(
                leaf.dtype, jax.dtypes.prng_key):
            impl = str(jax.random.key_impl(leaf))
            # only arrays are stored — encode the impl name as ASCII bytes
            return {"__prng_key__": np.asarray(jax.random.key_data(leaf)),
                    "__prng_impl__": np.frombuffer(impl.encode(), np.uint8).copy()}
        return leaf

    return jax.tree_util.tree_map(pack, tree)


def _unpack_keys(tree: Any) -> Any:
    def is_marker(node):
        return isinstance(node, dict) and "__prng_key__" in node

    def unpack(node):
        if is_marker(node):
            impl_arr = node.get("__prng_impl__")
            impl = (bytes(np.asarray(impl_arr)).decode()
                    if impl_arr is not None else "threefry2x32")
            return jax.random.wrap_key_data(
                jax.numpy.asarray(node["__prng_key__"]), impl=impl)
        return node

    return jax.tree_util.tree_map(unpack, tree, is_leaf=is_marker)


_STATE_FILE = "state.npz"


def save_checkpoint(path: str, state: Any) -> None:
    """Save a pytree (params / opt_state / rng keys / python scalars) to
    ``path`` (a directory), overwriting any previous checkpoint there."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(_pack_keys(state))
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, *[np.asarray(leaf) for leaf in leaves])
    os.replace(tmp, os.path.join(path, _STATE_FILE))


def _like(saved: np.ndarray, leaf: Any) -> Any:
    """``saved`` converted to the kind of ``leaf`` (python scalar, jax array
    or numpy array) with the leaf's dtype."""
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(saved.item())
    dtype = getattr(leaf, "dtype", saved.dtype)
    if saved.dtype.kind == "V":
        # npz stores extension dtypes (bfloat16, ...) as raw bytes
        saved = saved.view(dtype)
    if isinstance(leaf, jax.Array):
        return jax.numpy.asarray(saved, dtype=dtype)
    return saved


def restore_checkpoint(path: str, example: Any) -> Any:
    """Restore a checkpoint saved by :func:`save_checkpoint`.

    ``example`` is a pytree of the same structure as the saved state (e.g. a
    fresh init); its leaves give the structure, dtypes and leaf kinds of the
    result."""
    packed = _pack_keys(example)
    leaves, treedef = jax.tree_util.tree_flatten(packed)
    with np.load(os.path.join(os.path.abspath(path), _STATE_FILE)) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(saved) != len(leaves):
        raise ValueError(
            f"checkpoint at {path} holds {len(saved)} leaves, the example "
            f"has {len(leaves)}")
    restored = [_like(s, leaf) for s, leaf in zip(saved, leaves)]
    return _unpack_keys(jax.tree_util.tree_unflatten(treedef, restored))


class CheckpointManager:
    """Keep the latest-k checkpoints under a root directory.

    Layout: ``root/step_<n>/`` per save plus a ``latest`` resolution helper.
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = os.path.abspath(root)
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                try:
                    out.append((int(name[5:]), os.path.join(self.root, name)))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, step: int, state: Any) -> str:
        path = os.path.join(self.root, f"step_{step}")
        save_checkpoint(path, state)
        # prune oldest beyond keep
        dirs = self._step_dirs()
        while len(dirs) > self.keep:
            _, victim = dirs.pop(0)
            import shutil

            shutil.rmtree(victim, ignore_errors=True)
        return path

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def restore_latest(self, example: Any):
        """Returns (step, state) of the newest checkpoint, or None."""
        step = self.latest_step()
        if step is None:
            return None
        return step, restore_checkpoint(
            os.path.join(self.root, f"step_{step}"), example)
