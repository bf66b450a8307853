"""Mid-fit checkpoint/resume for long-running calibrations.

The reference has NO mid-fit persistence (SURVEY.md §5): endpoint-only
writes of model/resid/gains files. Full-array fits (350 ants x 1536
channels x many times) run for hours, so this framework checkpoints the
complete optimizer state — (params, opt_state, step, best-so-far, loss
history) — between jit-compiled segments of the descent, using orbax (JAX's
checkpoint library) when it is installed, with a numpy fallback.

Checkpoints are written per (pol, time) fit under
``{dir}/poltime_{tag}/step_{n}``; resuming an interrupted run restores the
latest step and continues the while_loop exactly where it stopped.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, NamedTuple

import jax
import numpy as np


class FitCheckpoint(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    prev_loss: float
    best_loss: float
    best_params: Any
    history: np.ndarray  # losses recorded so far (host array)


def _leaf_paths(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def save_state(path, tree_state: dict, scalar_state: dict):
    """Persist a {name: pytree} dict + a {name: scalar/ndarray} dict.

    Uses orbax (JAX's checkpoint library) when importable,
    numpy+pickle otherwise. Writes atomically: the state goes to a ``.tmp``
    sibling first and is os.rename'd over the final name only after a
    complete save, so a crash mid-save never leaves a
    present-but-unloadable step directory for latest_checkpoint to prefer
    (a rerun into an existing checkpoint_dir lands on the same step paths,
    and resuming from a half-written one would either raise or silently
    restore old-run state)."""
    import shutil

    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save(
            os.path.join(tmp, "orbax"),
            {**tree_state, **{k: np.asarray(v) for k, v in scalar_state.items()}},
        )
        ckptr.wait_until_finished()
    except ImportError:
        os.makedirs(tmp, exist_ok=True)
        leaves, treedef = _leaf_paths(tree_state)
        np.savez(
            os.path.join(tmp, "state.npz"),
            **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)},
            **{k: np.asarray(v) for k, v in scalar_state.items()},
        )
        with open(os.path.join(tmp, "treedef.pkl"), "wb") as f:
            pickle.dump(treedef, f)
    # tmp now holds a complete checkpoint; swap it in. The only non-atomic
    # window (old removed, new still at .tmp) degrades to resuming from the
    # previous step — latest_checkpoint never sees a partial save because
    # "step_N.tmp" fails its int() parse.
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_state(path, like_tree: dict, scalar_names):
    """Restore a save_state checkpoint.

    ``like_tree`` provides the pytree structure/dtypes for the tree part;
    ``scalar_names`` lists the scalar/ndarray entries to return (as numpy).
    Returns (tree_state, scalar_state)."""
    import jax.numpy as jnp

    orbax_path = os.path.abspath(os.path.join(path, "orbax"))
    if os.path.isdir(orbax_path):
        import warnings

        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # untargeted restore: array shapes (e.g. history length) vary
            # between checkpoints, so a typed target cannot be provided;
            # structure is re-validated against ``like_tree`` below
            restored = ckptr.restore(orbax_path)

        def into(like_sub, restored_sub, name):
            # orbax restores tuples as lists; re-unflatten into the
            # caller's structure and dtypes
            leaves = jax.tree_util.tree_leaves(restored_sub)
            like_leaves, treedef = jax.tree_util.tree_flatten(like_sub)
            if len(leaves) != len(like_leaves):
                raise ValueError(
                    f"checkpoint {name} does not match the current fit structure"
                )
            leaves = [
                jnp.asarray(leaf, dtype=ref.dtype)
                for leaf, ref in zip(leaves, like_leaves)
            ]
            return jax.tree_util.tree_unflatten(treedef, leaves)

        tree_state = {
            name: into(like_sub, restored[name], name)
            for name, like_sub in like_tree.items()
        }
        scalar_state = {name: np.asarray(restored[name]) for name in scalar_names}
        return tree_state, scalar_state
    data = np.load(os.path.join(path, "state.npz"), allow_pickle=False)
    with open(os.path.join(path, "treedef.pkl"), "rb") as f:
        treedef = pickle.load(f)
    n = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    like_leaves, like_treedef = _leaf_paths(like_tree)
    if like_treedef != treedef:
        raise ValueError("checkpoint structure does not match the current fit")
    leaves = [
        jnp.asarray(leaf, dtype=ref.dtype) for leaf, ref in zip(leaves, like_leaves)
    ]
    tree_state = jax.tree_util.tree_unflatten(treedef, leaves)
    scalar_state = {name: np.asarray(data[name]) for name in scalar_names}
    return tree_state, scalar_state


def save_checkpoint(path, ckpt: FitCheckpoint):
    """Persist a FitCheckpoint (see save_state for atomicity/backends)."""
    save_state(
        path,
        {
            "params": ckpt.params,
            "opt_state": ckpt.opt_state,
            "best_params": ckpt.best_params,
        },
        {
            "step": int(ckpt.step),
            "prev_loss": float(ckpt.prev_loss),
            "best_loss": float(ckpt.best_loss),
            "history": np.asarray(ckpt.history, dtype=np.float64),
        },
    )


def load_checkpoint(path, like: FitCheckpoint) -> FitCheckpoint:
    """Restore a FitCheckpoint saved by save_checkpoint.

    ``like`` provides the pytree structure/dtypes to restore into."""
    tree_state, scalar_state = load_state(
        path,
        {
            "params": like.params,
            "opt_state": like.opt_state,
            "best_params": like.best_params,
        },
        ("step", "prev_loss", "best_loss", "history"),
    )
    return FitCheckpoint(
        params=tree_state["params"],
        opt_state=tree_state["opt_state"],
        step=int(scalar_state["step"]),
        prev_loss=float(scalar_state["prev_loss"]),
        best_loss=float(scalar_state["best_loss"]),
        best_params=tree_state["best_params"],
        history=np.asarray(scalar_state["history"], dtype=np.float64),
    )


def _checkpoint_loadable(path):
    """True when ``path`` contains a complete save (orbax dir or npz pair)."""
    if os.path.isfile(os.path.join(path, "state.npz")) and os.path.isfile(
        os.path.join(path, "treedef.pkl")
    ):
        return True
    return os.path.isdir(os.path.join(path, "orbax"))


def latest_checkpoint(directory):
    """Path of the highest-step LOADABLE checkpoint under ``directory``, or
    None. Incomplete step dirs (e.g. from a crash predating the atomic-save
    scheme) are skipped rather than returned and failed on."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    for _, name in sorted(steps, reverse=True):
        path = os.path.join(directory, name)
        if _checkpoint_loadable(path):
            return path
    return None


def save_phase_meta(directory, **arrays):
    """Atomically persist phase-boundary diagnostics (the bf16-phase loss
    history of a mixed-precision fit) as ``phase1_history.npz`` under
    ``directory``. A crash mid-save leaves the previous file intact."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, "phase1_history.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(directory, "phase1_history.npz"))


def load_phase_meta(directory):
    """The dict persisted by save_phase_meta, or None when absent (a resume
    that predates the file, or a run whose phase 1 never completed)."""
    path = os.path.join(directory, "phase1_history.npz")
    if not os.path.isfile(path):
        return None
    with np.load(path) as meta:
        return {k: np.asarray(meta[k]) for k in meta.files}
