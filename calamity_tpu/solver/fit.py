"""The optimization hot loop: jit-compiled gradient descent with on-device
convergence checks.

Reference parity: fit_gains_and_foregrounds (calibration.py:447-738) — same
semantics (one warm-up step, per-step loss history, |delta loss| < tol early
stop, optional use_min argmin tracking, freeze_model gain-only mode, "sum"
regularization) — but redesigned for accelerators:

- The ENTIRE loop runs inside one jit as a lax.while_loop; the tolerance
  check happens on device. The reference fetches loss.numpy() every step
  (calibration.py:701), a host sync per step that dominates small-step
  latency on accelerators; here the host syncs once, after convergence.
- The loss history is recorded into a preallocated (maxsteps,) device
  buffer, preserving the reference's fit_history contract without host
  traffic.
- graph compilation is the default (jit), not an opt-in flag; the
  reference's graph_mode toggle (calibration.py:670-679) is accepted by the
  high-level API for signature parity and ignored.
"""

from __future__ import annotations

import datetime
from functools import partial
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ops.loss import chunked_loss, chunked_loss_sum_regularized
from ..utils import echo
from .optimizers import get_optimizer


class FitConfig(NamedTuple):
    """Hashable static configuration for one compiled fit."""

    optimizer: str = "Adamax"
    opt_kwargs: Tuple[Tuple[str, Any], ...] = ()
    maxsteps: int = 10000
    tol: float = 1e-14
    use_min: bool = False
    freeze_model: bool = False
    regularization: Optional[str] = None
    remat: bool = False
    # stop (or freeze a batched slice) when the loss has not reached a new
    # minimum for this many recorded steps; 0 disables. The |delta loss| <
    # tol stop never triggers on an OSCILLATING plateau (Adam-family
    # momentum orbits the minimum: measured on a 10%-gain-error fit, the
    # argmin landed at step 3212 and the next 21,788 steps oscillated
    # 10-50x above it — docs/DESIGN.md "Patience stopping"); patience
    # bounds that waste. Combine with use_min so the returned state is the
    # tracked argmin rather than wherever the oscillation happened to be.
    patience: int = 0
    # evaluate batched losses as a scan over group blocks of this size:
    # bounds the activation HBM peak for many-poltime full-array fits
    # (parallel.batched._blocked_chunk_losses); None = single evaluation
    loss_block: Optional[int] = None
    # group blocks additionally align to multiples of this (the mesh 'bl'
    # shard count on sharded runs, so every scanned block slices on shard
    # boundaries instead of forcing the partitioner to regather the cubes)
    loss_block_unit: int = 1


class FitResult(NamedTuple):
    g_r: Any
    g_i: Any
    fg_r: Any  # tuple per chunk (ngrps, nvecs)
    fg_i: Any
    loss_history: Any  # (maxsteps,), nan past nsteps
    nsteps: Any  # scalar int
    final_loss: Any  # scalar


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def convert_chunks_dtype(chunks, dtype):
    """Chunk triples with comps cast to ``dtype`` (antenna indices untouched).

    Used by the ``comps_precision`` descent modes: the step is bound by
    reading the basis tensors from HBM, so a bfloat16 copy of comps halves
    the dominant traffic (see docs/BF16_COMPS.md). The cast is done once
    here, outside the compiled fit."""
    return tuple((comps.astype(dtype), a0, a1) for comps, a0, a1 in chunks)


def _fit_core(cfg: FitConfig, chunks, data_r, data_i, wgts, g_r, g_i, fg_r, fg_i,
              prior_r_sum, prior_i_sum):
    """One full fit: a warm-up step followed by a single maxsteps segment.

    Thin composition over _fit_segment (which owns the loss construction,
    while_loop, tol/divergence stops and use_min bookkeeping) — the same
    composition _fit_checkpointed uses, so the three fit paths share one
    loop implementation. Semantics match the reference
    fit_gains_and_foregrounds (calibration.py:447-738): the warm-up step
    is unrecorded (calibration.py:693) and the first recorded step cannot
    trigger the tolerance stop."""
    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    dtype = g_r.dtype
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
    params = (g_r, g_i) if cfg.freeze_model else (g_r, g_i, fg_r, fg_i)
    opt_state = opt.init(params)
    params, opt_state, _, _, _, _, _, _, _ = _fit_segment(
        cfg, 1, chunks, data_r, data_i, wgts, fg_r, fg_i,
        prior_r_sum, prior_i_sum, params, opt_state, big, big, params,
    )
    params, opt_state, prev, best_loss, best_params, history, step, _, _ = (
        _fit_segment(
            cfg, cfg.maxsteps, chunks, data_r, data_i, wgts, fg_r, fg_i,
            prior_r_sum, prior_i_sum, params, opt_state, big, big, params,
        )
    )
    out_params = best_params if cfg.use_min else params
    final_loss = best_loss if cfg.use_min else prev
    if cfg.freeze_model:
        g_r_o, g_i_o = out_params
        fg_r_o, fg_i_o = fg_r, fg_i
    else:
        g_r_o, g_i_o, fg_r_o, fg_i_o = out_params
    return FitResult(g_r_o, g_i_o, fg_r_o, fg_i_o, history, step, final_loss)


@partial(jax.jit, static_argnums=(0, 1))
def _fit_segment(cfg: FitConfig, seg_len, chunks, data_r, data_i, wgts, fg_r_const,
                 fg_i_const, prior_r_sum, prior_i_sum, params, opt_state, prev_loss,
                 best_loss, best_params, since_best=0):
    """Run up to ``seg_len`` descent steps from explicit optimizer state.

    The checkpointable variant of _fit_core: state comes in and goes out so
    the host can persist it between segments (solver.checkpoint).

    ``since_best``: recorded steps since the last new loss minimum on
    entry (checkpointed resumes reconstruct it from the stored history);
    only read when cfg.patience > 0."""
    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    dtype = prev_loss.dtype

    if cfg.freeze_model:
        def loss_fn(p):
            gr, gi = p
            if cfg.regularization == "sum":
                return chunked_loss_sum_regularized(
                    gr, gi, fg_r_const, fg_i_const, chunks, data_r, data_i, wgts,
                    prior_r_sum, prior_i_sum,
                )
            return chunked_loss(gr, gi, fg_r_const, fg_i_const, chunks, data_r,
                                data_i, wgts, remat=cfg.remat)
    else:
        def loss_fn(p):
            gr, gi, fr, fi = p
            if cfg.regularization == "sum":
                return chunked_loss_sum_regularized(
                    gr, gi, fr, fi, chunks, data_r, data_i, wgts,
                    prior_r_sum, prior_i_sum,
                )
            return chunked_loss(gr, gi, fr, fi, chunks, data_r, data_i, wgts,
                                remat=cfg.remat)

    vg = jax.value_and_grad(loss_fn)
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
    history0 = jnp.full((seg_len,), jnp.nan, dtype=dtype)
    state0 = (jnp.asarray(0, jnp.int32), params, opt_state, prev_loss, big,
              best_loss, best_params, history0,
              jnp.asarray(since_best, jnp.int32))

    def cond(state):
        step, _, _, prev_loss, delta, _, _, _, since = state
        ok = jnp.logical_and(step < seg_len, delta >= cfg.tol)
        if cfg.patience > 0:
            ok = jnp.logical_and(ok, since < cfg.patience)
        return jnp.logical_and(ok, jnp.isfinite(prev_loss))

    def body(state):
        (step, params, opt_state, prev, _, best_loss, best_params, history,
         since) = state
        loss, grads = vg(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        history = history.at[step].set(loss.astype(dtype))
        delta = jnp.where(prev < big, jnp.abs(loss - prev), big)
        is_best = loss < best_loss
        best_loss = jnp.minimum(loss, best_loss)
        best_params = _tree_where(is_best, new_params, best_params)
        since = jnp.where(is_best, 0, since + 1)
        return (step + 1, new_params, opt_state, loss, delta, best_loss,
                best_params, history, since)

    (step, params, opt_state, prev, delta, best_loss, best_params, history,
     since_best) = jax.lax.while_loop(cond, body, state0)
    converged = delta < cfg.tol
    if cfg.patience > 0:
        # gate on a finite final loss: since_best also increments on a
        # NaN/inf step (NaN < best is False), and a divergence that lands
        # exactly on the patience boundary must surface as a divergence,
        # not a convergence (the batched path masks this the same way)
        converged = jnp.logical_or(
            converged,
            jnp.logical_and(since_best >= cfg.patience, jnp.isfinite(prev)),
        )
    return (params, opt_state, prev, best_loss, best_params, history, step,
            converged, since_best)


def _fit_checkpointed(cfg, chunks, data_r, data_i, wgts, g_r, g_i, fg_r, fg_i,
                      prior_r_sum, prior_i_sum, checkpoint_dir, checkpoint_every,
                      resume, verbose):
    """Segmented descent with host-side checkpointing between segments
    (solver.checkpoint). Semantics match _fit_core; the loop is cut into
    jit-compiled segments of ``checkpoint_every`` steps."""
    import os

    from .checkpoint import (
        FitCheckpoint,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    dtype = g_r.dtype
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
    if cfg.freeze_model:
        params = (g_r, g_i)
        fg_r_const, fg_i_const = fg_r, fg_i
    else:
        params = (g_r, g_i, fg_r, fg_i)
        fg_r_const, fg_i_const = fg_r, fg_i
    opt_state = opt.init(params)
    prev_loss = big
    best_loss = big
    best_params = params
    history_all = np.zeros((0,), dtype=np.float64)
    step_total = 0

    seg = max(1, min(checkpoint_every, cfg.maxsteps))
    like = FitCheckpoint(params, opt_state, 0, float(big), float(big), best_params,
                         history_all)
    ckpt_path = latest_checkpoint(checkpoint_dir)
    if resume and ckpt_path is not None:
        echo(f"{datetime.datetime.now()} Resuming from {ckpt_path}", verbose=verbose)
        ck = load_checkpoint(ckpt_path, like)
        params, opt_state = ck.params, ck.opt_state
        best_params = ck.best_params
        prev_loss = jnp.asarray(ck.prev_loss, dtype=dtype)
        best_loss = jnp.asarray(ck.best_loss, dtype=dtype)
        history_all = ck.history
        step_total = ck.step
        # reconstruct steps-since-best from the stored history (first
        # occurrence of the running minimum) — keeps the checkpoint format
        # unchanged while making patience stops resume-exact. int32 ARRAY,
        # not a Python int: a weak-typed scalar would give _fit_segment a
        # second trace signature (minutes of XLA wall-clock at full scale)
        since_best = jnp.asarray(
            len(history_all) - 1 - int(np.argmin(history_all))
            if len(history_all)
            else 0,
            jnp.int32,
        )
    else:
        # warm-up step (parity with _fit_core / reference calibration.py:693)
        params, opt_state, _, best_loss, best_params, _, _, _, _ = _fit_segment(
            cfg, 1, chunks, data_r, data_i, wgts, fg_r_const, fg_i_const,
            prior_r_sum, prior_i_sum, params, opt_state, big, best_loss, best_params,
        )
        prev_loss = big  # first recorded step cannot trigger the tol stop
        best_loss = big
        best_params = params
        since_best = jnp.asarray(0, jnp.int32)  # same aval as the resume path

    converged = False
    while step_total < cfg.maxsteps and not converged:
        seg_len = min(seg, cfg.maxsteps - step_total)
        (params, opt_state, prev_loss, best_loss, best_params, hist_seg,
         nsteps_seg, conv, since_best) = _fit_segment(
            cfg, seg_len, chunks, data_r, data_i, wgts, fg_r_const, fg_i_const,
            prior_r_sum, prior_i_sum, params, opt_state, prev_loss, best_loss,
            best_params, since_best,
        )
        nsteps_seg = int(nsteps_seg)
        converged = bool(conv)
        if nsteps_seg == 0 and converged:
            # resume with the stop condition already satisfied on entry
            # (e.g. patience exhausted in the stored history): nothing to
            # record, nothing to re-checkpoint
            break
        if nsteps_seg == 0:
            # divergence watchdog (parity with _fit_core's cond): a segment
            # that takes zero steps means prev_loss is non-finite on entry;
            # looping again would rewrite the same checkpoint forever
            echo(
                f"{datetime.datetime.now()} Divergence detected at step "
                f"{step_total} (non-finite loss); stopping.",
                verbose=verbose,
            )
            break
        history_all = np.concatenate(
            [history_all, np.asarray(hist_seg[:nsteps_seg], dtype=np.float64)]
        )
        step_total += nsteps_seg
        save_checkpoint(
            os.path.join(checkpoint_dir, f"step_{step_total}"),
            FitCheckpoint(params, opt_state, step_total, float(prev_loss),
                          float(best_loss), best_params, history_all),
        )
        echo(
            f"{datetime.datetime.now()} checkpointed at step {step_total} "
            f"(loss {float(prev_loss):.3e})",
            verbose=verbose,
        )

    out_params = best_params if cfg.use_min else params
    final_loss = best_loss if cfg.use_min else prev_loss
    if cfg.freeze_model:
        g_r_o, g_i_o = out_params
        fg_r_o, fg_i_o = fg_r, fg_i
    else:
        g_r_o, g_i_o, fg_r_o, fg_i_o = out_params
    full_hist = np.full((max(cfg.maxsteps, len(history_all)),), np.nan)
    full_hist[: len(history_all)] = history_all
    return FitResult(g_r_o, g_i_o, fg_r_o, fg_i_o, jnp.asarray(full_hist),
                     jnp.asarray(len(history_all)), final_loss)


def fit_gains_and_foregrounds(
    g_r,
    g_i,
    fg_r,
    fg_i,
    data_r,
    data_i,
    wgts,
    chunks,
    use_min=False,
    tol=1e-14,
    maxsteps=10000,
    optimizer="Adamax",
    freeze_model=False,
    verbose=False,
    sky_model_r=None,
    sky_model_i=None,
    model_regularization=None,
    n_profile_steps=0,
    profile_log_dir="./logdir",
    checkpoint_dir=None,
    checkpoint_every=1000,
    resume=True,
    remat=False,
    comps_precision="float32",
    patience=0,
    **opt_kwargs,
):
    """Run the gradient-descent fit for one (time, pol) slice.

    Reference-compatible entry point (calibration.py:447-738). Inputs are
    chunk tuples as produced by FitSpec; returns
    (g_r, g_i, fg_r, fg_i, fit_history) with fit_history = {"loss": list}.

    comps_precision: storage precision of the basis tensors DURING the
    descent (all accumulation stays in the data dtype):
      - "float32": use the chunks as packed (default).
      - "bfloat16": descend against a bf16 copy of comps — ~1.7x faster
        steps at scale, but the convergence floor is set by the bf16
        quantization of the basis (relative residual ~4e-3; see
        docs/BF16_COMPS.md).
      - "mixed": descend bf16 until the tol stop triggers at the bf16
        floor, then continue in float32 from the warm start until tol —
        full f32 floor at a fraction of the f32 step count. Each phase is
        bounded by ``maxsteps``.
    """
    if model_regularization == "sum":
        # upcast bf16-stored weights: the prior is an accumulated scalar,
        # and the product below would otherwise sum at reduced precision
        wgts_f = [
            w.astype(sky_model_r[0].dtype) if w.dtype != sky_model_r[0].dtype else w
            for w in wgts
        ]
        prior_r_sum = sum(jnp.sum(smr * w) for smr, w in zip(sky_model_r, wgts_f))
        prior_i_sum = sum(jnp.sum(smi * w) for smi, w in zip(sky_model_i, wgts_f))
        regularization = "sum"
    else:
        prior_r_sum = jnp.zeros((), dtype=g_r.dtype)
        prior_i_sum = jnp.zeros((), dtype=g_r.dtype)
        regularization = None

    cfg = FitConfig(
        optimizer=optimizer,
        opt_kwargs=tuple(sorted(opt_kwargs.items())),
        maxsteps=int(maxsteps),
        tol=float(tol),
        use_min=bool(use_min),
        freeze_model=bool(freeze_model),
        regularization=regularization,
        remat=bool(remat),
        patience=int(patience),
    )

    fg_r = tuple(fg_r)
    fg_i = tuple(fg_i)
    data_r = tuple(data_r)
    data_i = tuple(data_i)
    wgts = tuple(wgts)

    if comps_precision not in ("float32", "bfloat16", "mixed"):
        raise ValueError(
            f"comps_precision must be 'float32', 'bfloat16' or 'mixed', "
            f"got {comps_precision!r}"
        )
    chunks_lo = None
    if comps_precision in ("bfloat16", "mixed"):
        chunks_lo = convert_chunks_dtype(chunks, jnp.bfloat16)

    echo(
        f"{datetime.datetime.now()} Building/reusing compiled fit "
        f"({cfg.optimizer}, maxsteps={cfg.maxsteps}, "
        f"comps_precision={comps_precision})...",
        verbose=verbose,
    )

    def run(chs, gr0, gi0, fr0, fi0, ckdir):
        if ckdir is not None:
            return _fit_checkpointed(
                cfg, chs, data_r, data_i, wgts, gr0, gi0, fr0, fi0,
                prior_r_sum, prior_i_sum, ckdir, int(checkpoint_every),
                resume, verbose,
            )
        return _fit_core(
            cfg, chs, data_r, data_i, wgts, gr0, gi0, fr0, fi0,
            prior_r_sum, prior_i_sum,
        )

    if n_profile_steps > 0:
        # opt-in profiler trace around a short profiling run (reference
        # parity: tf.profiler usage at calibration.py:681-687)
        import os

        os.makedirs(profile_log_dir, exist_ok=True)
        jax.profiler.start_trace(profile_log_dir)
        prof_cfg = cfg._replace(maxsteps=int(n_profile_steps), tol=0.0, patience=0)
        res = _fit_core(
            prof_cfg, chunks_lo if comps_precision == "bfloat16" else chunks,
            data_r, data_i, wgts, g_r, g_i, fg_r, fg_i,
            prior_r_sum, prior_i_sum,
        )
        jax.block_until_ready(res.final_loss)
        jax.profiler.stop_trace()

    phase_steps = None
    if comps_precision == "bfloat16":
        result = run(chunks_lo, g_r, g_i, fg_r, fg_i, checkpoint_dir)
        nsteps = int(result.nsteps)
        history = np.asarray(result.loss_history[:nsteps], dtype=np.float64)
    elif comps_precision == "mixed" and checkpoint_dir is not None:
        import os

        # checkpointed mixed: each phase is its own checkpointed descent
        # (optimizer state resets at the phase boundary — the checkpoint
        # files only carry one phase's state)
        from .checkpoint import latest_checkpoint, load_phase_meta, save_phase_meta

        ck1 = os.path.join(checkpoint_dir, "phase_bf16")
        ck2 = os.path.join(checkpoint_dir, "phase_f32")
        # phase 2 already under way from a previous run: phase-1 output
        # is baked into its checkpoints, don't redo the bf16 descent
        skip1 = resume and latest_checkpoint(ck2) is not None
        if skip1:
            # restore the bf16-phase diagnostics persisted below so a
            # resumed run reports the same phase_steps / loss history as an
            # uninterrupted one
            meta = load_phase_meta(checkpoint_dir)
            if meta is not None:
                n1 = int(meta["nsteps"])
                hist1 = np.asarray(meta["history"], dtype=np.float64)
            else:
                n1 = 0
                hist1 = np.zeros((0,), dtype=np.float64)
            gr1, gi1, fr1, fi1 = g_r, g_i, fg_r, fg_i
        else:
            res1 = run(chunks_lo, g_r, g_i, fg_r, fg_i, ck1)
            n1 = int(res1.nsteps)
            hist1 = np.asarray(res1.loss_history[:n1], dtype=np.float64)
            gr1, gi1, fr1, fi1 = res1.g_r, res1.g_i, res1.fg_r, res1.fg_i
            save_phase_meta(checkpoint_dir, nsteps=n1, history=hist1)
            echo(
                f"{datetime.datetime.now()} bf16 phase converged after {n1} "
                f"steps; polishing in float32...",
                verbose=verbose,
            )
        result = run(chunks, gr1, gi1, fr1, fi1, ck2)
        n2 = int(result.nsteps)
        nsteps = n1 + n2
        history = np.concatenate(
            [hist1, np.asarray(result.loss_history[:n2], dtype=np.float64)]
        )
        phase_steps = [n1, n2]
    elif comps_precision == "mixed":
        # two-phase descent with CARRIED optimizer state: the f32 landscape
        # differs from the bf16 one only at the quantization floor, so the
        # adapted Adam-family moments remain well-scaled across the switch —
        # measured to roughly halve the f32 polish step count vs a fresh
        # optimizer (docs/BF16_COMPS.md)
        opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
        dtype = g_r.dtype
        big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
        params = (g_r, g_i) if cfg.freeze_model else (g_r, g_i, fg_r, fg_i)
        opt_state = opt.init(params)
        # warm-up step (parity with _fit_core / reference calibration.py:693)
        params, opt_state, _, _, _, _, _, _, _ = _fit_segment(
            cfg, 1, chunks_lo, data_r, data_i, wgts, fg_r, fg_i,
            prior_r_sum, prior_i_sum, params, opt_state, big, big, params,
        )
        params, opt_state, prev1, _, _, hist1, n1, _, _ = _fit_segment(
            cfg, cfg.maxsteps, chunks_lo, data_r, data_i, wgts, fg_r, fg_i,
            prior_r_sum, prior_i_sum, params, opt_state, big, big, params,
        )
        n1 = int(n1)
        echo(
            f"{datetime.datetime.now()} bf16 phase converged after {n1} "
            f"steps; polishing in float32...",
            verbose=verbose,
        )
        params, opt_state, prev2, best_loss, best_params, hist2, n2, _, _ = (
            _fit_segment(
                cfg, cfg.maxsteps, chunks, data_r, data_i, wgts, fg_r, fg_i,
                prior_r_sum, prior_i_sum, params, opt_state, big, big, params,
            )
        )
        n2 = int(n2)
        out_params = best_params if cfg.use_min else params
        final_loss = best_loss if cfg.use_min else prev2
        if cfg.freeze_model:
            g_r_o, g_i_o = out_params
            fg_r_o, fg_i_o = fg_r, fg_i
        else:
            g_r_o, g_i_o, fg_r_o, fg_i_o = out_params
        nsteps = n1 + n2
        history = np.concatenate(
            [
                np.asarray(hist1[:n1], dtype=np.float64),
                np.asarray(hist2[:n2], dtype=np.float64),
            ]
        )
        result = FitResult(
            g_r_o, g_i_o, fg_r_o, fg_i_o, jnp.asarray(history),
            jnp.asarray(nsteps), final_loss,
        )
        phase_steps = [n1, n2]
    else:
        result = run(chunks, g_r, g_i, fg_r, fg_i, checkpoint_dir)
        nsteps = int(result.nsteps)
        history = np.asarray(result.loss_history[:nsteps], dtype=np.float64)
    fit_history = {"loss": history.tolist()}
    if phase_steps is not None:
        fit_history["phase_steps"] = phase_steps
    echo(
        f"{datetime.datetime.now()} Finished gradient descent: "
        f"{nsteps} steps, final loss {float(result.final_loss):.2e}",
        verbose=verbose,
    )
    return result.g_r, result.g_i, result.fg_r, result.fg_i, fit_history
