"""Batched multi-(time, pol) fitting, shardable over a device mesh.

The reference loops serially over polarizations and times on one device
(reference calibration.py:1160-1320). Fits for different (time, pol) slices
are independent, so this path batches them with a leading axis
and runs ONE jit-compiled descent for the whole batch:

    g_r/g_i : (nbatch, nants, nfreqs)
    fg_r/fg_i per chunk : (nbatch, ngrps, nvecs)
    data/wgts per chunk : (nbatch, ngrps, nbls, nfreqs)

The loss is the sum over the batch; each slice's chi-square is independent,
so the summed gradient updates every slice exactly as its own descent would
(Adam-family updates are elementwise). Convergence is tracked PER SLICE: a
slice whose |delta loss| drops below tol (or whose loss goes non-finite) is
frozen — its parameters and optimizer state stop moving, matching the
serial per-fit early-stop semantics — while unconverged slices keep
stepping until all freeze or maxsteps. The per-slice loss history and step
counts are recorded on device.

Sharded over a ('data', 'bl') mesh (parallel.mesh), this is the pjit'd
"full-array, full-band calibration as one optimization" path from
BASELINE.json's north star.
"""

from __future__ import annotations

import collections
import warnings
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ops.loss import chunked_loss, chunked_loss_sum_regularized
from ..solver.fit import FitConfig
from ..solver.optimizers import get_optimizer


def _loss_block_size(ngrps, gmax, requested, multiple_of=1):
    """Largest group-block <= ``requested`` that divides ngrps and is a
    multiple of gmax (shared-BATCHED chunks must split on operator-class
    boundaries so the (ngrps -> U, gmax) reshape stays block-local) and of
    ``multiple_of`` (mesh runs block on shard boundaries so sliced/re-put
    blocks keep their 'bl' sharding). Returns None when blocking is off or
    would not split the chunk."""
    if requested is None or requested >= ngrps:
        return None
    if int(requested) < 1:
        raise ValueError(
            f"loss_block_ngrps must be >= 1, got {requested} (use None to "
            "disable group blocking)"
        )
    unit = int(np.lcm(int(gmax), int(multiple_of)))
    b = max(unit, (int(requested) // unit) * unit)
    while b >= unit and ngrps % b:
        b -= unit
    if b < unit:  # ngrps not a multiple of unit: cannot block on the mesh
        return None
    return b if b < ngrps else None


def _blocked_chunk_scan(term_fn, n_out, gr, gi, fr, fi, dr, di, w, comps,
                        a0, a1, blk):
    """Evaluate one chunk's per-slice loss terms as a lax.scan over group
    blocks of size ``blk``, rematerializing each block on the backward
    pass. ``term_fn(gr, gi, fr_b, fi_b, dr_b, di_b, w_b, comps_b, a0_b,
    a1_b)`` returns a tuple of ``n_out`` (nbatch,) arrays, accumulated
    across blocks in the scan carry (one accumulator for the plain loss;
    loss + model-flux sums for the "sum"-regularized one).

    The step's device-memory peak is NOT the data cube but the ~8-10
    cube-sized activation transients of the loss (gain products,
    foreground model, errors and their cotangents), which at full-array
    many-poltime scale outgrow the data itself. Blocking bounds the live
    set to (nbatch, blk, nbls, nfreqs)-sized tensors while the
    contractions stay large."""
    ngrps = a0.shape[0]
    nblk = ngrps // blk
    nu = comps.shape[0]

    # the SLICING happens INSIDE the checkpointed function: jax.checkpoint
    # saves its inputs as residuals, and slicing outside would stack a
    # per-iteration copy of every block across the scan — the full cube
    # again, defeating the point (measured: +8 GiB at 8 x 1536 full HERA).
    # With the index inside, the residuals are the loop-invariant full
    # arrays (stored once) plus a scalar, and the backward re-slices.
    @jax.checkpoint
    def blocked(i, gr, gi, fr, fi, dr, di, w, comps, a0, a1):
        g0 = i * blk
        a0_b = jax.lax.dynamic_slice_in_dim(a0, g0, blk, axis=0)
        a1_b = jax.lax.dynamic_slice_in_dim(a1, g0, blk, axis=0)
        fr_b = jax.lax.dynamic_slice_in_dim(fr, g0, blk, axis=1)
        fi_b = jax.lax.dynamic_slice_in_dim(fi, g0, blk, axis=1)
        dr_b = jax.lax.dynamic_slice_in_dim(dr, g0, blk, axis=1)
        di_b = jax.lax.dynamic_slice_in_dim(di, g0, blk, axis=1)
        w_b = jax.lax.dynamic_slice_in_dim(w, g0, blk, axis=1)
        if nu == 1:
            comps_b = comps  # plain shared operator: reused by every block
        elif nu < ngrps:
            # shared-batched: blk is a multiple of gmax, so the block
            # covers whole operator classes
            gmax = ngrps // nu
            comps_b = jax.lax.dynamic_slice_in_dim(
                comps, (g0 // gmax), blk // gmax, axis=0
            )
        else:
            comps_b = jax.lax.dynamic_slice_in_dim(comps, g0, blk, axis=0)
        return term_fn(gr, gi, fr_b, fi_b, dr_b, di_b, w_b, comps_b,
                       a0_b, a1_b)

    def body(carry, i):
        out = blocked(i, gr, gi, fr, fi, dr, di, w, comps, a0, a1)
        return tuple(c + o for c, o in zip(carry, out)), None

    nbatch = gr.shape[0]
    zero = jnp.zeros((nbatch,), dtype=gr.dtype)
    carry, _ = jax.lax.scan(
        body, tuple(zero for _ in range(n_out)), jnp.arange(nblk)
    )
    return carry


def _blocked_chunk_losses(chunk_losses, gr, gi, fr, fi, dr, di, w, comps, a0, a1,
                          blk):
    """Single-accumulator wrapper over _blocked_chunk_scan (the plain
    chi-square path)."""
    (total,) = _blocked_chunk_scan(
        lambda *a: (chunk_losses(*a),), 1,
        gr, gi, fr, fi, dr, di, w, comps, a0, a1, blk,
    )
    return total


def batched_chunk_losses(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts,
                         remat=False, loss_block=None, loss_block_unit=1):
    """Per-batch-element chi-square, shape (nbatch,).

    The per-chunk term is EXPLICITLY batched over slices (not vmapped):
    one contraction reads the chunk's comps once for the whole batch and,
    for bf16 comps, keeps the f32 upcast fused into the operand read —
    vmapping the single-slice loss measured 7.37 ms vs 4.89 ms for 2
    slices at bench shapes (see ops.loss.fg_model_batched).

    ``remat`` checkpoints each chunk's term (backward recomputes the
    foreground model instead of saving (nbatch, ngrps, nbls, nfreqs)
    activations). ``loss_block`` additionally evaluates each chunk as a
    scan over group blocks of that size (see _blocked_chunk_losses) —
    bounds the activation HBM peak for many-poltime full-array batches."""
    from ..ops.loss import fg_model_batched

    def chunk_losses(gr, gi, fr, fi, dr, di, w, comps, a0, a1):
        # gains: (nbatch, nants, nfreqs); a0/a1: (ngrps, nbls)
        gr0 = jnp.take(gr, a0, axis=1)  # (nbatch, ngrps, nbls, nfreqs)
        gr1 = jnp.take(gr, a1, axis=1)
        gi0 = jnp.take(gi, a0, axis=1)
        gi1 = jnp.take(gi, a1, axis=1)
        pr = gr0 * gr1 + gi0 * gi1
        pi = gr0 * gi1 - gi0 * gr1
        vr, vi = fg_model_batched(fr, fi, comps)
        mr = pr * vr + pi * vi
        mi = -pi * vr + pr * vi
        if w.dtype != dr.dtype:
            # bf16 weights stream at half width; upcast fuses into the read
            w = w.astype(dr.dtype)
        return jnp.sum(
            w * (jnp.square(dr - mr) + jnp.square(di - mi)), axis=(1, 2, 3)
        )

    plain_losses = jax.checkpoint(chunk_losses) if remat else chunk_losses
    total = 0.0
    for cnum, (comps, a0, a1) in enumerate(chunks):
        ngrps = a0.shape[0]
        nu = comps.shape[0]
        gmax = ngrps // nu if 1 < nu < ngrps else 1
        blk = _loss_block_size(ngrps, gmax, loss_block, loss_block_unit)
        if blk is not None:
            total = total + _blocked_chunk_losses(
                chunk_losses, g_r, g_i, fg_r[cnum], fg_i[cnum],
                data_r[cnum], data_i[cnum], wgts[cnum], comps, a0, a1, blk,
            )
            continue
        total = total + plain_losses(
            g_r, g_i, fg_r[cnum], fg_i[cnum], data_r[cnum], data_i[cnum], wgts[cnum],
            comps, a0, a1,
        )
    return total


def batched_chunk_losses_sum_regularized(
    g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, prior_r, prior_i,
    loss_block=None, loss_block_unit=1,
):
    """Per-batch-element chi-square + "sum" flux prior (reference
    mse_chunked_sum_regularized, calibration.py:1623-1656), one prior pair
    per batch element. Shape (nbatch,).

    Explicitly batched like batched_chunk_losses (one comps read for the
    whole batch; bf16 upcast stays fused); ``loss_block`` bounds the
    activation peak the same way (the model-flux sums accumulate across
    blocks in the scan carry)."""
    from ..ops.loss import fg_model_batched

    def chunk_terms(gr, gi, fr, fi, dr, di, w, comps, a0, a1):
        gr0 = jnp.take(gr, a0, axis=1)
        gr1 = jnp.take(gr, a1, axis=1)
        gi0 = jnp.take(gi, a0, axis=1)
        gi1 = jnp.take(gi, a1, axis=1)
        pr = gr0 * gr1 + gi0 * gi1
        pi = gr0 * gi1 - gi0 * gr1
        vr, vi = fg_model_batched(fr, fi, comps)
        model_r = pr * vr + pi * vi
        model_i = -pi * vr + pr * vi
        if w.dtype != dr.dtype:
            w = w.astype(dr.dtype)
        mrs = jnp.sum(model_r * w, axis=(1, 2, 3))
        mis = jnp.sum(model_i * w, axis=(1, 2, 3))
        loss = jnp.sum(
            w * (jnp.square(dr - model_r) + jnp.square(di - model_i)),
            axis=(1, 2, 3),
        )
        return loss, mrs, mis

    total = 0.0
    mr_sum = 0.0
    mi_sum = 0.0
    for cnum, (comps, a0, a1) in enumerate(chunks):
        fr, fi = fg_r[cnum], fg_i[cnum]
        dr, di, w = data_r[cnum], data_i[cnum], wgts[cnum]
        ngrps = a0.shape[0]
        nu = comps.shape[0]
        gmax = ngrps // nu if 1 < nu < ngrps else 1
        blk = _loss_block_size(ngrps, gmax, loss_block, loss_block_unit)
        if blk is not None:
            tot_c, mr_c, mi_c = _blocked_chunk_scan(
                chunk_terms, 3, g_r, g_i, fr, fi, dr, di, w, comps, a0, a1, blk,
            )
            total = total + tot_c
            mr_sum = mr_sum + mr_c
            mi_sum = mi_sum + mi_c
            continue
        loss_c, mrs, mis = chunk_terms(g_r, g_i, fr, fi, dr, di, w, comps, a0, a1)
        total = total + loss_c
        mr_sum = mr_sum + mrs
        mi_sum = mi_sum + mis
    return total + jnp.square(mr_sum - prior_r) + jnp.square(mi_sum - prior_i)


@partial(jax.jit, static_argnums=(0,))
def scanned_warmstart_fit_core(cfg: FitConfig, chunks, data_r, data_i, wgts,
                               g_r0, g_i0, fg_r0, fg_i0, prior_r, prior_i):
    """Sequential warm-started fits over times, compiled as one lax.scan.

    Reference semantics: with init_guesses_from_previous_time_step the
    driver seeds each time's fit with the previous time's solution
    (reference calibration.py:1085-1087, 1210-1233), looping times on the
    host. Here the whole sequence is ONE program: scan carries the
    parameters across times, each scan step runs the full while_loop
    descent (fresh optimizer state per time, matching the reference's
    per-fit optimizer construction at calibration.py:571).

    data_r/data_i/wgts: tuples of (ntimes, ngrps, nbls, nfreqs) arrays;
    g0/fg0: the time-0 initialization. Returns per-time parameters,
    (ntimes, maxsteps) loss history, per-time step counts and final losses.
    """
    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    dtype = g_r0.dtype
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)

    def fit_one(params0, data_r_t, data_i_t, wgts_t, pr_t, pi_t):
        if cfg.freeze_model:
            g_params0 = params0[:2]
            fg_const = params0[2:]

            def loss_fn(p):
                gr, gi = p
                if cfg.regularization == "sum":
                    return chunked_loss_sum_regularized(
                        gr, gi, fg_const[0], fg_const[1], chunks,
                        data_r_t, data_i_t, wgts_t, pr_t, pi_t,
                    )
                return chunked_loss(
                    gr, gi, fg_const[0], fg_const[1], chunks,
                    data_r_t, data_i_t, wgts_t, remat=cfg.remat,
                )

            p0 = g_params0
        else:

            def loss_fn(p):
                gr, gi, fr, fi = p
                if cfg.regularization == "sum":
                    return chunked_loss_sum_regularized(
                        gr, gi, fr, fi, chunks, data_r_t, data_i_t, wgts_t,
                        pr_t, pi_t,
                    )
                return chunked_loss(
                    gr, gi, fr, fi, chunks, data_r_t, data_i_t, wgts_t,
                    remat=cfg.remat,
                )

            p0 = params0

        vg = jax.value_and_grad(loss_fn)
        opt_state = opt.init(p0)

        def one_step(p, s):
            loss, grads = vg(p)
            updates, s = opt.update(grads, s, p)
            return loss, optax.apply_updates(p, updates), s

        _, p, opt_state = one_step(p0, opt_state)  # warm-up step
        history0 = jnp.full((cfg.maxsteps,), jnp.nan, dtype=dtype)
        state0 = (jnp.asarray(0, jnp.int32), p, opt_state, big, big, big, p,
                  history0, jnp.asarray(0, jnp.int32))

        def cond(state):
            step, _, _, prev, delta, _, _, _, since = state
            ok = jnp.logical_and(step < cfg.maxsteps, delta >= cfg.tol)
            if cfg.patience > 0:
                ok = jnp.logical_and(ok, since < cfg.patience)
            return jnp.logical_and(ok, jnp.isfinite(prev))

        def body(state):
            step, p, s, prev, _, best_loss, best_p, history, since = state
            loss, new_p, new_s = one_step(p, s)
            history = history.at[step].set(loss.astype(dtype))
            delta = jnp.where(step >= 1, jnp.abs(loss - prev), big)
            is_best = loss < best_loss
            best_loss = jnp.minimum(loss, best_loss)
            best_p = jax.tree_util.tree_map(
                lambda a, b: jnp.where(is_best, a, b), new_p, best_p
            )
            since = jnp.where(is_best, 0, since + 1)
            return (step + 1, new_p, new_s, loss, delta, best_loss, best_p,
                    history, since)

        step, p, _, last, _, best_loss, best_p, history, _ = jax.lax.while_loop(
            cond, body, state0
        )
        out_p = best_p if cfg.use_min else p
        final = best_loss if cfg.use_min else last
        if cfg.freeze_model:
            out_params = out_p + fg_const
        else:
            out_params = out_p
        return out_params, history, step, final

    def scan_body(carry, xs):
        dr, di, w, pr, pi = xs
        out_params, history, nsteps, final = fit_one(carry, dr, di, w, pr, pi)
        return out_params, (out_params, history, nsteps, final)

    carry0 = (g_r0, g_i0, fg_r0, fg_i0)
    xs = (data_r, data_i, wgts, prior_r, prior_i)
    _, (all_params, history, nsteps, finals) = jax.lax.scan(scan_body, carry0, xs)
    return all_params, history, nsteps, finals


class BatchedFitResult(NamedTuple):
    g_r: Any
    g_i: Any
    fg_r: Any
    fg_i: Any
    loss_history: Any  # (maxsteps, nbatch)
    nsteps: Any  # scalar: global steps taken
    final_loss: Any  # (nbatch,)
    nsteps_slice: Any = None  # (nbatch,): per-slice steps until convergence
    opt_state: Any = None  # final optimizer state (for two-phase descents)


def _batched_step_fn(cfg: FitConfig, chunks, data_r, data_i, wgts, fg_r, fg_i,
                     prior_r, prior_i):
    """Build (opt, one_step) for the batched descent: one_step(params,
    opt_state) -> (per-slice losses, params, opt_state). Shared by
    batched_fit_core, batched_fit_segment and the warm-up step so the
    three entry points compile the SAME per-step program."""
    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))

    if cfg.regularization == "sum":
        def raw_losses(gr, gi, fr, fi):
            return batched_chunk_losses_sum_regularized(
                gr, gi, fr, fi, chunks, data_r, data_i, wgts, prior_r, prior_i,
                loss_block=cfg.loss_block,
                loss_block_unit=cfg.loss_block_unit,
            )
    else:
        def raw_losses(gr, gi, fr, fi):
            return batched_chunk_losses(gr, gi, fr, fi, chunks, data_r, data_i, wgts,
                                        remat=cfg.remat, loss_block=cfg.loss_block,
                                        loss_block_unit=cfg.loss_block_unit)

    if cfg.freeze_model:
        def losses_fn(params):
            return raw_losses(params[0], params[1], fg_r, fg_i)
    else:
        def losses_fn(params):
            return raw_losses(params[0], params[1], params[2], params[3])

    def total_loss(params):
        losses = losses_fn(params)
        return jnp.sum(losses), losses

    vg = jax.value_and_grad(total_loss, has_aux=True)

    def one_step(params, opt_state):
        (_, losses), grads = vg(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return losses, params, opt_state

    return opt, one_step


def _batched_segment_impl(cfg: FitConfig, seg_cap, one_step, nbatch, dtype,
                          params, opt_state, prev, frozen, nsteps_slice,
                          best_loss, best_params, since_best, step0,
                          seg_len=None, warmup_offset=0):
    """Up to ``seg_len`` (<= static ``seg_cap``) recorded batched descent
    steps from explicit carried state.

    ``step0`` is the number of GLOBAL steps already taken (checkpointed
    resumes enter with step0 > 0); per-slice freeze bookkeeping records
    global step numbers so resumed diagnostics match an uninterrupted run.
    The per-segment history buffer is (seg_cap, nbatch) float32 (see the
    note in batched_fit_core).

    ``seg_len`` and ``warmup_offset`` are TRACED scalars so one compiled
    executable serves every segment of a fit: statically specializing
    (length, warmup) variants would compile the full-scale program four
    times (and with auto layouts each variant would pin its own
    layout-converted cube copies). ``warmup_offset=1`` runs ONE
    unrecorded step before counting begins (reference calibration.py:693
    parity): iteration ``step`` records at index ``step - warmup_offset``,
    negative indices leave every statistic untouched — identical
    bookkeeping to the old static warm-up prologue.

    Argmin (use_min) tracking is STATICALLY conditional: with
    cfg.use_min=False the best_loss/best_params carries are empty pytrees
    — carrying a duplicate parameter set costs a full coefficient-state
    copy of HBM at many-poltime full-array scale for bookkeeping nobody
    reads (the driver returns the final params in that mode)."""
    if seg_len is None:
        seg_len = seg_cap
    seg_len = jnp.asarray(seg_len, jnp.int32)
    warmup_offset = jnp.asarray(warmup_offset, jnp.int32)
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
    history0 = jnp.full((seg_cap, nbatch), jnp.nan, dtype=jnp.float32)
    # best_loss is read by BOTH argmin tracking and the patience freeze;
    # best_params only by argmin tracking; since_best only by patience.
    # Unused carries are empty pytrees (see the use_min note above).
    track_best = cfg.use_min or cfg.patience > 0
    if not cfg.use_min:
        best_params = ()
    if not track_best:
        best_loss = ()
    if cfg.patience == 0:
        since_best = ()
    state0 = (jnp.asarray(0, jnp.int32), params, opt_state, prev, frozen,
              nsteps_slice, best_loss, best_params, since_best, history0)

    def cond(state):
        step, _, _, _, frozen, _, _, _, _, _ = state
        return jnp.logical_and(
            step < seg_len + warmup_offset, ~jnp.all(frozen)
        )

    def body(state):
        (step, params, opt_state, prev, frozen, nsteps_slice, best_loss,
         best_params, since_best, history) = state
        idx = step - warmup_offset  # recorded-step index; -1 on the warm-up
        rec = idx >= 0
        gstep = step0 + idx
        losses, new_params, new_opt_state = one_step(params, opt_state)

        def keep_frozen(new, old):
            # select per-slice along the leading batch axis; leaves without
            # a batch axis (e.g. optimizer step counts) just advance
            if new.ndim == 0 or new.shape[0] != nbatch:
                return new
            bshape = (nbatch,) + (1,) * (new.ndim - 1)
            return jnp.where(frozen.reshape(bshape), old, new)

        new_params = jax.tree_util.tree_map(keep_frozen, new_params, params)
        new_opt_state = jax.tree_util.tree_map(keep_frozen, new_opt_state, opt_state)
        # frozen slices re-evaluate to their converged loss; don't re-record
        # (and the warm-up iteration records nothing at all)
        slot = jnp.maximum(idx, 0)
        history = history.at[slot].set(
            jnp.where(rec & ~frozen, losses.astype(jnp.float32), history[slot])
        )
        # the first recorded global step cannot trigger the tolerance stop
        # (parity with solver.fit._fit_segment / reference calibration.py:693)
        delta = jnp.where(gstep >= 1, jnp.abs(losses - prev), big)
        newly = rec & (~frozen) & (
            jnp.logical_and(gstep >= 1, delta < cfg.tol) | ~jnp.isfinite(losses)
        )
        if track_best:
            # per-slice argmin tracking: select along the batch axis (the
            # warm-up iteration leaves the incoming pre-warm-up snapshot,
            # matching the old prologue: best_loss enters at `big`, so
            # every slice's best is overwritten at its first recorded step)
            is_best = rec & (losses < best_loss)
            best_loss = jnp.where(is_best, losses, best_loss)
        if cfg.patience > 0:
            # steps since a slice's last new loss minimum; a slice with no
            # new minimum for `patience` recorded steps freezes (the tol
            # stop never fires on an oscillating plateau — FitConfig note)
            since_best = jnp.where(
                rec & ~frozen, jnp.where(is_best, 0, since_best + 1),
                since_best,
            )
            newly = newly | (rec & ~frozen & (since_best >= cfg.patience))
        nsteps_slice = jnp.where(newly, gstep + 1, nsteps_slice)
        frozen = frozen | newly
        new_prev = jnp.where(rec, losses, prev)
        if cfg.use_min:
            def sel(new, old):
                bshape = (nbatch,) + (1,) * (new.ndim - 1)
                return jnp.where(is_best.reshape(bshape), new, old)

            best_params = jax.tree_util.tree_map(sel, new_params, best_params)
        return (step + 1, new_params, new_opt_state, new_prev, frozen,
                nsteps_slice, best_loss, best_params, since_best, history)

    (step, params, opt_state, prev, frozen, nsteps_slice, best_loss, best_params,
     since_best, history) = jax.lax.while_loop(cond, body, state0)
    recorded = jnp.maximum(step - warmup_offset, 0)
    return (params, opt_state, prev, frozen, nsteps_slice, best_loss, best_params,
            since_best, history, recorded)


def _segment_fn(cfg: FitConfig, seg_cap, chunks, data_r, data_i, wgts,
                fg_r_const, fg_i_const, prior_r, prior_i, params,
                opt_state, prev, frozen, nsteps_slice, best_loss,
                best_params, since_best, step0, seg_len, warmup_offset):
    """The raw (untransformed) segment program shared by the jit entry
    point and the AOT auto-layout executables (BatchedSegmentPlan)."""
    _, one_step = _batched_step_fn(
        cfg, chunks, data_r, data_i, wgts, fg_r_const, fg_i_const, prior_r, prior_i
    )
    return _batched_segment_impl(
        cfg, seg_cap, one_step, prev.shape[0], prev.dtype, params, opt_state,
        prev, frozen, nsteps_slice, best_loss, best_params, since_best, step0,
        seg_len=seg_len, warmup_offset=warmup_offset,
    )


@partial(jax.jit, static_argnums=(0, 1),
         donate_argnums=(10, 11, 12, 13, 14, 15, 16, 17))
def batched_fit_segment(cfg: FitConfig, seg_cap, chunks, data_r,
                        data_i, wgts, fg_r_const, fg_i_const, prior_r,
                        prior_i, params, opt_state, prev, frozen,
                        nsteps_slice, best_loss, best_params, since_best,
                        step0, seg_len, warmup_offset):
    """Checkpointable batched descent segment: carried state in and out so
    the host can persist it between segments (the batched counterpart of
    solver.fit._fit_segment). ``seg_len`` (recorded steps this call,
    <= static ``seg_cap``) and ``warmup_offset`` (1 folds the fit's one
    unrecorded warm-up step — reference calibration.py:693 parity — into
    the first segment's call) are TRACED scalars so every segment of a
    fit reuses ONE compiled program — see _batched_segment_impl.

    The carried state (params, optimizer state, freeze bookkeeping) is
    DONATED: at full-HERA many-poltime scale the coefficient+Adam-moment
    state is GiB-sized, and without donation every segment call holds both
    the input and output copies. Callers must rebind their references to
    the returned state (batched_fit_checkpointed does). In non-freeze mode
    pass EMPTY tuples as fg_r_const/fg_i_const — the loss reads the
    coefficients from params, and passing the same arrays both ways would
    donate buffers that are still referenced."""
    return _segment_fn(
        cfg, seg_cap, chunks, data_r, data_i, wgts, fg_r_const,
        fg_i_const, prior_r, prior_i, params, opt_state, prev, frozen,
        nsteps_slice, best_loss, best_params, since_best, step0, seg_len,
        warmup_offset,
    )


def auto_layouts_enabled():
    """Whether single-device batched descents use AOT auto-layout segment
    executables (default). ``CALAMITY_SEGMENT_LAYOUTS=jit`` forces the
    plain jit path (default row-major entry layouts) for debugging."""
    import os

    return os.environ.get("CALAMITY_SEGMENT_LAYOUTS", "auto").lower() != "jit"


def loss_guard_factor():
    """Tolerance factor for the step-0 initial-loss cross-check, or None
    when the guard is disabled (``CALAMITY_LOSS_GUARD=off``).

    The guard exists because a compiled relayout once SCRAMBLED cube
    contents — a full-scale flagged run started at 28x the correct
    chi-square and was only caught by a human reading logs
    (docs/DESIGN.md "Auto-layout entry plans"). Before the
    first AOT segment executes, the drivers compute the initial per-slice
    loss through an independent path (a plain default-layout jit on the
    pristine pre-relayout buffers, or host numpy from the host stacks) and
    abort if the first recorded loss exceeds it by this factor. The factor
    (default 4, ``CALAMITY_LOSS_GUARD_FACTOR``) absorbs the one unrecorded
    warm-up step between the two evaluations (reference calibration.py:693
    parity) and bf16-vs-f32 basis quantization; a scramble is orders of
    magnitude."""
    import os

    if os.environ.get("CALAMITY_LOSS_GUARD", "on").lower() in (
        "off", "0", "false", "no",
    ):
        return None
    return float(os.environ.get("CALAMITY_LOSS_GUARD_FACTOR", "4.0"))


@partial(jax.jit, static_argnums=(0,))
def batched_initial_losses(cfg: FitConfig, chunks, data_r, data_i, wgts,
                           g_r, g_i, fg_r, fg_i, prior_r, prior_i):
    """Per-slice loss at the given parameters — the independent evaluation
    the step-0 guard compares the first AOT segment's recorded loss
    against. Plain jit with default entry layouts: call it on the PRISTINE
    buffers BEFORE BatchedSegmentPlan.put_entries relayouts them (the whole
    point is not to trust the relayout path). Same blocked evaluation as
    the descent (loss_block bounds the activation peak at full scale)."""
    if cfg.regularization == "sum":
        return batched_chunk_losses_sum_regularized(
            g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts,
            prior_r, prior_i,
            loss_block=cfg.loss_block, loss_block_unit=cfg.loss_block_unit,
        )
    return batched_chunk_losses(
        g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts,
        remat=cfg.remat, loss_block=cfg.loss_block, loss_block_unit=cfg.loss_block_unit,
    )


def host_batched_losses(g_r, g_i, fg_r, fg_i, host_chunks, data_r, data_i,
                        wgts, prior_r=None, prior_i=None, regularization=None):
    """numpy mirror of batched_chunk_losses for the step-0 guard on paths
    that upload host cubes STRAIGHT into plan entry layouts (the warm-
    started time scan): there is never a pristine default-layout device
    copy to evaluate, so the trustworthy reference value comes from the
    host arrays themselves. ``host_chunks`` is a list of (comps, a0, a1)
    numpy triples (fetch device comps once with ops.loss.host_chunk_comps).
    All arrays carry the batch axis; returns (nbatch,) float64."""
    from ..ops.loss import fg_model_host

    g_r = np.asarray(g_r, dtype=np.float64)
    g_i = np.asarray(g_i, dtype=np.float64)
    nbatch = g_r.shape[0]
    total = np.zeros((nbatch,), dtype=np.float64)
    mr_sum = np.zeros((nbatch,), dtype=np.float64)
    mi_sum = np.zeros((nbatch,), dtype=np.float64)
    for cnum, (comps, a0, a1) in enumerate(host_chunks):
        a0 = np.asarray(a0)
        a1 = np.asarray(a1)
        for b in range(nbatch):
            vr, vi = fg_model_host(
                np.asarray(fg_r[cnum])[b], np.asarray(fg_i[cnum])[b], comps
            )
            pr = (g_r[b][a0] * g_r[b][a1] + g_i[b][a0] * g_i[b][a1])
            pi = (g_r[b][a0] * g_i[b][a1] - g_i[b][a0] * g_r[b][a1])
            mr = pr * vr + pi * vi
            mi = -pi * vr + pr * vi
            dr = np.asarray(data_r[cnum][b], dtype=np.float64)
            di = np.asarray(data_i[cnum][b], dtype=np.float64)
            w = np.asarray(wgts[cnum][b], dtype=np.float64)
            total[b] += np.sum(w * (np.square(dr - mr) + np.square(di - mi)))
            if regularization == "sum":
                mr_sum[b] += np.sum(mr * w)
                mi_sum[b] += np.sum(mi * w)
            del vr, vi, pr, pi, mr, mi, dr, di, w
    if regularization == "sum":
        total = total + (
            np.square(mr_sum - np.asarray(prior_r, dtype=np.float64))
            + np.square(mi_sum - np.asarray(prior_i, dtype=np.float64))
        )
    return total


def loss_guard_floor():
    """Absolute floor (rms-normalized chi-square units) below which the
    step-0 guard never aborts. The drivers scale data by its rms and
    normalize weights to unit sum, so a scrambled cube evaluates to
    O(0.1-1) chi-square regardless of how good the fit would have been —
    while a NEAR-PERFECT warm start (projected fixtures) sits at rounding
    noise (~1e-13) where one Adam warm-up step legitimately raises the
    loss by orders of magnitude in relative terms. Both conditions must
    hold to abort: recorded > factor x expected AND recorded > floor."""
    import os

    return float(os.environ.get("CALAMITY_LOSS_GUARD_FLOOR", "1e-4"))


def check_initial_loss(recorded0, expected0, factor, context=""):
    """Abort loudly when the first recorded per-slice loss disagrees with
    the independently computed initial loss beyond ``factor`` — the
    self-detecting version of the 28x-chi-square layout scramble.

    One warm-up Adam step separates the two evaluations, so the check is
    one-sided-strict: a recorded loss ABOVE factor x expected (and above
    loss_guard_floor in absolute normalized units) aborts — a scrambled
    cube evaluated against its fitted model raises chi-square to O(data
    power); a recorded loss below expected / factor — legitimate for a
    fast-converging first step — only warns. Slices whose expected loss
    is zero or non-finite (zero-weight dummy batch rows) are skipped."""
    import sys

    recorded0 = np.asarray(recorded0, dtype=np.float64)
    expected0 = np.asarray(expected0, dtype=np.float64)
    floor = loss_guard_floor()
    valid = np.isfinite(expected0) & (expected0 > 0) & np.isfinite(recorded0)
    if not valid.any():
        return
    ratio = np.where(valid, recorded0 / np.where(valid, expected0, 1.0), 1.0)
    ratio = np.where(recorded0 > floor, ratio, 1.0)
    if (ratio > factor).any():
        bad = int(np.argmax(ratio))
        raise RuntimeError(
            f"step-0 loss cross-check failed{context}: slice {bad} first "
            f"recorded loss {recorded0[bad]:.6e} is {ratio[bad]:.1f}x the "
            f"independently computed initial loss {expected0[bad]:.6e} "
            f"(tolerance factor {factor:g}). This is the signature of a "
            "scrambled entry buffer (a relayout/device_put corrupted a "
            "data/weight cube — the 28x-chi-square class); the descent "
            "would silently fit corrupted data. Set CALAMITY_LOSS_GUARD=off "
            "to bypass, CALAMITY_LOSS_GUARD_FACTOR to widen."
        )
    if (valid & (ratio < 1.0 / factor)).any():
        bad = int(np.argmin(np.where(valid, ratio, 1.0)))
        print(
            f"calamity_tpu: step-0 loss cross-check{context}: slice {bad} "
            f"first recorded loss {recorded0[bad]:.6e} is "
            f"{1.0 / max(ratio[bad], 1e-300):.1f}x BELOW the expected "
            f"initial loss {expected0[bad]:.6e} — plausible for a fast-"
            "converging warm-up step, but verify the run's convergence.",
            file=sys.stderr, flush=True,
        )


def _format_of(x):
    try:
        return x.format
    except (AttributeError, ValueError):
        return None


def _layout_honored(got, want):
    """Whether a realized layout satisfies a requested one. A request with
    ``tiling=None`` (or empty) constrains only the dimension order — the
    backend fills in its default tiling, which must not count as a
    violation (healed layouts parsed from error text that printed
    ``tiling=None`` land here)."""
    if got == want:
        return True
    if got is None or want is None:
        return False
    if tuple(got.major_to_minor) != tuple(want.major_to_minor):
        return False
    return not want.tiling or got.tiling == want.tiling


def _put_format(x, fmt):
    if fmt is None or getattr(fmt, "layout", None) is None:
        # unconstrained entry (input_formats reports layout=None for some
        # small/scalar parameters): nothing to realize
        return x
    if _format_of(x) == fmt:
        return x
    y = jax.device_put(x, fmt)
    got = _format_of(y)
    if got != fmt and not _layout_honored(getattr(got, "layout", None), fmt.layout):
        # the transfer path did not honor the requested layout (observed
        # for compiler-chosen custom layouts of bf16 cubes, and of f32
        # cubes with size-1 axes on the nbatch=1 scan path). device_put
        # is VALUE-exact either way, so this is not the scramble class
        # (which came from a compiled relayout program, not a transfer);
        # the pre-execution
        # runtime layout check is the authority on whether the realized
        # layout is actually acceptable — entry_formats itself is known
        # to misreport (see _apply_required_layouts), so the requested
        # fmt may simply be wrong. Warn and defer: a true mismatch fails
        # the runtime check, enters the bounded heal loop in `run`, and
        # raises loudly if the backend cannot realize the REQUIRED
        # layout either; a value scramble is caught by the step-0 loss
        # guard (check_initial_loss).
        warnings.warn(
            f"device_put did not honor the planned entry layout for "
            f"{getattr(x, 'dtype', '?')}{getattr(x, 'shape', '?')}: got "
            f"{got}, wanted {fmt}. Deferring to the runtime layout "
            "check (entry_formats may misreport; the heal loop recovers "
            "a true mismatch).",
            RuntimeWarning,
            stacklevel=2,
        )
    return y


def _aval_key(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return (treedef, tuple((tuple(l.shape), jnp.dtype(l.dtype).name) for l in leaves))


# LRU-bounded: each plan pins a compiled executable (minutes of XLA at
# full scale, large on host) — a long-lived process sweeping maxsteps /
# checkpoint cadence / shapes must not accumulate one per configuration
# (review r3). Capacity 4 covers the realistic concurrent set (two
# precision phases x a profiling variant) with room to spare.
_SEGMENT_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_SEGMENT_PLAN_CACHE_CAPACITY = 4


class BatchedSegmentPlan:
    """AOT auto-layout executables for single-device batched descents.

    jit compiles entry points with default (row-major) entry layouts; at
    many-poltime full-array scale the while-loop segment program then pins
    a layout-converted copy of every data/weight cube for the whole
    descent, when the loop body prefers another layout than row-major.
    Compiling the SAME program with AUTO entry layouts lets the loop
    body's preferred cube layouts propagate to the entry instead, so the
    cubes live once. Whether that still matters on a device with 80 GB
    is not measured yet (docs/DESIGN.md "Auto-layout entry plans").

    The plan compiles ONE executable with all-AUTO entry layouts; the
    segment length and warm-up offset are traced scalar arguments
    (_batched_segment_impl), so the warm-up first segment and any partial
    final segment run the SAME program — no per-variant recompiles and no
    per-variant layout copies. ``entry_formats`` exposes the
    layout choice so the driver can move the big constant tensors into it
    ONCE, rebinding its references (a lazily-relayouted cube would
    otherwise live twice for the whole descent: the caller's
    default-layout original plus the executable's copy).

    Single-device only: mesh runs keep the jit path (per-device shards are
    a mesh-factor smaller, and AUTO layouts would have to be planned
    against NamedShardings). The same program semantics are compiled
    either way (_segment_fn), so trajectories are independent of the
    routing."""

    def __init__(self, cfg: FitConfig, seg_cap, args_sds):
        self.cfg = cfg
        self.seg_cap = int(seg_cap)
        self._args_sds = args_sds
        fn = partial(_segment_fn, self.cfg, self.seg_cap)
        # Full-AUTO entry layouts: constraining ANY entry (one slot or
        # all bf16 leaves — both tried) effectively disables the
        # auto-layout pass and brings the loop-pinned layout copies back.
        # input_formats can MISREPORT the executable's true entry layout
        # for some bf16 leaves (observed: reported (0,2,1,3) vs required
        # (2,1,0,3) for 4 of 9 weight cubes at full scale); `run` heals
        # that from the runtime layout check's authoritative error — see
        # _apply_required_layouts.
        jitted = jax.jit(
            fn,
            donate_argnums=(8, 9, 10, 11, 12, 13, 14, 15),
            in_shardings=_auto_format(),
            out_shardings=_auto_format(),
        )
        self._compiled = jitted.lower(*args_sds).compile()
        self.entry_formats = list(self._compiled.input_formats[0])
        self.out_formats = self._compiled.output_formats

    # positional parameter names of _segment_fn after the (cfg, seg_cap)
    # partial — used to resolve the runtime layout check's argument names
    _ARG_NAMES = (
        "chunks", "data_r", "data_i", "wgts", "fg_r_const", "fg_i_const",
        "prior_r", "prior_i", "params", "opt_state", "prev", "frozen",
        "nsteps_slice", "best_loss", "best_params", "since_best", "step0",
        "seg_len", "warmup_offset",
    )

    def _apply_required_layouts(self, err_msg, args):
        """Heal an input-layout mismatch using the runtime check's error.

        ``compiled.input_formats`` can misreport the executable's true
        entry layouts for some bf16 leaves; the pre-execution layout
        check's ValueError lists, per argument, the REQUIRED layout — the
        only authoritative source. Parse it, device_put the named leaves
        into the required layouts (realizable: verified value-exact on
        this backend), and patch entry_formats so every later segment
        call converts correctly up front. Returns the corrected args, or
        None if nothing could be parsed."""
        import re

        from jax.experimental.layout import Format, Layout
        from jax.sharding import SingleDeviceSharding

        pat = re.compile(
            r"Argument (\w+)((?:\[\d+\])*)[^:]*:\s*\n"
            r"\s*Passed layout:[^\n]*\n"
            r"\s*Required layout: ([^\n]*)"
        )
        dev_sh = SingleDeviceSharding(jax.devices()[0])
        args = list(args)
        formats = self.entry_formats
        healed = 0
        for m in pat.finditer(err_msg):
            name, idx_s, req_line = m.groups()
            if name not in self._ARG_NAMES:
                continue
            ai = self._ARG_NAMES.index(name)
            idxs = [int(x) for x in re.findall(r"\[(\d+)\]", idx_s)]
            m2m_m = re.search(r"major_to_minor=\(([\d,\s]*)\)", req_line)
            if m2m_m is None:
                continue
            m2m = tuple(
                int(x) for x in m2m_m.group(1).replace(" ", "").split(",") if x
            )
            tiling = None
            t_m = re.search(r"tiling=\((.*?)\), sub_byte", req_line)
            if t_m is not None:
                tiling = tuple(
                    tuple(int(x) for x in t.replace(" ", "").split(",") if x)
                    for t in re.findall(r"\(([^()]*)\)", t_m.group(1))
                ) or None
            fmt = Format(Layout(m2m, tiling), dev_sh)

            def patch(tree, path):
                if not path:
                    return fmt
                sub = list(tree)
                sub[path[0]] = patch(sub[path[0]], path[1:])
                return tuple(sub)

            def patch_arr(tree, path):
                if not path:
                    return jax.device_put(tree, fmt)
                sub = list(tree)
                sub[path[0]] = patch_arr(sub[path[0]], path[1:])
                return tuple(sub)

            args[ai] = patch_arr(args[ai], idxs)
            formats[ai] = patch(formats[ai], idxs)
            healed += 1
        return tuple(args) if healed else None

    def run(self, seg_len, warmup, args):
        args = args + (
            jnp.asarray(int(seg_len), jnp.int32),
            jnp.asarray(1 if warmup else 0, jnp.int32),
        )
        args = jax.tree_util.tree_map(
            _put_format, args, tuple(self.entry_formats)
        )
        # the pre-execution layout check reports AT MOST 5 mismatched
        # arguments per raise (jax pxla.check_array_xla_sharding_layout_
        # match, num_errors=5), so healing is a bounded LOOP, not a single
        # retry: each pass fixes the reported batch and re-raises the next.
        # The check fires BEFORE execution, so donated buffers stay intact
        # across retries.
        for _ in range(8):
            try:
                return self._compiled(*args)
            except ValueError as e:
                # gate on healable content, not the exact phrasing: the
                # preamble says "input layouts" or "input shardings and
                # layouts" depending on the mismatch mix
                if "Required layout:" not in str(e):
                    raise
                fixed = self._apply_required_layouts(str(e), args)
                if fixed is None:
                    raise
                args = fixed
        return self._compiled(*args)

    def put_entries(self, index, tree):
        """device_put ``tree`` (matching entry slot ``index`` of the
        segment signature) into the planned entry formats. No-op for
        leaves already in the right format."""
        return jax.tree_util.tree_map(
            _put_format, tree, self.entry_formats[index]
        )


def _auto_format():
    from jax.experimental.layout import Format, Layout

    return Format(Layout.AUTO)


def make_segment_plan(cfg: FitConfig, checkpoint_every, chunks, data_r, data_i,
                      wgts, g_r, fg_r, prior_r):
    """Build (or fetch from the process cache) the layout plan for a
    batched descent with the given entry tensors/avals.

    ``g_r``/``fg_r``/``prior_r`` may be concrete arrays or
    ShapeDtypeStructs; only shapes/dtypes are read. The optimizer state
    aval is derived with eval_shape, and the carried-state structure
    (freeze_model/use_min variants, empty const tuples) mirrors
    batched_fit_checkpointed exactly."""
    def as_sds(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(tuple(x.shape), x.dtype), tree
        )

    nbatch = g_r.shape[0]
    dtype = g_r.dtype
    g_sds = jax.ShapeDtypeStruct(tuple(g_r.shape), dtype)
    fg_sds = as_sds(tuple(fg_r))
    if cfg.freeze_model:
        params_sds = (g_sds, g_sds)
        fg_rc_sds, fg_ic_sds = fg_sds, fg_sds
    else:
        params_sds = (g_sds, g_sds, fg_sds, fg_sds)
        fg_rc_sds, fg_ic_sds = (), ()
    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    opt_state_sds = jax.eval_shape(opt.init, params_sds)
    vec_sds = jax.ShapeDtypeStruct((nbatch,), dtype)
    best_params_sds = params_sds if cfg.use_min else ()
    best_loss_sds = vec_sds if (cfg.use_min or cfg.patience > 0) else ()
    since_sds = (
        jax.ShapeDtypeStruct((nbatch,), jnp.int32) if cfg.patience > 0 else ()
    )
    args_sds = (
        as_sds(tuple(chunks)), as_sds(tuple(data_r)), as_sds(tuple(data_i)),
        as_sds(tuple(wgts)), fg_rc_sds, fg_ic_sds,
        jax.ShapeDtypeStruct(tuple(prior_r.shape), prior_r.dtype),
        jax.ShapeDtypeStruct(tuple(prior_r.shape), prior_r.dtype),
        params_sds, opt_state_sds, vec_sds,
        jax.ShapeDtypeStruct((nbatch,), jnp.bool_),
        jax.ShapeDtypeStruct((nbatch,), jnp.int32),
        best_loss_sds, best_params_sds, since_sds,
        jax.ShapeDtypeStruct((), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32),  # seg_len (traced)
        jax.ShapeDtypeStruct((), jnp.int32),  # warmup_offset (traced)
    )
    seg = max(1, min(int(checkpoint_every), cfg.maxsteps))
    key = (cfg, seg, _aval_key(args_sds))
    plan = _SEGMENT_PLAN_CACHE.get(key)
    if plan is None:
        plan = BatchedSegmentPlan(cfg, seg, args_sds)
        _cache_segment_plan(key, plan)
    else:
        _SEGMENT_PLAN_CACHE.move_to_end(key)
    return plan


def _multidevice(tree):
    """True if any leaf is a jax.Array sharded over more than one device
    (i.e. a mesh run)."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array) and len(leaf.sharding.device_set) > 1:
            return True
    return False


def _cache_segment_plan(key, plan):
    """Insert into the LRU-bounded plan cache, evicting the oldest
    entries past capacity (each entry pins a compiled executable)."""
    _SEGMENT_PLAN_CACHE[key] = plan
    while len(_SEGMENT_PLAN_CACHE) > _SEGMENT_PLAN_CACHE_CAPACITY:
        _SEGMENT_PLAN_CACHE.popitem(last=False)


def batched_fit_checkpointed(cfg: FitConfig, chunks, data_r, data_i, wgts, g_r, g_i,
                             fg_r, fg_i, prior_r, prior_i, checkpoint_dir,
                             checkpoint_every, resume, verbose, opt_state0=None,
                             plan: BatchedSegmentPlan | None = None,
                             steps_per_execution=None, expected_loss0=None,
                             tail_save=True):
    """Segmented batched descent with host-side checkpointing between
    segments (the batched counterpart of solver.fit._fit_checkpointed;
    VERDICT r2 item 1 — the flagship time-parallel path previously dropped
    --checkpoint_dir silently).

    Semantics match batched_fit_core: same warm-up (folded into the first
    segment's call via the traced ``warmup_offset`` scalar — a separate
    warm-up executable would recompile the full-scale program and pin its
    own entry-layout copies of the cubes at many-poltime scale), per-slice
    freeze and argmin bookkeeping, global step numbering. The FULL carried state — params, optimizer state,
    per-slice prev/frozen/nsteps/best and the (step, nbatch) history —
    persists after every ``checkpoint_every`` steps via
    solver.checkpoint.save_state; an interrupted run resumed from the
    latest checkpoint reproduces the uninterrupted trajectory bit-exactly.
    Under a mesh, restored leaves are device_put back onto the shardings
    of the entry arrays (checkpoint files are host-gathered).

    ``checkpoint_dir=None`` runs the same segmented descent without
    persistence — the single-device drivers use this to route EVERY
    batched fit through the auto-layout ``plan`` executables
    (BatchedSegmentPlan). ``plan``, when given, replaces the jit entry
    point; trajectories are identical either way.

    ``steps_per_execution`` bounds the recorded steps of a SINGLE device
    call, independently of how often state persists (``checkpoint_every``
    still sets the save cadence). ``seg_len`` is a traced scalar, so any
    call length up to the compiled segment cap reuses the same
    executable — shorter executions cost only their per-call dispatch,
    no recompiles and no extra checkpoint writes. Use it to keep
    individual device executions under an execution time limit on long
    fits; the trajectory is segmentation-invariant
    (asserted in tests/test_parallel.py)."""
    import datetime
    import os

    from ..solver.checkpoint import latest_checkpoint, load_state, save_state
    from ..utils import echo

    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    dtype = g_r.dtype
    nbatch = g_r.shape[0]
    params = (g_r, g_i) if cfg.freeze_model else (g_r, g_i, fg_r, fg_i)
    # in non-freeze mode the loss reads coefficients from params; pass
    # EMPTY const tuples so params can be donated without aliasing
    fg_rc = fg_r if cfg.freeze_model else ()
    fg_ic = fg_i if cfg.freeze_model else ()
    ckpt_path = (
        latest_checkpoint(checkpoint_dir) if checkpoint_dir is not None else None
    )
    resuming = resume and ckpt_path is not None
    # HBM discipline on resume (observed RESOURCE_EXHAUSTED at full-array
    # scale): every entry buffer the restore supersedes stays device-
    # resident for the whole descent unless we avoid allocating it — on a
    # FRESH run the same buffers are donated into the first segment and
    # freed, which is why fresh runs fit where naive resumes OOM. The
    # optimizer state is the big one (~2x the coefficient set for
    # Adam-family optimizers), so on resume the template is built with
    # eval_shape (no allocation); restored leaves upload at the first
    # segment call. Mesh runs keep a materialized init — its per-leaf
    # shardings are the restore targets — and explicitly delete it after
    # the restore instead.
    opt_state_is_template = False
    if opt_state0 is not None:
        opt_state = opt_state0
    elif resuming and not _multidevice(params):
        opt_state = jax.eval_shape(opt.init, params)
        opt_state_is_template = True
    else:
        opt_state = opt.init(params)
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
    prev = jnp.full((nbatch,), big, dtype=dtype)
    frozen = jnp.zeros((nbatch,), dtype=bool)
    nsteps_slice = jnp.full((nbatch,), cfg.maxsteps, dtype=jnp.int32)
    if cfg.use_min:
        best_loss = jnp.full((nbatch,), big, dtype=dtype)
        best_params = params
    else:
        # argmin tracking off: don't carry (or checkpoint) a duplicate
        # parameter set — see _batched_segment_impl
        best_params = ()
        best_loss = (
            jnp.full((nbatch,), big, dtype=dtype) if cfg.patience > 0 else ()
        )
    since_best = (
        jnp.zeros((nbatch,), dtype=jnp.int32) if cfg.patience > 0 else ()
    )
    history_all = np.zeros((0, nbatch), dtype=np.float32)
    step_total = 0
    warmup_pending = True

    if resuming:
        warmup_pending = False  # the warm-up ran before the first checkpoint
        echo(f"{datetime.datetime.now()} Resuming batched fit from {ckpt_path}",
             verbose=verbose)
        # the checkpoint tree structure depends on use_min ONLY — never on
        # cfg.patience: since_best and the patience-only best_loss are
        # reconstructed from the stored history below, so checkpoints stay
        # loadable across patience-setting changes and code upgrades; a
        # use_min flip across a resume is adapted below rather than refused
        like_tree = {
            "params": params,
            "opt_state": opt_state,
            "best_params": best_params,
            "prev": prev,
            "frozen": frozen,
            "nsteps_slice": nsteps_slice,
            "best_loss": best_loss if cfg.use_min else (),
        }
        stored_use_min = cfg.use_min
        try:
            tree, scal = load_state(ckpt_path, like_tree, ("step", "history"))
        except ValueError as direct_err:
            # the saving run's use_min differed (drivers may couple use_min
            # to patience — e.g. hera_full_demo — so a --patience change
            # across a resume flips it); retry with the flipped structure
            # and adapt below rather than refusing the resume. A checkpoint
            # that matches NEITHER structure (changed nbatch/freeze_model/
            # optimizer, or a corrupt save) fails the retry too — surface
            # the DIRECT attempt's error (the accurate mismatch description)
            # with the retry's chained as context
            stored_use_min = not cfg.use_min
            like_tree = dict(
                like_tree,
                best_params=params if stored_use_min else (),
                best_loss=(
                    jnp.full((nbatch,), big, dtype=dtype)
                    if stored_use_min
                    else ()
                ),
            )
            try:
                tree, scal = load_state(
                    ckpt_path, like_tree, ("step", "history")
                )
            except ValueError as flip_err:
                raise direct_err from flip_err

        def replace_on(like_leaf, leaf):
            # restore each leaf onto the entry array's sharding (mesh runs).
            # Leaves whose template is UNcommitted (host-built prev/frozen/
            # count buffers) must stay uncommitted — device_put would pin
            # them to one device and conflict with mesh-committed chunks.
            if getattr(like_leaf, "committed", False):
                return jax.device_put(leaf, like_leaf.sharding)
            return leaf

        tree = jax.tree_util.tree_map(replace_on, like_tree, tree)
        if opt_state0 is None and not opt_state_is_template:
            # mesh runs materialize opt.init as the restore's sharding
            # template (replace_on above); it is superseded now, and — being
            # locally created — safe to free before the first segment pins
            # the descent's HBM peak
            for leaf in jax.tree_util.tree_leaves(opt_state):
                if isinstance(leaf, jax.Array):
                    leaf.delete()
        params = tree["params"]
        opt_state = tree["opt_state"]
        if cfg.use_min == stored_use_min:
            best_params = tree["best_params"]
        elif cfg.use_min:
            # saved without argmin tracking: restart it at the resume point
            # (a DISTINCT copy — params and best_params are both donated)
            best_params = jax.tree_util.tree_map(jnp.copy, params)
        else:
            # saved WITH argmin tracking, now off — drop the stored copy AND
            # free its device buffers now: `tree` keeps a reference for the
            # whole descent, and a retained param-set-sized block is exactly
            # the superseded-buffer class the HBM discipline above exists to
            # avoid (full-array resumes OOM on retained entry buffers)
            for leaf in jax.tree_util.tree_leaves(tree["best_params"]):
                if isinstance(leaf, jax.Array):
                    leaf.delete()
            tree["best_params"] = ()
        prev = tree["prev"]
        frozen = tree["frozen"]
        # the not-yet-frozen sentinel is the SAVING run's maxsteps; a resume
        # with a larger budget must re-sentinel unfrozen slices or their
        # histories would be trimmed at the old budget
        nsteps_slice = jnp.where(
            frozen, tree["nsteps_slice"], jnp.int32(cfg.maxsteps)
        )
        if cfg.use_min and stored_use_min:
            best_loss = tree["best_loss"]
        # use_min now on but the save lacked argmin state: best_loss stays
        # at `big` (set above) so tracking restarts at the resume point
        history_all = np.asarray(scal["history"], dtype=np.float32).reshape(-1, nbatch)
        step_total = int(scal["step"])
        if cfg.patience > 0 and history_all.shape[0]:
            # reconstruct per-slice steps-since-best (and, without use_min,
            # best_loss) from the stored history: a slice's last strict
            # improvement is the FIRST occurrence of its column minimum.
            # Unfrozen slices record every step, so the row count is their
            # recorded-step count; frozen slices' values are never read.
            # Exact for float32 fits (the history stores f32 casts of the
            # very losses the device compares); for float64 fits the
            # reconstruction is f32-rounded — pair patience with use_min
            # (the recommended combination) for an exactly-carried best_loss.
            h = np.where(np.isfinite(history_all), history_all, np.inf)
            first_min = np.argmin(h, axis=0)
            col_min = h[first_min, np.arange(h.shape[1])]
            ever_improved = np.isfinite(col_min)
            since_best = jnp.asarray(
                np.where(
                    ever_improved, h.shape[0] - 1 - first_min, 0
                ).astype(np.int32)
            )
            if not cfg.use_min:
                best_loss = jnp.asarray(
                    np.where(ever_improved, col_min, float(big)), dtype=dtype
                )
    elif cfg.use_min:
        # DISTINCT buffers: params and best_params are both donated to
        # the segment, and donating the same buffers twice is invalid.
        # Fresh ZEROS, not jnp.copy(params): best_loss enters at `big`,
        # so every unfrozen slice's best is overwritten at its first
        # recorded step and the initial values are never read (fresh
        # entries start with frozen=False, so with maxsteps > 0 every
        # slice records). Copying would also be an EAGER op on the entry
        # params — on the warm-started scan's mixed schedule those are
        # plan outputs with compiler-chosen layouts (see the host-side
        # rule below).
        def _fresh_zeros(x):
            z = jnp.zeros(tuple(x.shape), x.dtype)
            sh = getattr(x, "sharding", None)
            if sh is not None and len(getattr(sh, "device_set", ())) > 1:
                # mesh runs: the segment jit resolves shardings from its
                # arguments — match the params' placement (metadata read
                # only; no eager compute on the source array)
                z = jax.device_put(z, sh)
            return z

        best_params = jax.tree_util.tree_map(_fresh_zeros, params)

    # HOST-SIDE RULE for this loop: no eager jax ops and no lazy slices on
    # the segment outputs — fetch whole arrays (np.asarray) and compute on
    # the host. Plan outputs carry compiler-chosen layouts, and an eager op
    # on such an array has failed (INVALID_ARGUMENT) on a backend before;
    # whole-array transfers are layout-agnostic.
    seg = max(1, min(int(checkpoint_every), cfg.maxsteps))
    cap = seg if steps_per_execution is None else max(
        1, min(int(steps_per_execution), seg)
    )
    since_save = 0

    def save(step_total):
        save_state(
            os.path.join(checkpoint_dir, f"step_{step_total}"),
            {
                # format matches the resume like_tree: use_min-dependent
                # only, never patience-dependent (reconstructed on load)
                "params": params,
                "opt_state": opt_state,
                "best_params": best_params,
                "prev": prev,
                "frozen": frozen,
                "nsteps_slice": nsteps_slice,
                "best_loss": best_loss if cfg.use_min else (),
            },
            {"step": step_total, "history": history_all},
        )
        echo(
            f"{datetime.datetime.now()} checkpointed batched fit at step "
            f"{step_total} ({int(np.asarray(frozen).sum())}/{nbatch} slices frozen)",
            verbose=verbose,
        )

    while step_total < cfg.maxsteps and not bool(np.asarray(frozen).all()):
        seg_len = min(cap, seg - since_save, cfg.maxsteps - step_total)
        if warmup_pending and steps_per_execution is not None:
            # the folded warm-up iteration is a real device step: when the
            # caller bounds execution length, the first call runs
            # seg_len recorded + 1 warm-up iterations, so shrink seg_len
            # to keep the bound honest (cap == 1 degenerates to a
            # warm-up-only execution, handled below)
            seg_len = max(0, seg_len - 1)
        seg_args = (
            chunks, data_r, data_i, wgts, fg_rc, fg_ic, prior_r, prior_i,
            params, opt_state, prev, frozen, nsteps_slice, best_loss,
            best_params, since_best, jnp.asarray(step_total, jnp.int32),
        )
        if plan is not None:
            out = plan.run(seg_len, warmup_pending, seg_args)
        else:
            out = batched_fit_segment(
                cfg, seg, *seg_args,
                jnp.asarray(seg_len, jnp.int32),
                jnp.asarray(1 if warmup_pending else 0, jnp.int32),
            )
        was_warmup = warmup_pending
        warmup_pending = False
        (params, opt_state, prev, frozen, nsteps_slice, best_loss, best_params,
         since_best, hist_seg, nsteps_seg) = out
        nsteps_seg = int(nsteps_seg)
        if nsteps_seg == 0:
            if was_warmup:
                # warm-up-only first execution (steps_per_execution == 1)
                continue
            # every slice frozen on segment entry — nothing more to record
            break
        history_all = np.concatenate(
            [history_all, np.asarray(hist_seg, dtype=np.float32)[:nsteps_seg]]
        )
        if was_warmup and expected_loss0 is not None and len(history_all):
            # step-0 cross-check (fresh runs only — was_warmup is never set
            # on a resume): the first recorded loss must agree with the
            # independently computed initial loss, or an entry buffer was
            # scrambled on its way into the executable's layout
            factor = loss_guard_factor()
            if factor is not None:
                check_initial_loss(
                    history_all[0], expected_loss0, factor,
                    context=" (AOT segment path)" if plan is not None else "",
                )
        step_total += nsteps_seg
        since_save += nsteps_seg
        if since_save >= seg:
            # reset the cadence counter even without persistence so
            # seg - since_save never pins seg_len at zero for callers
            # passing checkpoint_every < maxsteps with no directory.
            # With tail_save=False a cadence save landing exactly at the
            # fit's END is skipped too (when checkpoint_every > maxsteps,
            # seg clamps to maxsteps and the single end-of-fit save
            # arrives through THIS branch, not the tail branch below)
            will_continue = step_total < cfg.maxsteps and not bool(
                np.asarray(frozen).all()
            )
            if checkpoint_dir is not None and (tail_save or will_continue):
                save(step_total)
            since_save = 0
    if checkpoint_dir is not None and since_save > 0 and tail_save:
        # partial tail (early freeze or a sub-checkpoint_every final
        # execution): persist so a resume re-enters at the true end state.
        # ``tail_save=False`` (the warm-started time scan) skips this:
        # there the caller persists its own per-time marker moments later,
        # which supersedes this directory entirely — the tail save costs a
        # full D2H of params+opt_state(+best_params) plus a multi-100-MB
        # disk write per TIME, and durability stays bounded by
        # checkpoint_every (a crash in the marker window redoes at most
        # the partial tail, exactly the periodic-checkpoint guarantee)
        save(step_total)

    nsteps_slice = np.minimum(np.asarray(nsteps_slice), step_total)
    out_params = best_params if cfg.use_min else params
    final = best_loss if cfg.use_min else prev
    if cfg.freeze_model:
        g_r_o, g_i_o = out_params
        fg_r_o, fg_i_o = fg_r, fg_i
    else:
        g_r_o, g_i_o, fg_r_o, fg_i_o = out_params
    full_hist = np.full(
        (max(cfg.maxsteps, len(history_all)), nbatch), np.nan, dtype=np.float32
    )
    full_hist[: len(history_all)] = history_all
    return BatchedFitResult(
        g_r_o, g_i_o, fg_r_o, fg_i_o, jnp.asarray(full_hist),
        jnp.asarray(len(history_all)), final, nsteps_slice, opt_state,
    )


@partial(jax.jit, static_argnums=(0,))
def batched_fit_core(cfg: FitConfig, chunks, data_r, data_i, wgts, g_r, g_i, fg_r, fg_i,
                     prior_r=None, prior_i=None, opt_state0=None):
    """Whole-batch descent in one jit (see solver.fit._fit_core for the
    single-slice variant and the reference-parity notes).

    ``opt_state0`` carries an optimizer state into the descent — used by the
    comps_precision="mixed" schedule so the f32 polish phase keeps the
    Adam-family moments adapted during the bf16 phase (docs/BF16_COMPS.md)."""
    opt, one_step = _batched_step_fn(
        cfg, chunks, data_r, data_i, wgts, fg_r, fg_i, prior_r, prior_i
    )
    dtype = g_r.dtype
    nbatch = g_r.shape[0]
    params0 = (g_r, g_i) if cfg.freeze_model else (g_r, g_i, fg_r, fg_i)
    if opt_state0 is None:
        opt_state0 = opt.init(params0)
    _, params, opt_state = one_step(params0, opt_state0)  # warm-up

    # the (maxsteps, nbatch) history is the one buffer that scales with BOTH
    # the step budget and the batch; store it in float32 regardless of the
    # fit dtype — loss curves don't need f64, and this halves the largest
    # long-lived HBM allocation of multi-hundred-poltime descents
    big = jnp.asarray(9e99 if dtype == jnp.float64 else 3e38, dtype=dtype)
    prev0 = jnp.full((nbatch,), big, dtype=dtype)
    best0 = jnp.full((nbatch,), big, dtype=dtype)
    # per-slice freeze mask: once a slice converges (|delta loss| < tol) or
    # diverges (non-finite loss) its parameters and optimizer state stop
    # moving, matching the reference's per-fit early stop semantics
    # (reference calibration.py:699-717); unconverged slices keep stepping
    frozen0 = jnp.zeros((nbatch,), dtype=bool)
    nsteps0 = jnp.full((nbatch,), cfg.maxsteps, dtype=jnp.int32)
    since0 = jnp.zeros((nbatch,), dtype=jnp.int32)
    (params, opt_state_f, last, frozen, nsteps_slice, best_loss, best_params,
     _, history, step) = _batched_segment_impl(
        cfg, cfg.maxsteps, one_step, nbatch, dtype, params, opt_state,
        prev0, frozen0, nsteps0, best0, params, since0,
        jnp.asarray(0, jnp.int32),
    )
    nsteps_slice = jnp.minimum(nsteps_slice, step)
    out_params = best_params if cfg.use_min else params
    final = best_loss if cfg.use_min else last
    if cfg.freeze_model:
        g_r_o, g_i_o = out_params
        fg_r_o, fg_i_o = fg_r, fg_i
    else:
        g_r_o, g_i_o, fg_r_o, fg_i_o = out_params
    return BatchedFitResult(g_r_o, g_i_o, fg_r_o, fg_i_o, history, step, final,
                            nsteps_slice, opt_state_f)
