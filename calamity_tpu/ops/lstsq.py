"""Batched masked least-squares warm start for foreground coefficients.

Reference parity: tensorize_fg_coeffs (calibration.py:828-913) initializes
each fitting group's coefficients by ``tf.linalg.lstsq`` of the (binary-
weight-masked) data against the group's nonzero basis columns, one host
loop iteration per group.

Redesign: one batched normal-equation solve per chunk —
``c = (A^T A + ridge I)^{-1} A^T (d * binwgt)`` with zero-padded basis
columns masked out. Basis matrices have orthonormal columns (DPSS /
covariance eigenvectors), so A^T A is ~identity and the normal equations
are perfectly conditioned even in float32; the ridge only regularizes the
all-zero padded columns. A Cholesky solve batched over groups replaces the
reference's per-group host loop entirely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("ridge",))
def gram_cholesky_chunk(comps, ridge=1e-6):
    """Cholesky factor of the (static) normal-equation gram per group.

    The gram A^T A depends only on the basis matrices, not the data — the
    reference's per-fit lstsq re-factors it for every (time, pol) slice
    (calibration.py:893-904); computing it once per FitSpec removes an
    O(ngrps * nfreqs * nvecs^2) cost from every fit. Zero-padded columns
    get unit diagonal (block decoupling, see init_coeffs_chunk)."""
    ngrps, nbls, nfreqs, nvecs = comps.shape
    amat = comps.reshape(ngrps, nbls * nfreqs, nvecs)
    gram = jnp.einsum(
        "gnv,gnw->gvw", amat, amat,
        preferred_element_type=amat.dtype, precision=jax.lax.Precision.HIGHEST,
    )
    col_norm = jnp.sum(jnp.square(amat), axis=1)
    active = (col_norm > 0).astype(amat.dtype)
    scale = jnp.max(col_norm, axis=1, keepdims=True)
    diag_add = jnp.where(active > 0, ridge * scale, 1.0)
    eye = jnp.eye(nvecs, dtype=amat.dtype)
    gram = gram + eye * diag_add[..., None, :]
    return jax.scipy.linalg.cholesky(gram, lower=True), active


@jax.jit
def init_coeffs_from_cholesky(chol, active, comps, data, wgts):
    """Warm-start coefficients using a precomputed gram factor.

    Supports shared-basis chunks (comps group dim 1, data carrying ngrps
    groups): the rhs becomes one matmul against the shared matrix and the
    triangular solves batch over groups."""
    ngrps_c, nbls, nfreqs, nvecs = comps.shape
    ngrps = data.shape[0]
    binw = (wgts != 0).astype(data.dtype)
    dvec = (data * binw).reshape(ngrps, nbls * nfreqs)
    if ngrps_c == 1 and ngrps > 1:
        amat0 = comps.reshape(nbls * nfreqs, nvecs)
        rhs = jnp.einsum(
            "nv,gn->gv", amat0, dvec,
            preferred_element_type=amat0.dtype, precision=jax.lax.Precision.HIGHEST,
        )
        chol0 = chol.reshape(nvecs, nvecs)
        y = jax.scipy.linalg.solve_triangular(chol0, rhs.T, lower=True)
        x = jax.scipy.linalg.solve_triangular(chol0.T, y, lower=False)
        return x.T * active.reshape(1, nvecs)
    if 1 < ngrps_c < ngrps:
        # shared-batched: blocks of gmax groups share each operator
        nu = ngrps_c
        gmax = ngrps // nu
        amat = comps.reshape(nu, nbls * nfreqs, nvecs)
        dblk = dvec.reshape(nu, gmax, nbls * nfreqs)
        rhs = jnp.einsum(
            "unv,ugn->ugv", amat, dblk,
            preferred_element_type=amat.dtype, precision=jax.lax.Precision.HIGHEST,
        )  # (nu, gmax, nvecs)
        y = jax.scipy.linalg.solve_triangular(
            chol, jnp.swapaxes(rhs, 1, 2), lower=True
        )  # (nu, nvecs, gmax)
        x = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(chol, 1, 2), y, lower=False
        )
        coeffs = jnp.swapaxes(x, 1, 2).reshape(ngrps, nvecs)
        return coeffs * jnp.repeat(active, gmax, axis=0)
    amat = comps.reshape(ngrps, nbls * nfreqs, nvecs)
    rhs = jnp.einsum(
        "gnv,gn->gv", amat, dvec,
        preferred_element_type=amat.dtype, precision=jax.lax.Precision.HIGHEST,
    )
    coeffs = jax.scipy.linalg.cho_solve((chol, True), rhs[..., None])[..., 0]
    return coeffs * active


@jax.jit
def init_coeffs_from_cholesky_batched(chol, active, comps, data_r, data_i, wgts):
    """Warm-start coefficients for a whole (time, pol) slice batch at once.

    data_r/data_i/wgts: (nbatch, ngrps, nbls, nfreqs) — typically the
    already-uploaded stacked fit tensors, so the init adds ZERO extra
    host->device transfers (the per-slice init path re-uploads each
    slice's cube, which at 331 ants x 1536 ch x many times doubles
    transfer volume). Returns
    (coeffs_r, coeffs_i), each (nbatch, ngrps, nvecs)."""
    return jax.vmap(
        lambda dr, di, w: (
            init_coeffs_from_cholesky(chol, active, comps, dr, w),
            init_coeffs_from_cholesky(chol, active, comps, di, w),
        )
    )(data_r, data_i, wgts)


@partial(jax.jit, static_argnames=("blk",))
def blocked_init_from_data(chol, active, comps, data_r, data_i, wgts, blk):
    """Batched warm-start init + prior/weight sums over group blocks,
    entirely inside ONE jit.

    The init source is the already-uploaded data cube itself (the
    identity-gains sky alias, or no sky model): a host-side block loop
    would either re-upload the cube (doubling transfer volume) or eagerly
    slice the device cube into separately allocated block copies. Here
    lax.scan dynamic-slices the resident cubes inside the compiled
    program, so the only device memory beyond the operands is one block's
    transients. Shared / shared-batched
    chunks slice the operator axis on class boundaries (``blk`` must be
    a multiple of gmax — _loss_block_size guarantees it).

    Returns (coeffs_r, coeffs_i, wsum, prior_r, prior_i); the sums are
    per-batch-slice, computed with bf16 weights upcast like the loss."""
    nbatch, ngrps, nbls, nfreqs = data_r.shape
    nu = comps.shape[0]
    nblk = ngrps // blk
    gmax = ngrps // nu if 1 < nu < ngrps else 1

    def body(carry, i):
        wsum, pr, pi = carry
        g0 = i * blk
        dr = jax.lax.dynamic_slice_in_dim(data_r, g0, blk, axis=1)
        di = jax.lax.dynamic_slice_in_dim(data_i, g0, blk, axis=1)
        w = jax.lax.dynamic_slice_in_dim(wgts, g0, blk, axis=1)
        if w.dtype != dr.dtype:
            w = w.astype(dr.dtype)
        if nu == 1:
            comps_b, chol_b, act_b = comps, chol, active
        elif nu < ngrps:
            u0 = g0 // gmax
            comps_b = jax.lax.dynamic_slice_in_dim(comps, u0, blk // gmax, axis=0)
            chol_b = jax.lax.dynamic_slice_in_dim(chol, u0, blk // gmax, axis=0)
            act_b = jax.lax.dynamic_slice_in_dim(active, u0, blk // gmax, axis=0)
        else:
            comps_b = jax.lax.dynamic_slice_in_dim(comps, g0, blk, axis=0)
            chol_b = jax.lax.dynamic_slice_in_dim(chol, g0, blk, axis=0)
            act_b = jax.lax.dynamic_slice_in_dim(active, g0, blk, axis=0)
        cr, ci = init_coeffs_from_cholesky_batched(chol_b, act_b, comps_b, dr, di, w)
        wsum = wsum + jnp.sum(w, axis=(1, 2, 3))
        pr = pr + jnp.sum(dr * w, axis=(1, 2, 3))
        pi = pi + jnp.sum(di * w, axis=(1, 2, 3))
        return (wsum, pr, pi), (cr, ci)

    zero = jnp.zeros((nbatch,), data_r.dtype)
    (wsum, pr, pi), (crs, cis) = jax.lax.scan(
        body, (zero, zero, zero), jnp.arange(nblk)
    )
    # (nblk, nbatch, blk, nvec) -> (nbatch, ngrps, nvec)
    cr = jnp.moveaxis(crs, 0, 1).reshape(nbatch, ngrps, crs.shape[-1])
    ci = jnp.moveaxis(cis, 0, 1).reshape(nbatch, ngrps, cis.shape[-1])
    return cr, ci, wsum, pr, pi


@partial(jax.jit, static_argnames=("ridge",))
def init_coeffs_chunk(comps, data, wgts, ridge=1e-6):
    """Least-squares coefficients for one chunk.

    comps: (ngrps, nbls, nfreqs, nvecs), data/wgts: (ngrps, nbls, nfreqs)
    returns coeffs (ngrps, nvecs).

    Zero-padded basis columns have identically-zero gram rows/cols; their
    diagonal is set to exactly 1 so the system is block-decoupled (the
    padded block solves to rhs = 0) and the condition number stays ~1,
    which keeps the Cholesky accurate in float32. A small relative ridge on
    the active block guards near-degenerate columns."""
    ngrps, nbls, nfreqs, nvecs = comps.shape
    amat = comps.reshape(ngrps, nbls * nfreqs, nvecs)
    binw = (wgts != 0).astype(data.dtype)
    dvec = (data * binw).reshape(ngrps, nbls * nfreqs)
    # HIGHEST precision: at default precision a GPU may run float32
    # contractions in TF32 (~1e-3 relative error), which corrupts the solve
    gram = jnp.einsum(
        "gnv,gnw->gvw", amat, amat,
        preferred_element_type=amat.dtype, precision=jax.lax.Precision.HIGHEST,
    )
    rhs = jnp.einsum(
        "gnv,gn->gv", amat, dvec,
        preferred_element_type=amat.dtype, precision=jax.lax.Precision.HIGHEST,
    )
    col_norm = jnp.sum(jnp.square(amat), axis=1)  # (ngrps, nvecs)
    active = (col_norm > 0).astype(amat.dtype)
    scale = jnp.max(col_norm, axis=1, keepdims=True)  # (ngrps, 1)
    diag_add = jnp.where(active > 0, ridge * scale, 1.0)  # (ngrps, nvecs)
    eye = jnp.eye(nvecs, dtype=amat.dtype)
    gram = gram + eye * diag_add[..., None, :]
    coeffs = jax.scipy.linalg.cho_solve(
        (jax.scipy.linalg.cholesky(gram, lower=True), True), rhs[..., None]
    )[..., 0]
    return coeffs * active
