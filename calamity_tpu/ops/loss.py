"""Forward visibility model and weighted chi-square loss (pure jnp).

Math parity with reference calibration.py:1587-1656:

- The foreground model per chunk is a *batched matvec*
  ``einsum('gbfv,gv->gbf', comps, coeffs)`` over padded dense tensors of
  shape (ngrps, nbls, nfreqs, nvecs) — one dot_general for XLA — instead of
  the reference's broadcast-multiply-reduce over an (nvecs, ngrps, nbls,
  nfreqs) layout (calibration.py:1587-1590), which reads nvecs x the model
  size from memory.
- Complex arithmetic is expanded into real products exactly as the
  reference does (calibration.py:1593-1605): model = g_i conj(g_j) V.
- Antenna gains are gathered by index with jnp.take along the antenna axis;
  gains are small (Nants x Nfreqs) and replicated across shards, so the
  gather and its scatter-add transpose stay cheap and local.

Everything here is shape-polymorphic and jit/vmap/pjit friendly; chunk
structure (a tuple of differently-shaped pytrees) is unrolled at trace time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fg_model(coeffs_r, coeffs_i, comps, precision=jax.lax.Precision.HIGHEST):
    """Foreground visibilities from basis coefficients.

    comps: (ngrps, nbls, nfreqs, nvecs); coeffs: (ngrps, nvecs)
    returns (vr, vi) each (ngrps, nbls, nfreqs).

    The real and imaginary coefficient vectors are stacked into ONE
    contraction so the dominant HBM traffic — reading comps, by far the
    largest tensor — happens once per evaluation instead of twice, in both
    the forward pass and its transpose (the coefficient-gradient
    contraction). The step is HBM-bound at scale, so this halves the
    per-step memory traffic.

    precision: at default precision a GPU may run float32 contractions in
    TF32 (about three decimal digits), which poisons the convergence floor
    of the chi-square fit. HIGHEST keeps full f32 accuracy.

    Shared-basis chunks: when comps has a leading group dim of 1 but the
    coefficients carry ngrps > 1 groups, every group shares the single
    basis matrix (redundant arrays: one DPSS operator per unique baseline
    length). The contraction becomes one dense (2*ngrps, nvecs) x (nvecs,
    nfreqs) matmul — comps is read from HBM once for ALL of its baselines,
    cutting the dominant traffic by the redundancy factor.

    bfloat16 comps: storing comps in bf16 halves the bytes of the dominant
    tensor (docs/BF16_COMPS.md); the upcast to the coefficient dtype below
    happens on device and accumulation stays f32."""
    if comps.dtype != coeffs_r.dtype:
        comps = comps.astype(coeffs_r.dtype)
    coeffs = jnp.stack([coeffs_r, coeffs_i], axis=0)  # (2, ngrps, nvecs)
    ngrps = coeffs.shape[1]
    nu = comps.shape[0]
    if nu == 1 and ngrps > 1:
        # shared basis: (F, V) contracted against all groups at once
        v = jnp.einsum(
            "bfv,kgv->kgbf", comps[0], coeffs,
            preferred_element_type=comps.dtype, precision=precision,
        )
        return v[0], v[1]
    if 1 < nu < ngrps:
        # shared-BATCHED basis: ngrps = nu * gmax groups arranged so that
        # each block of gmax consecutive groups shares operator u — one
        # batched (F, V) x (V, 2*gmax) matmul per unique operator instead
        # of one chunk per operator (keeps the compiled program ~O(buckets)
        # for arrays with thousands of unique spacings)
        gmax = ngrps // nu
        c = coeffs.reshape(2, nu, gmax, coeffs.shape[-1])
        v = jnp.einsum(
            "ubfv,kugv->kugbf", comps, c,
            preferred_element_type=comps.dtype, precision=precision,
        )
        v = v.reshape(2, ngrps, comps.shape[1], comps.shape[2])
        return v[0], v[1]
    v = jnp.einsum(
        "gbfv,kgv->kgbf", comps, coeffs,
        preferred_element_type=comps.dtype, precision=precision,
    )
    return v[0], v[1]


def fg_model_batched(coeffs_r, coeffs_i, comps, precision=jax.lax.Precision.HIGHEST):
    """Foreground model for a BATCH of (time, pol) slices sharing one basis.

    coeffs: (nbatch, ngrps, nvecs); comps as in fg_model. Returns (vr, vi)
    each (nbatch, ngrps, nbls, nfreqs).

    ONE contraction reads comps once for ALL slices — batching over slices
    widens the matvec's right-hand side instead of re-reading the dominant
    tensor per slice (vmapping the single-slice einsum would also upcast a
    bf16 basis once per slice)."""
    if comps.dtype != coeffs_r.dtype:
        comps = comps.astype(coeffs_r.dtype)
    cb = jnp.stack([coeffs_r, coeffs_i], axis=1)  # (nbatch, 2, ngrps, nvecs)
    ngrps = coeffs_r.shape[1]
    nu = comps.shape[0]
    if nu == 1 and ngrps > 1:
        v = jnp.einsum(
            "bfv,nkgv->nkgbf", comps[0], cb,
            preferred_element_type=coeffs_r.dtype, precision=precision,
        )
    elif 1 < nu < ngrps:
        gmax = ngrps // nu
        c = cb.reshape(cb.shape[0], 2, nu, gmax, cb.shape[-1])
        v = jnp.einsum(
            "ubfv,nkugv->nkugbf", comps, c,
            preferred_element_type=coeffs_r.dtype, precision=precision,
        )
        v = v.reshape(cb.shape[0], 2, ngrps, comps.shape[1], comps.shape[2])
    else:
        v = jnp.einsum(
            "gbfv,nkgv->nkgbf", comps, cb,
            preferred_element_type=coeffs_r.dtype, precision=precision,
        )
    return v[:, 0], v[:, 1]


def fg_model_host(coeffs_r, coeffs_i, comps):
    """numpy mirror of :func:`fg_model` for write-back.

    Reconstructing the fitted foreground model is an OUTPUT step, not a
    descent step: computing it on the device and fetching the result moves
    (ngrps, nbls, nfreqs) cubes over the host link per (time, pol) slice —
    ~0.7 GB each at full-HERA scale. The coefficients are tiny and the
    basis tensors transfer ONCE (cached by the caller), so the host einsum
    moves far fewer bytes. Same three packings as fg_model (dense /
    shared / shared-batched); float32 BLAS contractions."""
    import numpy as np

    comps = np.asarray(comps)
    cr = np.asarray(coeffs_r, dtype=comps.dtype)
    ci = np.asarray(coeffs_i, dtype=comps.dtype)
    ngrps = cr.shape[0]
    nu = comps.shape[0]
    if nu == 1 and ngrps > 1:
        vr = np.einsum("bfv,gv->gbf", comps[0], cr, optimize=True)
        vi = np.einsum("bfv,gv->gbf", comps[0], ci, optimize=True)
    elif 1 < nu < ngrps:
        gmax = ngrps // nu
        crr = cr.reshape(nu, gmax, cr.shape[-1])
        cii = ci.reshape(nu, gmax, ci.shape[-1])
        nb, nf = comps.shape[1], comps.shape[2]
        vr = np.einsum("ubfv,ugv->ugbf", comps, crr, optimize=True)
        vi = np.einsum("ubfv,ugv->ugbf", comps, cii, optimize=True)
        vr = vr.reshape(ngrps, nb, nf)
        vi = vi.reshape(ngrps, nb, nf)
    else:
        vr = np.einsum("gbfv,gv->gbf", comps, cr, optimize=True)
        vi = np.einsum("gbfv,gv->gbf", comps, ci, optimize=True)
    return vr, vi


def fg_model_all_chunks_host(fg_r, fg_i, host_comps):
    """Per-chunk host foreground models (write-back counterpart of
    fg_model_all_chunks; ``host_comps`` is a list of numpy basis tensors —
    fetch each chunk's comps once and reuse across slices)."""
    return [
        fg_model_host(fg_r[cnum], fg_i[cnum], comps)
        for cnum, comps in enumerate(host_comps)
    ]


def _basis_transpose_host(dv, comps):
    """Coefficient cotangent of fg_model_host: contract a (ngrps, nbls,
    nfreqs) cotangent against the basis in each of its three packings."""
    import numpy as np

    ngrps = dv.shape[0]
    nu = comps.shape[0]
    if nu == 1 and ngrps > 1:
        return np.einsum("bfv,gbf->gv", comps[0], dv, optimize=True)
    if 1 < nu < ngrps:
        gmax = ngrps // nu
        dvb = dv.reshape((nu, gmax) + dv.shape[1:])
        return np.einsum("ubfv,ugbf->ugv", comps, dvb, optimize=True).reshape(
            ngrps, comps.shape[-1]
        )
    return np.einsum("gbfv,gbf->gv", comps, dv, optimize=True)


def chi_square_host(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts):
    """float64 numpy reference of :func:`chunked_loss` and its gradient.

    Independent of the device path: the foreground model is
    :func:`fg_model_host` evaluated in float64 and the gradient is the
    closed-form derivative of the weighted chi-square. Arguments are as for
    chunked_loss (bfloat16 basis tensors are compared at their stored
    values). Returns ``(loss, (dg_r, dg_i, dfg_r, dfg_i))`` with ``dfg_*``
    a list per chunk."""
    import numpy as np

    def f64(x):
        return np.asarray(x).astype(np.float64)

    g_r, g_i = f64(g_r), f64(g_i)
    nfreqs = g_r.shape[1]
    dg_r = np.zeros_like(g_r)
    dg_i = np.zeros_like(g_i)
    dfg_r, dfg_i = [], []
    total = 0.0
    for cnum, (comps, a0, a1) in enumerate(chunks):
        comps = f64(comps)
        a0 = np.asarray(a0)
        a1 = np.asarray(a1)
        vr, vi = fg_model_host(f64(fg_r[cnum]), f64(fg_i[cnum]), comps)
        gr0, gr1, gi0, gi1 = g_r[a0], g_r[a1], g_i[a0], g_i[a1]
        pr = gr0 * gr1 + gi0 * gi1
        pi = gr0 * gi1 - gi0 * gr1
        er = f64(data_r[cnum]) - (pr * vr + pi * vi)
        ei = f64(data_i[cnum]) - (-pi * vr + pr * vi)
        w = f64(wgts[cnum])
        total += float(np.sum(w * (er * er + ei * ei)))
        # d loss / d model, then back through model = p * v
        mr = -2.0 * w * er
        mi = -2.0 * w * ei
        dfg_r.append(_basis_transpose_host(pr * mr - pi * mi, comps))
        dfg_i.append(_basis_transpose_host(pi * mr + pr * mi, comps))
        dpr = mr * vr + mi * vi
        dpi = mr * vi - mi * vr
        for acc, idx, val in (
            (dg_r, a0, dpr * gr1 + dpi * gi1),
            (dg_r, a1, dpr * gr0 - dpi * gi0),
            (dg_i, a0, dpr * gi1 - dpi * gr1),
            (dg_i, a1, dpr * gi0 + dpi * gr0),
        ):
            np.add.at(acc, idx.ravel(), val.reshape(-1, nfreqs))
    return total, (dg_r, dg_i, dfg_r, dfg_i)


def host_chunk_comps(chunks):
    """Fetch each chunk's (float32) basis tensor to the host, once per fit —
    the input contract of fg_model_all_chunks_host."""
    import numpy as np

    return [np.asarray(c) for (c, _, _) in chunks]


def gain_products(g_r, g_i, a0, a1):
    """Real-arithmetic expansion of g_i conj(g_j) per baseline.

    g_r/g_i: (nants, nfreqs); a0/a1: (ngrps, nbls) int32.
    Returns (grgr+gigi, grgi-gigr) = (Re, -Im) of g_i conj(g_j),
    each (ngrps, nbls, nfreqs).
    """
    gr0 = jnp.take(g_r, a0, axis=0)
    gr1 = jnp.take(g_r, a1, axis=0)
    gi0 = jnp.take(g_i, a0, axis=0)
    gi1 = jnp.take(g_i, a1, axis=0)
    pr = gr0 * gr1 + gi0 * gi1  # Re(g0 conj(g1)) with conj on ant1
    pi = gr0 * gi1 - gi0 * gr1  # such that model_r = pr*vr + pi*vi
    return pr, pi


def data_model(g_r, g_i, coeffs_r, coeffs_i, comps, a0, a1):
    """Gain-corrupted foreground model (reference data_model, calibration.py:1593-1605)."""
    pr, pi = gain_products(g_r, g_i, a0, a1)
    vr, vi = fg_model(coeffs_r, coeffs_i, comps)
    model_r = pr * vr + pi * vi
    model_i = -pi * vr + pr * vi
    return model_r, model_i


def mse(model_r, model_i, data_r, data_i, wgts):
    """Flag-weighted squared error (reference mse, calibration.py:1608-1609).

    bfloat16 weights (wgts_precision="bfloat16"): the upcast below fuses
    into the multiply's operand read, so the weights cube streams from HBM
    at half width; accumulation stays in the model dtype."""
    if wgts.dtype != model_r.dtype:
        wgts = wgts.astype(model_r.dtype)
    return jnp.sum((jnp.square(data_r - model_r) + jnp.square(data_i - model_i)) * wgts)


def _chunk_term(g_r, g_i, fr, fi, comps, a0, a1, dr, di, w):
    model_r, model_i = data_model(g_r, g_i, fr, fi, comps, a0, a1)
    return mse(model_r, model_i, dr, di, w)


_chunk_term_remat = jax.checkpoint(_chunk_term)


def chunked_loss(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, remat=False):
    """Sum of per-chunk weighted chi-square (reference mse_chunked, calibration.py:1612-1620).

    chunks: tuple of (comps, a0, a1) triples; fg_r/fg_i/data_*/wgts: matching tuples.

    ``remat`` wraps each chunk's term in jax.checkpoint so the backward pass
    recomputes the foreground model instead of saving (ngrps, nbls, nfreqs)
    activations per chunk — the standard memory/FLOPs trade that lets
    full-array fits (tens of thousands of baselines x full band) stay within
    single-chip HBM.
    """
    total = jnp.zeros((), dtype=g_r.dtype)
    term = _chunk_term_remat if remat else _chunk_term
    for cnum, (comps, a0, a1) in enumerate(chunks):
        total = total + term(
            g_r, g_i, fg_r[cnum], fg_i[cnum], comps, a0, a1,
            data_r[cnum], data_i[cnum], wgts[cnum],
        )
    return total


def chunked_loss_sum_regularized(
    g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, prior_r_sum, prior_i_sum
):
    """Chi-square plus the "sum" flux-scale prior
    (reference mse_chunked_sum_regularized, calibration.py:1623-1656):
    penalizes deviation of the weighted model flux sums from the sky-model
    prior sums, pinning the overall amplitude/phase degeneracy."""
    total = jnp.zeros((), dtype=g_r.dtype)
    mr_sum = jnp.zeros((), dtype=g_r.dtype)
    mi_sum = jnp.zeros((), dtype=g_r.dtype)
    for cnum, (comps, a0, a1) in enumerate(chunks):
        model_r, model_i = data_model(g_r, g_i, fg_r[cnum], fg_i[cnum], comps, a0, a1)
        w = wgts[cnum]
        if w.dtype != model_r.dtype:
            w = w.astype(model_r.dtype)
        mr_sum = mr_sum + jnp.sum(model_r * w)
        mi_sum = mi_sum + jnp.sum(model_i * w)
        total = total + mse(model_r, model_i, data_r[cnum], data_i[cnum], w)
    return total + jnp.square(mr_sum - prior_r_sum) + jnp.square(mi_sum - prior_i_sum)


def fg_model_all_chunks(fg_r, fg_i, chunks):
    """Per-chunk foreground model arrays (for write-back and SNR weights)."""
    out = []
    for cnum, (comps, _, _) in enumerate(chunks):
        out.append(fg_model(fg_r[cnum], fg_i[cnum], comps))
    return out
