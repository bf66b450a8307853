"""Discrete prolate spheroidal sequence (DPSS) foreground basis.

In-repo replacement for ``hera_filters.dspec.dpss_operator`` (used by the
reference at modeling.py:294), which is a git-only dependency of the
reference and is not available here. Given a frequency axis and a delay
half-width W (seconds), the basis is the set of Slepian sequences: the
eigenvectors of the spectral concentration operator

    rho[m, n] = 2 W df sinc(2 W (f_m - f_n))        (uniform sampling)

whose concentration eigenvalues lie in [0, 1]. Vectors with eigenvalue
>= ``eigenval_cutoff`` span (to that tolerance) every spectrum whose delay
transform is confined to |tau| <= W — exactly the smooth-foreground subspace
the calibration fits per baseline.

For uniformly sampled frequencies the vectors come from the classical
commuting tridiagonal operator (Slepian 1978), solved with LAPACK's MRRR
driver — the stable formulation scipy.signal.windows.dpss uses, minus its
driver choice and standardization overhead (~3x at HERA band sizes, and
this is the host-side cost that scales with the number of distinct
baseline lengths). For non-uniform sampling we fall back to a dense
symmetric eigendecomposition. All generation is float64 host-side numpy
(the basis is built once per distinct delay width, outside the descent);
the resulting basis matrices are cast to the solve dtype when packed on
device.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import eigh_tridiagonal


def _freqs_key(freqs, half_width, eigenval_cutoff):
    freqs = np.asarray(freqs, dtype=np.float64)
    return (
        freqs.shape[0],
        float(freqs[0]),
        float(freqs[-1]),
        round(float(half_width) * 1e17),
        float(eigenval_cutoff),
    )


def _is_uniform(freqs, rtol=1e-6):
    df = np.diff(freqs)
    return np.allclose(df, df[0], rtol=rtol, atol=0.0)


def _concentration_matrix(freqs, half_width):
    """rho[m,n] = 2 W df sinc(2 W (f_m - f_n)) — symmetric, eigenvalues in [0,1]."""
    freqs = np.asarray(freqs, dtype=np.float64)
    df = float(np.mean(np.diff(freqs)))
    dmat = freqs[:, None] - freqs[None, :]
    return 2.0 * half_width * df * np.sinc(2.0 * half_width * dmat)


def _slepian_vectors(nf, nw, kmax):
    """Top-``kmax`` Slepian sequences of the (N=nf, NW=nw) concentration
    problem, most-concentrated first, shape (nf, kmax).

    Eigenvectors of the tridiagonal operator that commutes with the
    concentration matrix (Slepian 1978):
        d[m] = ((N-1-2m)/2)^2 cos(2 pi W),   e[m] = m (N-m) / 2
    Its eigenvector order matches the concentration order, so the top of
    its spectrum IS the top of the DPSS family. The MRRR driver ("stemr")
    computes the partial spectrum in ~half the time of the bisection+
    inverse-iteration driver scipy's dpss window picks for subset solves
    (measured 0.48 s vs 1.40 s at N=1536, K=324 — and the full band has
    to be solved once per distinct baseline length)."""
    m = np.arange(nf, dtype=np.float64)
    w = nw / nf
    d = ((nf - 1.0 - 2.0 * m) / 2.0) ** 2 * np.cos(2.0 * np.pi * w)
    e = m[1:] * (nf - m[1:]) / 2.0
    _, v = eigh_tridiagonal(
        d, e, select="i", select_range=(nf - kmax, nf - 1), lapack_driver="stemr"
    )
    return v[:, ::-1]


def _toeplitz_quadratic_evals(vecs, nf, df, half_width):
    """Concentration eigenvalues lambda_k = v_k^T rho v_k for a UNIFORM grid.

    rho is Toeplitz with first row r[m] = 2 W df sinc(2 W df m). Embedding
    rho in a 2N circulant C = F^H diag(fft(c)) F / 2N turns the quadratic
    form into a Parseval sum over one batched rfft of the zero-padded
    vectors — O(K N log N) with no O(N^2) matrix and no inverse
    transform. Essential when thousands of distinct baseline lengths each
    need their own operator (e.g. 2000+ baselines x 1536 channels).
    ``vecs`` is (K, nf)."""
    m = np.arange(nf, dtype=np.float64)
    r = 2.0 * half_width * df * np.sinc(2.0 * half_width * df * m)
    # first column of the 2N circulant embedding (symmetric: = first row)
    c = np.concatenate([r, [0.0], r[:0:-1]])
    fc = np.fft.rfft(c).real  # symmetric c -> real spectrum
    vpad = np.zeros((vecs.shape[0], 2 * nf))
    vpad[:, :nf] = vecs
    power = np.abs(np.fft.rfft(vpad, axis=1)) ** 2
    # full-spectrum sum from the half spectrum: double interior bins
    wgt = np.full(nf + 1, 2.0)
    wgt[0] = wgt[-1] = 1.0
    return (power @ (fc * wgt)) / (2.0 * nf)


def dpss_operator(freqs, filter_half_width, eigenval_cutoff=1e-10, cache=None):
    """DPSS basis matrix for one delay half-width.

    Parameters
    ----------
    freqs : array (Nfreqs,), Hz
    filter_half_width : float, seconds — delay half-width W of the subspace
    eigenval_cutoff : float — keep vectors with concentration >= this value
    cache : dict, optional — operator cache shared across baselines
        (reference parity: the ``operator_cache`` threading at
        modeling.py:291-300)

    Returns
    -------
    amat : float64 array (Nfreqs, Nterms), columns ordered by decreasing
        concentration eigenvalue
    evals : float64 array (Nterms,), the concentration eigenvalues
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    nf = len(freqs)
    key = _freqs_key(freqs, filter_half_width, eigenval_cutoff)
    if cache is not None and key in cache:
        return cache[key]

    df = float(np.mean(np.diff(freqs))) if nf > 1 else 1.0
    nw = nf * df * filter_half_width  # half time-bandwidth product

    if 2.0 * filter_half_width * df >= 1.0:
        # Bandlimit covers the full Nyquist range: every spectrum is in the
        # subspace; the basis is the identity.
        amat = np.eye(nf)
        evals = np.ones(nf)
    elif _is_uniform(freqs) and nw < nf / 2.0 - 1.0:
        # Significant eigenvalue count is ~2*NW; take a margin so the
        # smallest returned eigenvalue is far below any sane cutoff.
        kmax = int(min(nf, np.ceil(2.0 * nw) + 35))
        vecs = _slepian_vectors(nf, nw, kmax)  # (nf, kmax)
        evals = _toeplitz_quadratic_evals(vecs.T, nf, df, filter_half_width)
        keep = evals >= eigenval_cutoff
        if keep.all() and kmax < nf:
            # margin was insufficient for this cutoff: use the dense path
            w, v = np.linalg.eigh(_concentration_matrix(freqs, filter_half_width))
            w = w[::-1]
            v = v[:, ::-1]
            keep = w >= eigenval_cutoff
            amat = v[:, keep]
            evals = w[keep]
        else:
            amat = vecs[:, keep]
            evals = evals[keep]
    else:
        rho = _concentration_matrix(freqs, filter_half_width)
        w, v = np.linalg.eigh(rho)
        w = w[::-1]
        v = v[:, ::-1]
        keep = w >= eigenval_cutoff
        amat = v[:, keep]
        evals = w[keep]

    result = (amat, evals)
    if cache is not None:
        cache[key] = result
    return result


def dpss_basis(freqs, filter_half_width, eigenval_cutoff=1e-10, cache=None):
    """Basis matrix only (Nfreqs, Nterms)."""
    return dpss_operator(freqs, filter_half_width, eigenval_cutoff, cache)[0]
