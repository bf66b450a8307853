"""Analytic multi-baseline flat-sky covariance and its eigenbasis.

Behavior parity with reference simple_cov.py:7-182: the covariance between
stacked (baseline, frequency) samples is a product of sinc factors from a
flat-spectrum, horizon-limited sky plus intrinsic antenna chromaticity:

    C[(b,f),(b',f')] = sinc(2 max(|u_bf - u_b'f'| * horizon + dnu*offset,
                              min_dly * dnu)) * sinc(2 dnu * ant_dly)

with u in wavelengths-like units (uvw * f / c) and dnu in GHz-scaled units
(reference divides by 1e9).

The device path (``use_jax=True``) replaces the reference's TensorFlow-GPU
branch (simple_cov.py:62-93, tf.linalg.eigh at 171): the matrix build is a
jit-compiled XLA program and the eigendecomposition uses
jnp.linalg.eigh. The matrices are built once, not in the hot loop, so the
default host numpy path is the plain choice; which side wins at a given
matrix size on a given device is not measured here.
"""

from __future__ import annotations

import datetime
from functools import partial

import numpy as np

from ..utils import echo

C_MS = 3e8  # match the reference's c = 3e8 (modeling.py:168-180, simple_cov.py:67)


def _cov_numpy(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype):
    nbls = uvws.shape[0]
    nfreqs = len(freqs)
    absdiff = np.zeros((nbls * nfreqs, nbls * nfreqs), dtype=dtype)
    for k in range(3):
        coord = np.outer(uvws[:, k], freqs / C_MS).reshape(nbls * nfreqs)
        absdiff += np.abs(coord[:, None] - coord[None, :]) ** 2.0
    absdiff = np.sqrt(absdiff) * horizon
    fvals = np.tile(freqs, nbls)
    dfg = np.abs(fvals[:, None] - fvals[None, :]) / 1e9
    absdiff += dfg * offset
    cmat = np.sinc(2.0 * np.maximum(min_dly * dfg, absdiff))
    cmat = cmat * np.sinc(2.0 * dfg * ant_dly)
    return cmat


def _cov_jax(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype):
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("nbls", "nfreqs"))
    def build(uvws, freqs, nbls, nfreqs):
        coords = (uvws[:, :, None] * (freqs / C_MS)[None, None, :]).reshape(3, -1)
        diff = coords[:, :, None] - coords[:, None, :]
        absdiff = jnp.sqrt(jnp.sum(diff**2.0, axis=0)) * horizon
        fvals = jnp.tile(freqs, nbls)
        dfg = jnp.abs(fvals[:, None] - fvals[None, :]) / 1e9
        absdiff = absdiff + dfg * offset
        cmat = jnp.sinc(2.0 * jnp.maximum(min_dly * dfg, absdiff))
        return cmat * jnp.sinc(2.0 * dfg * ant_dly)

    uvws_j = jnp.asarray(uvws.T, dtype=dtype)  # (3, nbls)
    freqs_j = jnp.asarray(freqs, dtype=dtype)
    return build(uvws_j, freqs_j, uvws.shape[0], len(freqs))


def simple_cov_matrix(
    blvecs,
    freqs,
    ant_dly=0.0,
    horizon=1.0,
    offset=0.0,
    min_dly=0.0,
    dtype=np.float64,
    use_jax=False,
    verbose=False,
):
    """(Nbls*Nfreqs)^2 analytic covariance (reference simple_cov.py:7-97)."""
    uvws = np.asarray(blvecs, dtype=dtype).reshape(-1, 3)
    freqs = np.asarray(freqs, dtype=dtype)
    if use_jax:
        return _cov_jax(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype)
    return _cov_numpy(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype)


def yield_simple_multi_baseline_model_comps(
    blvecs,
    freqs,
    ant_dly=0.0,
    horizon=1.0,
    offset=0.0,
    min_dly=0.0,
    dtype=np.float64,
    verbose=False,
    use_jax=False,
    eigenval_cutoff=1e-10,
):
    """Eigenvectors of the analytic covariance with relative eigenvalue
    >= cutoff, in descending eigenvalue order (reference simple_cov.py:100-182).

    Returns (Nbls*Nfreqs, Ncomponents) float64 numpy array.
    """
    cmat = simple_cov_matrix(
        blvecs,
        freqs,
        ant_dly=ant_dly,
        horizon=horizon,
        offset=offset,
        min_dly=min_dly,
        dtype=dtype,
        use_jax=use_jax,
        verbose=verbose,
    )
    echo(
        f"{datetime.datetime.now()} Deriving modeling components with eigenvalue decomposition...\n",
        verbose=verbose,
    )
    if use_jax:
        import jax.numpy as jnp

        evals, evecs = jnp.linalg.eigh(cmat)
        evals = np.asarray(evals)
        evecs = np.asarray(evecs)
    else:
        evals, evecs = np.linalg.eigh(np.asarray(cmat))
    selection = evals / evals[-1] >= eigenval_cutoff
    echo(
        f"{datetime.datetime.now()} Using {np.count_nonzero(selection)} of "
        f"{len(selection)} eigenvectors to model foregrounds...\n",
        verbose=verbose,
    )
    return evecs[:, selection][:, ::-1]
