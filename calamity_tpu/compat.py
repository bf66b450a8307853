"""Reference-named compatibility shims.

Maps every reference tensorization-layer entry point (SURVEY.md §2.1) onto
this framework's equivalents, so code and muscle memory written against the
reference keep working. The underlying objects differ by design — the
reference passes lists of per-chunk TF tensors plus nested corr_inds lists;
here the same structure lives in a FitSpec — but the call signatures and
returned array layouts below match the reference's contracts.

Reference locations these mirror:
  chunk_fg_comp_dict_by_nbls        calibration.py:30-101
  tensorize_fg_model_comps_dict     calibration.py:104-190
  tensorize_data                    calibration.py:193-310
  tensorize_gains                   calibration.py:369-399
  yield_fg_model_array              calibration.py:402-444
  insert_model_into_uvdata_tensor   calibration.py:741-795
  insert_gains_into_uvcal           calibration.py:798-825
  tensorize_fg_coeffs               calibration.py:828-913
  fg_model / data_model / mse       calibration.py:1587-1609
  mse_chunked(_sum_regularized)     calibration.py:1612-1656
"""

from __future__ import annotations

import numpy as np

from .ops.loss import (  # noqa: F401  (reference-named math kernels)
    chunked_loss as mse_chunked,
    chunked_loss_sum_regularized as mse_chunked_sum_regularized,
    data_model,
    fg_model,
    fg_model_all_chunks,
    mse,
)
from .solver.tensorize import FitSpec, chunk_fitting_groups

# reference name for the chunking step (calibration.py:30)
chunk_fg_comp_dict_by_nbls = chunk_fitting_groups


def insert_model_into_uvdata_tensor(spec, visdata_model, fg_coeffs_r, fg_coeffs_i,
                                    polarization, time, scale_factor=1.0):
    """Write fitted model coefficients back into a VisData
    (reference calibration.py:741-795). Takes the FitSpec as first arg."""
    chunks = spec.device_chunks()
    model_chunks = fg_model_all_chunks(tuple(fg_coeffs_r), tuple(fg_coeffs_i), chunks)
    spec.insert_model(visdata_model, model_chunks, polarization, time, scale_factor)


def insert_gains_into_uvcal(spec, caldata, g_r, g_i, polarization, time):
    """Write fitted gains back into a CalData
    (reference calibration.py:798-825). Takes the FitSpec as first arg."""
    spec.insert_gains(caldata, g_r, g_i, polarization, time)


def tensorize_fg_model_comps_dict(
    fg_model_comps_dict,
    ants_map,
    nfreqs,
    visdata=None,
    use_redundancy=False,
    dtype=np.float32,
    grp_size_threshold=5,
    **_,
):
    """Build the packed component tensors + index structure.

    Returns (fg_model_comps, corr_inds):
      fg_model_comps: list of (nvecs, ngrps, nbls, nfreqs) arrays — the
        reference's tensor layout (calibration.py:136-146), transposed from
        the internal (ngrps, nbls, nfreqs, nvecs) contraction layout.
      corr_inds: list (chunk) of list (group) of (i, j) antenna-index pairs.

    ``visdata`` is required (the reference resolves baseline rows lazily;
    the packed spec resolves them at build time).
    """
    if visdata is None:
        raise ValueError("tensorize_fg_model_comps_dict requires visdata=")
    spec = FitSpec(
        visdata,
        fg_model_comps_dict,
        ants_map,
        dtype=dtype,
        use_redundancy=use_redundancy,
        grp_size_threshold=grp_size_threshold,
    )
    fg_model_comps = [
        np.moveaxis(np.asarray(c.comps), -1, 0) for c in spec.chunks
    ]
    corr_inds = [
        [
            [
                (int(spec.ants_map[int(meta.antpairs[g, b, 0])]),
                 int(spec.ants_map[int(meta.antpairs[g, b, 1])]))
                for b in range(meta.antpairs.shape[1])
            ]
            for g in range(meta.antpairs.shape[0])
        ]
        for meta in spec.meta
    ]
    return fg_model_comps, corr_inds


def make_fit_spec(visdata, fg_model_comps_dict, ants_map, **kwargs):
    """The native equivalent: one FitSpec holding comps + index structure."""
    return FitSpec(visdata, fg_model_comps_dict, ants_map, **kwargs)


def tensorize_data(spec, visdata, polarization, time, data_scale_factor=1.0,
                   weights=None, nsamples_in_weights=False, **_):
    """(data_r, data_i, wgts) chunk lists for one (time, pol)
    (reference calibration.py:193-310). Takes the FitSpec as first arg."""
    return spec.pack_data(
        visdata,
        polarization,
        time,
        data_scale_factor=data_scale_factor,
        weights=weights,
        nsamples_in_weights=nsamples_in_weights,
    )


def tensorize_gains(spec, caldata, polarization, time, **_):
    """(g_r, g_i) gain tensors for one (time, pol)
    (reference calibration.py:369-399)."""
    return spec.pack_gains(caldata, polarization, time)


def tensorize_fg_coeffs(data, wgts, fg_model_comps_or_spec, **_):
    """Least-squares coefficient init per chunk
    (reference calibration.py:828-913). Accepts a FitSpec (all packing
    layouts, cached gram factors), a tuple of internal (comps, a0, a1)
    chunk triples, or the reference-layout (nvecs, ngrps, nbls, nfreqs)
    comps list produced by tensorize_fg_model_comps_dict above; returns a
    list of (ngrps, nvecs) arrays."""
    if isinstance(fg_model_comps_or_spec, FitSpec):
        # handles dense, shared and shared-batched chunks (init_coeffs_chunk
        # assumes the dense layout) and reuses the cached Cholesky factors
        return fg_model_comps_or_spec.init_coeffs(data, wgts)
    from .ops.lstsq import gram_cholesky_chunk, init_coeffs_from_cholesky

    out = []
    for c, d, w in zip(fg_model_comps_or_spec, data, wgts):
        if isinstance(c, (tuple, list)):
            comps = np.asarray(c[0])  # internal (ngrps, nbls, nfreqs, nvecs)
        else:
            comps = np.moveaxis(np.asarray(c), 0, -1)  # reference layout
        chol, active = gram_cholesky_chunk(comps)
        out.append(init_coeffs_from_cholesky(chol, active, comps, d, w))
    return out


def yield_fg_model_array(spec, fg_coeffs_r, fg_coeffs_i=None, nants=None,
                         nfreqs=None):
    """Dense (nants, nants, nfreqs) visibility-model cube
    (reference calibration.py:402-444).

    With fg_coeffs_i given, returns a complex cube; otherwise the real part
    only (the reference builds real/imag planes in two calls)."""
    nants = nants or spec.nants
    nfreqs = nfreqs or spec.nfreqs
    complex_out = fg_coeffs_i is not None
    if fg_coeffs_i is None:
        fg_coeffs_i = [np.zeros_like(np.asarray(c)) for c in fg_coeffs_r]
    chunks = spec.device_chunks()
    model_chunks = fg_model_all_chunks(tuple(fg_coeffs_r), tuple(fg_coeffs_i), chunks)
    cube = np.zeros((nants, nants, nfreqs), dtype=np.complex128)
    for chunk, meta, (vr, vi) in zip(spec.chunks, spec.meta, model_chunks):
        a0 = np.asarray(chunk.a0).ravel()
        a1 = np.asarray(chunk.a1).ravel()
        vals = (np.asarray(vr) + 1j * np.asarray(vi)).reshape(-1, nfreqs)
        # shared-batched padding rows carry a0=a1=0 and must not write
        # (same mask insert_model applies)
        keep = meta.valid.ravel()
        cube[a0[keep], a1[keep]] = vals[keep]
    return cube if complex_out else cube.real
