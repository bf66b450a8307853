"""Visibility data container with uvh5 I/O.

A from-scratch, numpy-backed replacement for the subset of
``pyuvdata.UVData`` the calibration stack needs (the reference uses pyuvdata
throughout, e.g. calibration.py:3, 1757-1761). The container keeps the
pyuvdata attribute names so code written against the reference API maps
directly, but it is a thin host-side boundary: all heavy compute happens on
dense jnp arrays extracted from it (see calamity_tpu.solver.tensorize).

Layout conventions (uvh5 spec v0.1, matching the reference test fixtures):
  - data_array / flag_array / nsample_array: (Nblts, Nspws=1, Nfreqs, Npols)
  - freq_array: (Nspws, Nfreqs)
  - baseline-time axis ("blts") ordered by (time, baseline)
  - uvw convention: position(ant_2) - position(ant_1)
"""

from __future__ import annotations

import copy as _copy

import numpy as np

from .polarizations import conj_pol, polnum2str, polstr2num

_STR_FIELDS = (
    "telescope_name",
    "instrument",
    "object_name",
    "history",
    "phase_type",
    "vis_units",
    "version",
    "x_orientation",
)

_HEADER_SCALARS = (
    "Nants_data",
    "Nants_telescope",
    "Nbls",
    "Nblts",
    "Nfreqs",
    "Npols",
    "Nspws",
    "Ntimes",
    "latitude",
    "longitude",
    "altitude",
    "channel_width",
)

_HEADER_ARRAYS = (
    "ant_1_array",
    "ant_2_array",
    "antenna_numbers",
    "antenna_positions",
    "antenna_diameters",
    "freq_array",
    "integration_time",
    "lst_array",
    "polarization_array",
    "spw_array",
    "time_array",
    "uvw_array",
)


def _decode(val):
    if isinstance(val, bytes):
        return val.decode("utf-8")
    return val


class VisData:
    """In-memory interferometric visibility dataset (UVData equivalent)."""

    def __init__(self, **kwargs):
        # metadata
        self.telescope_name = "unknown"
        self.instrument = "unknown"
        self.object_name = "unknown"
        self.history = ""
        self.phase_type = "drift"
        self.vis_units = "Jy"
        self.version = "0.1"
        self.x_orientation = None
        self.latitude = 0.0
        self.longitude = 0.0
        self.altitude = 0.0
        self.channel_width = 0.0
        self.antenna_diameters = None
        self.flex_spw = False
        # arrays
        self.ant_1_array = None
        self.ant_2_array = None
        self.antenna_numbers = None
        self.antenna_names = None
        self.antenna_positions = None
        self.freq_array = None
        self.integration_time = None
        self.lst_array = None
        self.polarization_array = None
        self.spw_array = np.array([0])
        self.time_array = None
        self.uvw_array = None
        self.data_array = None
        self.flag_array = None
        self.nsample_array = None
        for key, val in kwargs.items():
            setattr(self, key, val)
        if self.data_array is not None:
            self._sync_metadata()
        self._antpair_cache = None

    # ------------------------------------------------------------------ #
    # shape bookkeeping
    # ------------------------------------------------------------------ #
    def _sync_metadata(self):
        """Recompute the N* counters from the underlying arrays."""
        self.Nblts = len(self.time_array)
        self.Nfreqs = self.freq_array.shape[-1]
        self.Npols = len(self.polarization_array)
        self.Nspws = len(self.spw_array)
        self.Ntimes = len(np.unique(self.time_array))
        pairs = set(zip(self.ant_1_array.tolist(), self.ant_2_array.tolist()))
        self.Nbls = len(pairs)
        data_ants = set(self.ant_1_array.tolist()) | set(self.ant_2_array.tolist())
        self.Nants_data = len(data_ants)
        if self.antenna_numbers is not None:
            self.Nants_telescope = len(self.antenna_numbers)
        else:
            self.Nants_telescope = self.Nants_data
        self._antpair_cache = None

    @property
    def telescope_location_lat_lon_alt_degrees(self):
        return (self.latitude, self.longitude, self.altitude)

    # ------------------------------------------------------------------ #
    # uvh5 I/O
    # ------------------------------------------------------------------ #
    @classmethod
    def from_uvh5(cls, path, data_dtype=None):
        """Read a uvh5 file (spec v0.1 or v1.x layouts).

        ``data_dtype`` casts the visibility array while reading (h5py
        converts per HDF5 chunk, so the file-dtype cube is never fully
        materialized). At full-HERA many-times scale a complex128 cube is
        ~10 GiB of host RSS the float32 fit never needs — complex64 halves
        it and the read transient."""
        obj = cls()
        import h5py  # optional dependency: only file I/O needs it

        with h5py.File(path, "r") as f:
            hdr = f["Header"]
            for name in _HEADER_SCALARS:
                if name in hdr:
                    val = np.asarray(hdr[name][()])
                    if val.size > 1:
                        # uvh5 v1.x stores channel_width per channel
                        val = np.median(val)
                    setattr(obj, name, val.item())
            for name in _HEADER_ARRAYS:
                if name in hdr:
                    setattr(obj, name, np.asarray(hdr[name][()]))
            for name in _STR_FIELDS:
                if name in hdr:
                    setattr(obj, name, _decode(hdr[name][()]))
            if "antenna_names" in hdr:
                obj.antenna_names = [_decode(a) for a in hdr["antenna_names"][()]]
            if "flex_spw" in hdr:
                obj.flex_spw = bool(hdr["flex_spw"][()])
            data = f["Data"]
            if data_dtype is not None:
                dset = data["visdata"]
                obj.data_array = np.empty(dset.shape, dtype=np.dtype(data_dtype))
                dset.read_direct(obj.data_array)
            else:
                obj.data_array = np.asarray(data["visdata"][()])
            obj.flag_array = np.asarray(data["flags"][()])
            obj.nsample_array = np.asarray(data["nsamples"][()])
        # normalize to the 4D (Nblts, 1, Nfreqs, Npols) layout
        if obj.data_array.ndim == 3:
            obj.data_array = obj.data_array[:, None]
            obj.flag_array = obj.flag_array[:, None]
            obj.nsample_array = obj.nsample_array[:, None]
        if obj.freq_array.ndim == 1:
            obj.freq_array = obj.freq_array[None, :]
        if np.ndim(obj.integration_time) == 0:
            obj.integration_time = np.full(len(obj.time_array), float(obj.integration_time))
        obj._sync_metadata()
        return obj

    def write_uvh5(self, path, clobber=False, version="0.1"):
        """Write a uvh5 file.

        ``version="0.1"`` emits the original spw-axis layout (matching the
        reference's packaged fixtures); ``version="1.0"`` emits the current
        uvh5 spec: no spw axis on the Data datasets, 1-D ``freq_array``,
        per-channel ``channel_width`` array (pyuvdata writes this layout,
        reference calibration.py:1806-1809).
        """
        import os

        if version not in ("0.1", "1.0"):
            raise ValueError(f"unsupported uvh5 version {version!r}")
        if os.path.exists(path) and not clobber:
            raise IOError(f"{path} exists and clobber=False")
        v1 = version == "1.0"
        import h5py  # optional dependency: only file I/O needs it

        with h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            self._sync_metadata()
            for name in _HEADER_SCALARS:
                if v1 and name == "channel_width":
                    continue
                hdr[name] = getattr(self, name)
            for name in _HEADER_ARRAYS:
                if v1 and name == "freq_array":
                    continue
                val = getattr(self, name)
                if val is not None:
                    hdr[name] = np.asarray(val)
            for name in _STR_FIELDS:
                if name == "version":
                    continue
                val = getattr(self, name)
                if val is not None:
                    hdr[name] = np.bytes_(str(val))
            hdr["version"] = np.bytes_(version)
            hdr["flex_spw"] = bool(self.flex_spw)
            if v1:
                hdr["freq_array"] = np.asarray(self.freq_array).reshape(-1)
                hdr["channel_width"] = np.full(
                    self.Nfreqs, float(self.channel_width), dtype=np.float64
                )
                hdr["flex_spw_id_array"] = np.zeros(self.Nfreqs, dtype=np.int64)
            if self.antenna_names is not None:
                hdr["antenna_names"] = np.asarray(
                    [np.bytes_(a) for a in self.antenna_names]
                )
            data = f.create_group("Data")
            vis = self.data_array.astype(np.complex128)
            flg = self.flag_array.astype(bool)
            nsmp = self.nsample_array.astype(np.float32)
            if v1:
                vis, flg, nsmp = vis[:, 0], flg[:, 0], nsmp[:, 0]
            data.create_dataset("visdata", data=vis)
            data.create_dataset("flags", data=flg)
            data.create_dataset("nsamples", data=nsmp)

    # reference-compatible aliases
    read_uvh5 = from_uvh5

    # ------------------------------------------------------------------ #
    # antenna / baseline / polarization accessors
    # ------------------------------------------------------------------ #
    def copy(self):
        return _copy.deepcopy(self)

    def get_pols(self):
        return [polnum2str(p, x_orientation=self.x_orientation) for p in self.polarization_array]

    def get_antpairs(self):
        if self._antpair_cache is None:
            seen = {}
            for a1, a2 in zip(self.ant_1_array.tolist(), self.ant_2_array.tolist()):
                seen.setdefault((a1, a2), None)
            self._antpair_cache = list(seen.keys())
        return list(self._antpair_cache)

    def get_antpairpols(self):
        return [ap + (p,) for ap in self.get_antpairs() for p in self.get_pols()]

    def antpair2ind(self, ant1, ant2=None):
        """Blt indices matching antenna pair (exact orientation)."""
        if ant2 is None:
            ant1, ant2 = ant1
        return np.nonzero((self.ant_1_array == ant1) & (self.ant_2_array == ant2))[0]

    def _key2inds(self, key):
        """(ant1, ant2, pol) -> (direct inds, conjugate inds, (pol_ind_direct, pol_ind_conj)).

    Mirrors the lookup contract of pyuvdata.UVData._key2inds used by the
        reference tensorize_data (calibration.py:262-270)."""
        a1, a2, pol = key
        polnum = polstr2num(pol, x_orientation=self.x_orientation)
        pol_matches = np.nonzero(self.polarization_array == polnum)[0]
        if len(pol_matches) == 0:
            raise KeyError(f"polarization {pol} not present")
        pol_ind = int(pol_matches[0])
        direct = self.antpair2ind(a1, a2)
        conj = self.antpair2ind(a2, a1) if a1 != a2 else np.array([], dtype=int)
        if len(direct) > 0:
            conj = np.array([], dtype=int)
        # conjugating a cross-hand visibility flips the pol (xy <-> yx);
        # the conj slot carries the conjugate-pol column index
        return direct, conj, (pol_ind, self._conj_pol_ind(polnum, required=len(conj) > 0))

    def _conj_pol_ind(self, polnum, required=False):
        """Column index of the conjugate polarization of AIPS number polnum."""
        from .polarizations import conj_pol_ind

        ind = conj_pol_ind(self.polarization_array, polnum)
        if ind < 0 and required:
            raise KeyError(
                f"conjugate polarization {polnum2str(conj_pol(polnum))} not "
                "present (needed to read a conjugated cross-hand baseline)"
            )
        return ind

    def _bl_time_rows(self, ant1, ant2):
        """Blt rows for an antpair sorted by time, plus conjugation flag."""
        inds = self.antpair2ind(ant1, ant2)
        conj = False
        if len(inds) == 0:
            inds = self.antpair2ind(ant2, ant1)
            conj = True
        order = np.argsort(self.time_array[inds], kind="stable")
        return inds[order], conj

    def get_data(self, *key):
        """Waterfall (Ntimes_bl, Nfreqs) of data for (ant1, ant2, pol) key."""
        if len(key) == 1:
            key = key[0]
        a1, a2, pol = key
        inds, conj = self._bl_time_rows(a1, a2)
        pind = self._pol_ind_for_rows(pol, conj)
        out = self.data_array[inds, 0, :, pind]
        return np.conj(out) if conj else out

    def _pol_ind_for_rows(self, pol, conj):
        """Pol column to read: the conjugate pol when rows are conjugated."""
        polnum = polstr2num(pol, x_orientation=self.x_orientation)
        if conj:
            return self._conj_pol_ind(polnum, required=True)
        return int(np.nonzero(self.polarization_array == polnum)[0][0])

    def get_flags(self, *key):
        if len(key) == 1:
            key = key[0]
        a1, a2, pol = key
        inds, conj = self._bl_time_rows(a1, a2)
        pind = self._pol_ind_for_rows(pol, conj)
        return self.flag_array[inds, 0, :, pind]

    def get_nsamples(self, *key):
        if len(key) == 1:
            key = key[0]
        a1, a2, pol = key
        inds, conj = self._bl_time_rows(a1, a2)
        pind = self._pol_ind_for_rows(pol, conj)
        return self.nsample_array[inds, 0, :, pind]

    def get_ENU_antpos(self, pick_data_ants=True):
        """ENU antenna positions (meters) and antenna numbers.

        antenna_positions are stored ECEF-relative-to-telescope (uvh5
        convention); rotate into the local east-north-up frame."""
        lat = np.deg2rad(self.latitude)
        lon = np.deg2rad(self.longitude)
        rot = np.array(
            [
                [-np.sin(lon), np.cos(lon), 0.0],
                [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)],
                [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
            ]
        )
        enu = (rot @ self.antenna_positions.T).T
        numbers = np.asarray(self.antenna_numbers)
        if pick_data_ants:
            data_ants = np.asarray(
                sorted(set(self.ant_1_array.tolist()) | set(self.ant_2_array.tolist()))
            )
            sel = np.nonzero(np.isin(numbers, data_ants))[0]
            return enu[sel], numbers[sel]
        return enu, numbers

    # ------------------------------------------------------------------ #
    # selection / concatenation
    # ------------------------------------------------------------------ #
    def select(self, bls=None, times=None, freq_chans=None, frequencies=None,
               polarizations=None, inplace=True):
        """Down-select by antenna pairs, times, channels, and polarizations."""
        obj = self if inplace else self.copy()
        if freq_chans is not None or frequencies is not None:
            if freq_chans is None:
                fmask = np.zeros(obj.Nfreqs, dtype=bool)
                for f in np.atleast_1d(frequencies):
                    fmask |= np.isclose(obj.freq_array[0], f, rtol=0.0, atol=1e-3)
                freq_chans = np.nonzero(fmask)[0]
            freq_chans = np.asarray(freq_chans)
            obj.freq_array = obj.freq_array[:, freq_chans]
            obj.data_array = obj.data_array[:, :, freq_chans, :]
            obj.flag_array = obj.flag_array[:, :, freq_chans, :]
            obj.nsample_array = obj.nsample_array[:, :, freq_chans, :]
            if obj.Nfreqs != len(freq_chans):
                obj.channel_width = float(np.median(np.diff(obj.freq_array[0]))) if len(
                    freq_chans
                ) > 1 else obj.channel_width
        if polarizations is not None:
            pinds = []
            for p in polarizations:
                pnum = polstr2num(p, x_orientation=obj.x_orientation)
                pinds.append(int(np.nonzero(obj.polarization_array == pnum)[0][0]))
            pinds = np.asarray(pinds)
            obj.polarization_array = obj.polarization_array[pinds]
            obj.data_array = obj.data_array[..., pinds]
            obj.flag_array = obj.flag_array[..., pinds]
            obj.nsample_array = obj.nsample_array[..., pinds]
        mask = np.ones(obj.Nblts, dtype=bool)
        if bls is not None:
            bls = list(bls)
            if len(bls) == 0:
                mask[:] = False
            else:
                # vectorized pair membership (both orientations) via packed
                # integer keys — the previous per-blt Python loop cost
                # seconds at full-HERA blt counts
                aps = np.asarray([(bl[0], bl[1]) for bl in bls], dtype=np.int64)
                a1v = np.asarray(obj.ant_1_array, dtype=np.int64)
                a2v = np.asarray(obj.ant_2_array, dtype=np.int64)
                M = int(max(a1v.max(initial=0), a2v.max(initial=0),
                            aps.max(initial=0))) + 1
                keys = np.unique(np.concatenate(
                    [aps[:, 0] * M + aps[:, 1], aps[:, 1] * M + aps[:, 0]]
                ))
                mask &= np.isin(a1v * M + a2v, keys)
        if times is not None:
            tmask = np.zeros(obj.Nblts, dtype=bool)
            for t in np.atleast_1d(times):
                tmask |= np.isclose(obj.time_array, t, rtol=0.0, atol=1e-7)
            mask &= tmask
        if not mask.all():
            # all-True masks (e.g. selecting every cross baseline of an
            # autos-free dataset) skip the reindex: each fancy index below
            # is a full-cube copy pass (~10 GiB x4 at full-HERA many-times
            # scale)
            idx = np.nonzero(mask)[0]
            for name in (
                "ant_1_array",
                "ant_2_array",
                "time_array",
                "lst_array",
                "integration_time",
            ):
                setattr(obj, name, getattr(obj, name)[idx])
            obj.uvw_array = obj.uvw_array[idx]
            obj.data_array = obj.data_array[idx]
            obj.flag_array = obj.flag_array[idx]
            obj.nsample_array = obj.nsample_array[idx]
        obj._sync_metadata()
        if not inplace:
            return obj
        return None

    def __add__(self, other):
        """Concatenate along the blt axis, re-sorting by (time, baseline)."""
        out = self.copy()
        for name in (
            "ant_1_array",
            "ant_2_array",
            "time_array",
            "lst_array",
            "integration_time",
        ):
            setattr(out, name, np.concatenate([getattr(self, name), getattr(other, name)]))
        out.uvw_array = np.concatenate([self.uvw_array, other.uvw_array])
        out.data_array = np.concatenate([self.data_array, other.data_array])
        out.flag_array = np.concatenate([self.flag_array, other.flag_array])
        out.nsample_array = np.concatenate([self.nsample_array, other.nsample_array])
        order = np.lexsort((out.ant_2_array, out.ant_1_array, out.time_array))
        for name in (
            "ant_1_array",
            "ant_2_array",
            "time_array",
            "lst_array",
            "integration_time",
        ):
            setattr(out, name, getattr(out, name)[order])
        out.uvw_array = out.uvw_array[order]
        out.data_array = out.data_array[order]
        out.flag_array = out.flag_array[order]
        out.nsample_array = out.nsample_array[order]
        out._sync_metadata()
        return out
