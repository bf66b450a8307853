"""Flag/weight container (UVFlag equivalent) with UVFlag-HDF5 I/O.

Replacement for the subset of ``pyuvdata.UVFlag`` (mode="flag" with a
weights_array) used by the reference for data-fitting weights
(calibration.py:282-298, 916-960, tests/test_calibration.py:66-69).

File I/O follows pyuvdata's UVFlag HDF5 layout — a ``/Header`` group with
type/mode strings, counts and coordinate arrays, and a ``/Data`` group with
``flag_array`` and ``weights_array`` — so weights objects produced by the
HERA toolchain (``UVFlag.write``) load directly and files written here can
be read back by pyuvdata. Only the baseline-type, flag-mode layout the
calibration stack consumes is supported; both the legacy
(Nblts, 1, Nfreqs, Npols) and the current spw-less (Nblts, Nfreqs, Npols)
data layouts are accepted on read, and the current layout is written.
"""

from __future__ import annotations

import copy as _copy
import os

import numpy as np

from .visdata import _decode


class FlagWeights:
    """Flags + per-sample fitting weights aligned with a VisData blt grid."""

    def __init__(self, visdata=None, mode="flag"):
        self.type = "baseline"
        self.mode = mode
        self.history = ""
        self.label = ""
        if visdata is not None:
            self.ant_1_array = np.asarray(visdata.ant_1_array)
            self.ant_2_array = np.asarray(visdata.ant_2_array)
            self.time_array = np.asarray(visdata.time_array)
            self.lst_array = np.asarray(
                getattr(visdata, "lst_array", np.zeros_like(self.time_array))
            )
            self.freq_array = np.asarray(visdata.freq_array)
            self.polarization_array = np.asarray(visdata.polarization_array)
            self.x_orientation = visdata.x_orientation
            self.flag_array = np.asarray(visdata.flag_array).copy()
            self.weights_array = np.zeros(visdata.flag_array.shape, dtype=np.float64)
        else:
            self.ant_1_array = None
            self.ant_2_array = None
            self.time_array = None
            self.lst_array = None
            self.freq_array = None
            self.polarization_array = None
            self.x_orientation = None
            self.flag_array = None
            self.weights_array = None

    def copy(self):
        return _copy.deepcopy(self)

    def get_antpairs(self):
        seen = {}
        for a1, a2 in zip(self.ant_1_array.tolist(), self.ant_2_array.tolist()):
            seen.setdefault((a1, a2), None)
        return list(seen.keys())

    def antpair2ind(self, ant1, ant2=None):
        if ant2 is None:
            ant1, ant2 = ant1
        return np.nonzero((self.ant_1_array == ant1) & (self.ant_2_array == ant2))[0]

    # ------------------------------------------------------------------ #
    # UVFlag HDF5 I/O
    # ------------------------------------------------------------------ #
    @property
    def _counts(self):
        nblts = len(self.time_array)
        pairs = {(a, b) for a, b in zip(self.ant_1_array, self.ant_2_array)}
        return dict(
            Nblts=nblts,
            Nbls=len(pairs),
            Ntimes=len(np.unique(self.time_array)),
            Nfreqs=int(np.asarray(self.freq_array).reshape(-1).shape[0]),
            Npols=len(self.polarization_array),
            Nspws=1,
            Nants_data=len(
                set(self.ant_1_array.tolist()) | set(self.ant_2_array.tolist())
            ),
        )

    @classmethod
    def from_uvflag_h5(cls, path):
        """Read a baseline-type, flag-mode UVFlag HDF5 file
        (pyuvdata ``UVFlag.write`` layout)."""
        obj = cls()
        import h5py  # optional dependency: only file I/O needs it

        with h5py.File(path, "r") as f:
            hdr = f["Header"]
            ftype = _decode(hdr["type"][()])
            mode = _decode(hdr["mode"][()])
            if ftype != "baseline":
                raise NotImplementedError(
                    f"UVFlag type {ftype!r} not supported; the calibration "
                    "weights path consumes baseline-type objects (reference "
                    "calibration.py:282-298)"
                )
            if mode != "flag":
                raise NotImplementedError(
                    f"UVFlag mode {mode!r} not supported; the reference "
                    "builds flag-mode weights objects (calibration.py:933)"
                )
            obj.mode = mode
            obj.ant_1_array = np.asarray(hdr["ant_1_array"])
            obj.ant_2_array = np.asarray(hdr["ant_2_array"])
            obj.time_array = np.asarray(hdr["time_array"])
            if "lst_array" in hdr:
                obj.lst_array = np.asarray(hdr["lst_array"])
            else:
                obj.lst_array = np.zeros_like(obj.time_array)
            obj.freq_array = np.asarray(hdr["freq_array"])
            if obj.freq_array.ndim == 2:  # legacy (Nspws, Nfreqs)
                obj.freq_array = obj.freq_array[0]
            obj.polarization_array = np.asarray(hdr["polarization_array"])
            obj.x_orientation = (
                _decode(hdr["x_orientation"][()]) if "x_orientation" in hdr else "east"
            )
            obj.history = _decode(hdr["history"][()]) if "history" in hdr else ""
            obj.label = _decode(hdr["label"][()]) if "label" in hdr else ""
            data = f["Data"]
            flags = np.asarray(data["flag_array"]).astype(bool)
            wgts = np.asarray(data["weights_array"], dtype=np.float64)
            if flags.ndim == 3:  # current spw-less layout
                flags = flags[:, None]
            if wgts.ndim == 3:
                wgts = wgts[:, None]
            obj.flag_array = flags
            obj.weights_array = wgts
        # the container keeps freq_array 1D internally
        obj.freq_array = np.asarray(obj.freq_array).reshape(-1)
        return obj

    def to_uvflag_h5(self, path, clobber=False):
        """Write the pyuvdata UVFlag HDF5 layout (baseline type, flag mode,
        current spw-less data arrays)."""
        if os.path.exists(path) and not clobber:
            raise IOError(f"{path} exists and clobber=False")
        counts = self._counts
        a1 = np.asarray(self.ant_1_array, dtype=np.int64)
        a2 = np.asarray(self.ant_2_array, dtype=np.int64)
        import h5py  # optional dependency: only file I/O needs it

        with h5py.File(path, "w") as f:
            hdr = f.create_group("Header")
            hdr["type"] = np.bytes_("baseline")
            hdr["mode"] = np.bytes_(self.mode)
            for name, val in counts.items():
                hdr[name] = np.int64(val)
            hdr["Nants_telescope"] = np.int64(counts["Nants_data"])
            hdr["ant_1_array"] = a1
            hdr["ant_2_array"] = a2
            # pyuvdata's packed baseline numbers (antnums_to_baseline with
            # the legacy 1-indexed offsets: 2048*(ant1+1) + (ant2+1) + 2^16)
            hdr["baseline_array"] = 2048 * (a1 + 1) + (a2 + 1) + 2**16
            hdr["time_array"] = np.asarray(self.time_array, dtype=np.float64)
            hdr["lst_array"] = np.asarray(self.lst_array, dtype=np.float64)
            hdr["freq_array"] = np.asarray(self.freq_array, np.float64).reshape(-1)
            hdr["polarization_array"] = np.asarray(
                self.polarization_array, dtype=np.int64
            )
            hdr["x_orientation"] = np.bytes_(self.x_orientation or "east")
            hdr["history"] = np.bytes_(self.history or "")
            hdr["label"] = np.bytes_(self.label or "")
            data = f.create_group("Data")
            # current pyuvdata layout: no spw axis
            data["flag_array"] = np.asarray(self.flag_array)[:, 0].astype(bool)
            data["weights_array"] = np.asarray(self.weights_array, np.float64)[:, 0]
        return path
