"""Synthetic interferometric datasets for tests and benchmarks.

The reference ships binary uvh5 fixtures (Golomb-array GSM/EoR sims,
redundant 3-ant copies, MWA noise with RFI flags — see reference
tests/test_calibration.py:18-48). This framework generates equivalent
datasets programmatically: a point-source foreground sky observed by an
idealized array, so that redundant baselines measure identical visibilities
and per-baseline spectra are smooth within the delay horizon.

All generation is plain numpy on host; outputs are VisData containers that
round-trip through uvh5.
"""

from __future__ import annotations

import numpy as np

from .io.visdata import VisData

C_MS = 299792458.0

# Golomb ruler marks used for test arrays. {0,1,4,10,12,17} is the optimal
# order-6 ruler: all pairwise differences are distinct, so every baseline of
# the 6-ant fixture is non-redundant (matches the reference's 6-ant Golomb
# fixture concept, tests/test_calibration.py:18-28).
GOLOMB_6 = np.array([0, 1, 4, 10, 12, 17], dtype=float)
GOLOMB_3 = np.array([0, 1, 3], dtype=float)

HERA_LAT = -30.721527777778
HERA_LON = 21.428305555556
HERA_ALT = 1073.0


def _enu_to_ecef_rel(enu, lat_deg, lon_deg):
    """Rotate ENU offsets into ECEF-relative offsets (inverse of VisData.get_ENU_antpos)."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    rot = np.array(
        [
            [-np.sin(lon), np.cos(lon), 0.0],
            [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)],
            [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        ]
    )
    return (rot.T @ np.asarray(enu).T).T


def point_source_visibilities(blvecs_enu, freqs, nsrc=50, seed=0, flux_scale=1.0):
    """Visibilities of a random point-source sky.

    V_b(nu) = sum_s S_s (nu/f0)^(-alpha_s) exp(-2*pi*i * nu/c * (b . l_s))

    Identical baseline vectors yield identical visibilities, so redundancy
    is exact by construction. Spectra are smooth and confined to the delay
    horizon |tau| <= |b|/c.
    """
    rng = np.random.default_rng(seed)
    freqs = np.asarray(freqs, dtype=np.float64)
    f0 = freqs[0]
    flux = flux_scale * rng.gamma(2.0, 1.0, size=nsrc)
    alpha = rng.normal(0.8, 0.2, size=nsrc)
    # random directions on the sky: direction cosines within the horizon disk
    theta = rng.uniform(0, 2 * np.pi, size=nsrc)
    r = np.sqrt(rng.uniform(0, 1, size=nsrc)) * 0.95
    lcos = r * np.cos(theta)
    mcos = r * np.sin(theta)
    blvecs = np.atleast_2d(np.asarray(blvecs_enu, dtype=np.float64))
    # geometric delays per (bl, src): tau = (b_E * l + b_N * m) / c
    tau = (np.outer(blvecs[:, 0], lcos) + np.outer(blvecs[:, 1], mcos)) / C_MS
    spec = flux[None, :] * (freqs[:, None] / f0) ** (-alpha[None, :])  # (nfreq, nsrc)
    phase = np.exp(-2j * np.pi * freqs[:, None, None] * tau[None, :, :])  # (nfreq, nbl, nsrc)
    vis = np.einsum("fs,fbs->bf", spec, phase)
    return vis


def make_visdata(
    antpos_enu,
    freqs,
    ntimes=1,
    npols=1,
    include_autos=False,
    nsrc=50,
    seed=0,
    noise_dB=None,
    noise_seed=1,
    telescope_name="SYNTH",
    start_jd=2459122.25,
    integration_time=10.7,
):
    """Build a VisData observing a random point-source sky.

    Parameters mirror the knobs of the reference fixtures: a static sky
    (times repeat the same visibilities, like a snapshot concat), optional
    autocorrelations, and optional additive complex-gaussian "EoR"/noise at
    ``noise_dB`` decibels relative to the foreground rms.
    """
    antpos_enu = np.asarray(antpos_enu, dtype=np.float64)
    nants = antpos_enu.shape[0]
    freqs = np.asarray(freqs, dtype=np.float64)
    nfreqs = len(freqs)
    pairs = []
    for i in range(nants):
        for j in range(i, nants):
            if i == j and not include_autos:
                continue
            pairs.append((i, j))
    nbls = len(pairs)
    blvecs = np.array([antpos_enu[j] - antpos_enu[i] for (i, j) in pairs])
    vis = point_source_visibilities(blvecs, freqs, nsrc=nsrc, seed=seed)
    if noise_dB is not None:
        rng = np.random.default_rng(noise_seed)
        rms = np.sqrt(np.mean(np.abs(vis) ** 2))
        amp = rms * 10.0 ** (noise_dB / 20.0)
        vis = vis + amp * (
            rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape)
        ) / np.sqrt(2.0)

    times = start_jd + np.arange(ntimes) * integration_time / 86400.0
    nblts = nbls * ntimes
    ant_1 = np.tile([p[0] for p in pairs], ntimes)
    ant_2 = np.tile([p[1] for p in pairs], ntimes)
    time_array = np.repeat(times, nbls)
    uvw_array = np.tile(blvecs, (ntimes, 1))
    data = np.tile(vis[None], (ntimes, 1, 1)).reshape(nblts, 1, nfreqs, 1)
    if npols > 1:
        data = np.tile(data, (1, 1, 1, npols))

    pol_array = np.array([-5, -6, -7, -8][:npols])
    obj = VisData(
        telescope_name=telescope_name,
        instrument=telescope_name,
        latitude=HERA_LAT,
        longitude=HERA_LON,
        altitude=HERA_ALT,
        channel_width=float(np.median(np.diff(freqs))) if nfreqs > 1 else 1.0,
        ant_1_array=ant_1.astype(np.int64),
        ant_2_array=ant_2.astype(np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=_enu_to_ecef_rel(antpos_enu, HERA_LAT, HERA_LON),
        freq_array=freqs[None, :],
        integration_time=np.full(nblts, integration_time),
        lst_array=np.zeros(nblts),
        polarization_array=pol_array.astype(np.int64),
        time_array=time_array,
        uvw_array=uvw_array,
        data_array=data.astype(np.complex128),
        flag_array=np.zeros((nblts, 1, nfreqs, npols), dtype=bool),
        nsample_array=np.ones((nblts, 1, nfreqs, npols), dtype=np.float32),
    )
    return obj


def golomb_marks(nants):
    """Marks of a (greedy) Golomb ruler: all pairwise differences distinct.

    Exact optimal rulers for the 3- and 6-mark cases used by the test
    fixtures; a greedy Sidon-set construction for any other count."""
    if nants == 3:
        return GOLOMB_3
    if nants == 6:
        return GOLOMB_6
    marks = [0]
    diffs = set()
    candidate = 1
    while len(marks) < nants:
        new = [candidate - m for m in marks]
        if all(d not in diffs for d in new) and len(set(new)) == len(new):
            diffs.update(new)
            marks.append(candidate)
        candidate += 1
    return np.asarray(marks, dtype=float)


def make_golomb_array(
    nants=6,
    nfreqs=200,
    f0=100e6,
    df=100e3,
    spacing=2.0,
    **kwargs,
):
    """Golomb-ruler east-west array (no redundant baselines), point-source sky."""
    marks = golomb_marks(nants)
    antpos = np.zeros((nants, 3))
    antpos[:, 0] = marks * spacing
    freqs = f0 + df * np.arange(nfreqs)
    return make_visdata(antpos, freqs, **kwargs)


def make_redundant_array(
    nfreqs=200,
    f0=100e6,
    df=100e3,
    spacing=2.0,
    copy_offset_north=50.0,
    **kwargs,
):
    """3-ant Golomb array + an identical copy offset north: exact redundancy.

    Mirrors the reference "garray_3ant_2_copies" fixture concept
    (tests/test_calibration.py:31-36): pairs (0,1)/(3,4), (1,2)/(4,5),
    (0,2)/(3,5) are redundant."""
    antpos = np.zeros((6, 3))
    antpos[:3, 0] = GOLOMB_3 * spacing
    antpos[3:, 0] = GOLOMB_3 * spacing
    antpos[3:, 1] = copy_offset_north
    freqs = f0 + df * np.arange(nfreqs)
    return make_visdata(antpos, freqs, **kwargs)


def make_hera_core(
    nside=19,
    spacing=14.6,
    bllen_max=45.0,
    nfreqs=1536,
    ntimes=1,
    nsrc=50,
    seed=1,
    min_dly=10.0,
    offset=10.0,
):
    """HERA-like redundant core whose sky lies exactly in the DPSS basis.

    An ``nside`` x ``nside`` grid at ``spacing`` m (HERA's dish pitch) keeps
    the baselines no longer than ``bllen_max`` — the short, calibration-
    relevant spacings. Each time observes its own point-source sky (seed
    ``seed + t``), simulated once per unique spacing and projected onto that
    spacing's DPSS operator, so a perfect foreground fit exists and blind
    self-cal can suppress the residual to rounding level.

    Returns ``(visdata, fg_model_comps_dict)``; the components are the
    per-baseline DPSS basis the sky was projected onto."""
    from . import models

    xs, ys = np.meshgrid(np.arange(nside), np.arange(nside))
    antpos = np.zeros((nside * nside, 3))
    antpos[:, 0] = xs.ravel() * spacing
    antpos[:, 1] = ys.ravel() * spacing
    nants = nside * nside
    pairs, vecs = [], []
    for i in range(nants):
        for j in range(i + 1, nants):
            v = antpos[j] - antpos[i]
            if np.linalg.norm(v) <= bllen_max:
                pairs.append((i, j))
                vecs.append(v)
    vecs = np.asarray(vecs)
    nbls = len(pairs)
    # exact grid: rounding makes redundant vectors compare equal
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    inverse = inverse.ravel()
    freqs = 100e6 + 100e3 * np.arange(nfreqs)
    lengths = np.linalg.norm(uniq, axis=1)
    cache = {}
    operators = [
        models.yield_dpss_model_comps_bl_grp(
            lengths[u], freqs, min_dly=min_dly, offset=offset, operator_cache=cache
        )
        for u in range(len(uniq))
    ]
    data = np.empty((ntimes, nbls, nfreqs), dtype=np.complex128)
    for t in range(ntimes):
        vis = point_source_visibilities(uniq, freqs, nsrc=nsrc, seed=seed + t)
        for u, mat in enumerate(operators):
            vis[u] = mat @ (mat.T @ vis[u])
        data[t] = vis[inverse]

    times = 2459122.25 + np.arange(ntimes) * 10.7 / 86400.0
    nblts = nbls * ntimes
    uvd = VisData(
        telescope_name="HERA-CORE-SIM",
        instrument="HERA-CORE-SIM",
        latitude=HERA_LAT,
        longitude=HERA_LON,
        altitude=HERA_ALT,
        channel_width=100e3,
        ant_1_array=np.tile([p[0] for p in pairs], ntimes).astype(np.int64),
        ant_2_array=np.tile([p[1] for p in pairs], ntimes).astype(np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=_enu_to_ecef_rel(antpos, HERA_LAT, HERA_LON),
        freq_array=freqs[None, :],
        integration_time=np.full(nblts, 10.7),
        lst_array=np.zeros(nblts),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.repeat(times, nbls),
        uvw_array=np.tile(vecs, (ntimes, 1)),
        data_array=data.reshape(nblts, 1, nfreqs, 1),
        flag_array=np.zeros((nblts, 1, nfreqs, 1), dtype=bool),
        nsample_array=np.ones((nblts, 1, nfreqs, 1), dtype=np.float32),
    )
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=min_dly, offset=offset)
    return uvd, comps


def make_noise_with_rfi_flags(
    nants=6,
    nfreqs=128,
    ntimes=2,
    f0=150e6,
    df=80e3,
    flag_fraction_chans=0.15,
    flag_fraction_rows=0.05,
    seed=3,
):
    """Pure-noise dataset with realistic RFI-like flags.

    Mirrors the reference MWA noise sim fixture role
    (tests/test_calibration.py:44-48, 519-541): narrowband fully-flagged
    channels plus scattered flags; used to verify the pipeline produces
    finite outputs under heavy flagging."""
    antpos = np.zeros((nants, 3))
    antpos[:, 0] = np.asarray(golomb_marks(nants)) * 5.0
    freqs = f0 + df * np.arange(nfreqs)
    uvd = make_visdata(antpos, freqs, ntimes=ntimes, nsrc=10, seed=seed)
    rng = np.random.default_rng(seed + 1)
    noise = rng.standard_normal(uvd.data_array.shape) + 1j * rng.standard_normal(
        uvd.data_array.shape
    )
    uvd.data_array = (uvd.data_array + 0.2 * np.sqrt(np.mean(np.abs(uvd.data_array) ** 2)) * noise)
    nflag_chans = max(1, int(flag_fraction_chans * nfreqs))
    rfi_chans = rng.choice(nfreqs, size=nflag_chans, replace=False)
    uvd.flag_array[:, :, rfi_chans, :] = True
    scattered = rng.uniform(size=uvd.flag_array.shape) < flag_fraction_rows
    uvd.flag_array |= scattered
    return uvd
