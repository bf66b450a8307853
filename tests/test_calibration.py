"""Unit + integration tests for the solver and calibration drivers.

Mirrors the reference test strategy (reference tests/test_calibration.py):
projected-sky fixtures so a perfect fit exists, convergence-ratio asserts
(resid rms <= 1e-2 x model rms and data rms), tensorization round trips,
flag/skip handling, freeze-model gain recovery, and regularization modes.
"""


import numpy as np
import pytest

from calamity_tpu import cal_utils, calibration, models, simulate
from calamity_tpu.io import FlagWeights
from calamity_tpu.ops.loss import fg_model_all_chunks
from calamity_tpu.ops.lstsq import init_coeffs_chunk
from calamity_tpu.solver.tensorize import FitSpec, chunk_fitting_groups

RMS = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))


def project_onto_dpss(uvd, comps):
    """Project each baseline's spectra onto its DPSS subspace in place."""
    for key, mat in comps.items():
        ap = key[0][0]
        d = uvd.get_data(ap + ("xx",))
        proj = (mat @ (d @ mat).T).T
        rows, conj = uvd._bl_time_rows(ap[0], ap[1])
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj
    return uvd


# --------------------------------------------------------------------- #
# fixtures
# --------------------------------------------------------------------- #
@pytest.fixture()
def dpss_vectors(sky_model):
    return models.yield_pbl_dpss_model_comps(sky_model, offset=2.0 / 0.3, min_dly=2.0 / 0.3)


@pytest.fixture()
def sky_model_projected(sky_model, dpss_vectors):
    return project_onto_dpss(sky_model, dpss_vectors)


@pytest.fixture()
def gains(sky_model):
    return cal_utils.blank_uvcal_from_uvdata(sky_model)


@pytest.fixture()
def gains_randomized(gains):
    rng = np.random.default_rng(11)
    g = gains.copy()
    g.gain_array = g.gain_array + 1e-2 * rng.standard_normal(
        g.gain_array.shape
    ) + 1e-2j * rng.standard_normal(g.gain_array.shape)
    return g


@pytest.fixture()
def uvdata(sky_model_projected):
    """Projected sky + EoR-like noise 50 dB down (reference fixture concept)."""
    uvd = sky_model_projected.copy()
    rng = np.random.default_rng(3)
    amp = 1e-5 * RMS(uvd.data_array)
    uvd.data_array = uvd.data_array + amp * (
        rng.standard_normal(uvd.data_array.shape)
        + 1j * rng.standard_normal(uvd.data_array.shape)
    )
    return uvd


@pytest.fixture()
def weights(sky_model):
    uvf = FlagWeights(sky_model, mode="flag")
    uvf.weights_array = np.ones_like(uvf.flag_array, dtype=np.float64)
    return uvf


@pytest.fixture()
def sky_model_projected_multitime(sky_model_projected):
    uvd2 = sky_model_projected.copy()
    uvd2.time_array = uvd2.time_array + 2.0
    return sky_model_projected + uvd2


@pytest.fixture()
def gains_multitime(sky_model_projected_multitime):
    return cal_utils.blank_uvcal_from_uvdata(sky_model_projected_multitime)


# --------------------------------------------------------------------- #
# unit tests: packing / round trips
# --------------------------------------------------------------------- #
def test_chunk_fitting_groups(dpss_vectors):
    chunked = chunk_fitting_groups(dpss_vectors)
    maxvecs = max(m.shape[1] for m in dpss_vectors.values())
    assert list(chunked.keys()) == [(1, maxvecs)]
    assert len(chunked[(1, maxvecs)]) == len(dpss_vectors)


def test_fitspec_comps_roundtrip(sky_model_projected, dpss_vectors, gains):
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map, dtype=np.float64)
    found = 0
    for chunk, meta in zip(spec.chunks, spec.meta):
        comps = np.asarray(chunk.comps)
        for g, fit_grp in enumerate(meta.fit_grps):
            mat = dpss_vectors[fit_grp]
            assert np.allclose(comps[g, 0, :, : mat.shape[1]], mat)
            assert np.allclose(comps[g, 0, :, mat.shape[1] :], 0.0)
            found += 1
    assert found == len(dpss_vectors)


def test_pack_gains(gains, sky_model_projected, dpss_vectors):
    g = gains.copy()
    for i, antnum in enumerate(g.ant_array):
        g.gain_array[i] *= antnum + 1.0
    ants_map = {int(a): i for i, a in enumerate(g.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map, dtype=np.float64)
    g_r, g_i = spec.pack_gains(g, "xx", g.time_array[0])
    for ant, idx in ants_map.items():
        assert np.allclose(np.asarray(g_r)[idx], ant + 1)
        assert np.allclose(np.asarray(g_i)[idx], 0.0)


def test_lstsq_model_roundtrip(sky_model_projected, dpss_vectors, gains):
    """lstsq coeffs -> model reproduces projected data within 1e-2 rms
    (reference test concept, test_calibration.py:341-413)."""
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map, dtype=np.float64)
    t = spec.times[0]
    data_r, data_i, wgts = spec.pack_data(sky_model_projected, "xx", t)
    chunks = spec.device_chunks()
    fg_r = [init_coeffs_chunk(c[0], dr, w) for c, dr, w in zip(chunks, data_r, wgts)]
    fg_i = [init_coeffs_chunk(c[0], di, w) for c, di, w in zip(chunks, data_i, wgts)]
    model_chunks = fg_model_all_chunks(tuple(fg_r), tuple(fg_i), chunks)
    rms = RMS(sky_model_projected.data_array)
    for (vr, vi), dr, di in zip(model_chunks, data_r, data_i):
        assert np.allclose(np.asarray(vr), np.asarray(dr), atol=1e-2 * rms, rtol=0)
        assert np.allclose(np.asarray(vi), np.asarray(di), atol=1e-2 * rms, rtol=0)


def test_insert_model_roundtrip(sky_model_projected, dpss_vectors, gains):
    """Write-back reproduces the original data (reference
    test_insert_model_into_uvdata_tensor, test_calibration.py:416-463)."""
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map, dtype=np.float64)
    t = spec.times[0]
    rms = RMS(sky_model_projected.data_array)
    data_r, data_i, wgts = spec.pack_data(
        sky_model_projected, "xx", t, data_scale_factor=rms
    )
    chunks = spec.device_chunks()
    fg_r = tuple(init_coeffs_chunk(c[0], dr, w) for c, dr, w in zip(chunks, data_r, wgts))
    fg_i = tuple(init_coeffs_chunk(c[0], di, w) for c, di, w in zip(chunks, data_i, wgts))
    inserted = sky_model_projected.copy()
    rng = np.random.default_rng(0)
    inserted.data_array = rng.standard_normal(
        inserted.data_array.shape
    ) + 1j * rng.standard_normal(inserted.data_array.shape)
    spec.insert_model(
        inserted, fg_model_all_chunks(fg_r, fg_i, chunks), "xx", t, scale_factor=rms
    )
    assert np.allclose(
        inserted.data_array, sky_model_projected.data_array, atol=1e-2 * rms, rtol=0
    )


def test_renormalize(sky_model, gains):
    g = gains.copy()
    g.gain_array *= (51.0 + 23j) ** -0.5
    ref = sky_model.copy()
    deconv = sky_model.copy()
    deconv.data_array = deconv.data_array * (51.0 + 23j)
    assert not np.allclose(np.abs(g.gain_array), 1.0)
    calibration.renormalize(ref, deconv, g, polarization="xx", time=sky_model.time_array[0])
    assert np.allclose(np.abs(g.gain_array), 1.0)
    assert np.allclose(np.abs(ref.data_array), np.abs(deconv.data_array))


def test_apply_gains_roundtrip(sky_model, gains_randomized):
    corrupted = cal_utils.apply_gains(sky_model, gains_randomized, inverse=True)
    recovered = cal_utils.apply_gains(corrupted, gains_randomized)
    assert np.allclose(recovered.data_array, sky_model.data_array)
    # gain flags propagate into data flags
    g = gains_randomized.copy()
    g.flag_array[0] = True
    flagged = cal_utils.apply_gains(sky_model, g)
    ant0 = int(g.ant_array[0])
    for ap in flagged.get_antpairs():
        if ant0 in ap:
            assert np.all(flagged.get_flags(ap + ("xx",)))


def test_apply_gains_inplace_matches_copy(sky_model, gains_randomized):
    g = gains_randomized.copy()
    g.flag_array[1] = True
    expect = cal_utils.apply_gains(sky_model, g, inverse=True)
    target = sky_model.copy()
    got = cal_utils.apply_gains(target, g, inverse=True, inplace=True)
    assert got is target  # mutates and returns the input object
    assert np.array_equal(got.data_array, expect.data_array)
    assert np.array_equal(got.flag_array, expect.flag_array)


def test_subtract_model_with_gains_matches_composition(sky_model, gains_randomized):
    rng = np.random.default_rng(7)
    model = sky_model.copy()
    model.flag_array[3, :, ::5] = True
    g = gains_randomized.copy()
    g.flag_array[2] = True
    resid = sky_model.copy()
    resid.data_array = (
        rng.standard_normal(resid.data_array.shape)
        + 1j * rng.standard_normal(resid.data_array.shape)
    ).astype(resid.data_array.dtype)
    # reference composition: materialize g.model, subtract, zero its flags
    mwg = cal_utils.apply_gains(model, g, inverse=True)
    expect = resid.data_array - mwg.data_array
    expect[mwg.flag_array] = 0.0
    got = resid.copy()
    cal_utils.subtract_model_with_gains(got, model, g)
    assert np.allclose(got.data_array, expect)
    # the model itself is untouched
    assert np.array_equal(model.data_array, sky_model.data_array)


def test_insert_model_complex64_target(sky_model_projected, dpss_vectors, gains):
    """Write-back into a complex64 VisData keeps values and dtype."""
    import jax.numpy as jnp

    from calamity_tpu.ops.loss import fg_model_all_chunks
    from calamity_tpu.solver.tensorize import FitSpec

    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map)
    chunks = spec.device_chunks()
    pol = sky_model_projected.get_pols()[0]
    t0 = spec.times[0]
    data_r, data_i, wgts = spec.pack_data(sky_model_projected, pol, t0)
    fg_r = spec.init_coeffs(data_r, wgts)
    fg_i = spec.init_coeffs(data_i, wgts)
    model64 = sky_model_projected.copy()
    model32 = sky_model_projected.copy()
    model32.data_array = model32.data_array.astype(np.complex64)
    mc = fg_model_all_chunks(tuple(map(jnp.asarray, fg_r)),
                             tuple(map(jnp.asarray, fg_i)), chunks)
    spec.insert_model(model64, mc, pol, t0, 2.5)
    spec.insert_model(model32, mc, pol, t0, 2.5)
    assert model32.data_array.dtype == np.complex64
    assert np.allclose(model32.data_array, model64.data_array, rtol=1e-5)


def test_fg_model_host_matches_device():
    """Host write-back einsums reproduce the device fg_model on all three
    packings (dense nu==ngrps, shared nu==1, shared-batched 1<nu<ngrps)."""
    import jax.numpy as jnp

    from calamity_tpu.ops.loss import fg_model, fg_model_host

    rng = np.random.default_rng(3)
    for nu, ngrps, nbls in [(6, 6, 3), (1, 8, 2), (4, 8, 1)]:
        comps = rng.standard_normal((nu, nbls, 16, 5)).astype(np.float32)
        cr = rng.standard_normal((ngrps, 5)).astype(np.float32)
        ci = rng.standard_normal((ngrps, 5)).astype(np.float32)
        vr_d, vi_d = fg_model(jnp.asarray(cr), jnp.asarray(ci), jnp.asarray(comps))
        vr_h, vi_h = fg_model_host(cr, ci, comps)
        assert vr_h.shape == tuple(vr_d.shape)
        np.testing.assert_allclose(vr_h, np.asarray(vr_d), rtol=3e-6, atol=3e-6)
        np.testing.assert_allclose(vi_h, np.asarray(vi_d), rtol=3e-6, atol=3e-6)


def test_flag_poltime(sky_model_projected_multitime, gains_multitime):
    uvd = sky_model_projected_multitime.copy()
    t0 = np.unique(uvd.time_array)[0]
    calibration.flag_poltime(uvd, time=t0, polarization="xx")
    assert np.all(uvd.flag_array[: uvd.Nbls])
    assert not np.any(uvd.flag_array[uvd.Nbls :])
    assert np.allclose(uvd.data_array[: uvd.Nbls], 0.0)
    cal = gains_multitime.copy()
    calibration.flag_poltime(cal, time=t0, polarization="xx")
    assert np.all(cal.flag_array[:, 0, :, 0, 0])
    assert np.allclose(cal.gain_array[:, 0, :, 0, 0], 1.0)
    with pytest.raises(ValueError):
        calibration.flag_poltime("blarghle", time=0, polarization="xx")


def test_get_auto_weights(redundant_visdata):
    w = calibration.get_auto_weights(redundant_visdata)
    assert isinstance(w, FlagWeights)
    # autos are positive smooth spectra -> finite positive weights on crosses
    inds = w.antpair2ind(0, 1)
    vals = w.weights_array[inds, 0, :, 0]
    assert np.all(np.isfinite(vals))
    assert np.all(vals > 0)


def test_get_auto_weights_matches_per_row_lstsq(noise_with_flags):
    """The batched normal-equations solve reproduces per-(auto, time)
    masked lstsq smoothing under realistic flags (VERDICT r1 #4)."""
    uvd = noise_with_flags.copy()
    # add autos (the fixture has none)
    from calamity_tpu import simulate as _sim

    auto = _sim.make_visdata(
        np.zeros((1, 3)), uvd.freq_array[0], ntimes=uvd.Ntimes, include_autos=True
    )
    nblt_a = len(auto.time_array)
    for ant in np.unique(np.concatenate([uvd.ant_1_array, uvd.ant_2_array])):
        a = auto.copy()
        a.ant_1_array[:] = ant
        a.ant_2_array[:] = ant
        a.time_array = np.repeat(np.unique(uvd.time_array), 1)[:nblt_a]
        a.data_array = np.abs(a.data_array).real.astype(complex) + 10.0 + ant
        uvd = uvd + a
    w = calibration.get_auto_weights(uvd)
    freqs = np.asarray(uvd.freq_array[0], dtype=np.float64)
    comps = models.yield_dpss_model_comps_bl_grp(0.0, freqs, offset=25.0)
    # brute-force per-row lstsq for one cross pair
    ap = next(p for p in uvd.get_antpairs() if p[0] != p[1])
    pol = uvd.get_pols()[0]
    smooth = {}
    for ant in ap:
        d = uvd.get_data((ant, ant, pol)).real
        m = ~uvd.get_flags((ant, ant, pol))
        s = np.ones(d.shape)
        for ti in range(d.shape[0]):
            if m[ti].any():
                c, *_ = np.linalg.lstsq(comps[m[ti]], d[ti, m[ti]], rcond=None)
                s[ti] = comps @ c
        smooth[ant] = s
    expect = 1.0 / (smooth[ap[0]] * smooth[ap[1]])
    expect = expect * ~uvd.get_flags(ap + (pol,))
    rows = w.antpair2ind(*ap)
    rows = rows[np.argsort(w.time_array[rows], kind="stable")]
    got = w.weights_array[rows, 0, :, 0]
    assert np.allclose(got, expect, rtol=1e-5, atol=1e-8)


def test_weighted_pack_uses_cached_row_table(sky_model_projected, dpss_vectors, gains, weights):
    """The weights-row lookup is built once per weights object and reused
    across (time, pol) extractions; results match fresh construction."""
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map, dtype=np.float64)
    t = spec.times[0]
    r1 = spec.pack_data(sky_model_projected, "xx", t, weights=weights)
    assert spec._wrows_cache[0] is weights
    tables = spec._wrows_cache[1]
    r2 = spec.pack_data(sky_model_projected, "xx", t, weights=weights)
    assert spec._wrows_cache[1] is tables  # reused, not rebuilt
    for a, b in zip(r1[2], r2[2]):
        assert np.allclose(np.asarray(a), np.asarray(b))
    # a DIFFERENT weights object replaces the single-entry cache (no
    # unbounded growth pinning every weights object ever used)
    w2 = weights.copy()
    spec.pack_data(sky_model_projected, "xx", t, weights=w2)
    assert spec._wrows_cache[0] is w2


def test_resolve_comps_precision_defaults():
    """comps_precision=None resolves to float32 for ANY warm-started fit
    (serial or scanned — short per-time descents interleave badly with
    the two-phase schedule) and for f64; mixed otherwise (review r3: the
    serial warm-started path was silently getting mixed)."""
    from calamity_tpu.calibration import resolve_comps_precision

    assert resolve_comps_precision(np.float32, False) == "mixed"
    assert resolve_comps_precision(np.float32, True) == "float32"
    assert resolve_comps_precision(np.float64, False) == "float32"
    assert resolve_comps_precision(np.float64, True) == "float32"


def test_blt_table_lookup_semantics():
    """BltTable (the vectorized packing lookup) resolves forward /
    conjugated / missing pairs and irregular time counts like the
    per-baseline loop it replaced."""
    from calamity_tpu.solver.tensorize import BltTable

    ant1 = np.asarray([0, 1, 0, 1, 2])
    ant2 = np.asarray([1, 2, 1, 2, 3])
    times = np.asarray([2.0, 1.0, 1.0, 2.0, 1.0])  # unsorted within pairs
    t = BltTable(ant1, ant2, times)
    sel, conj = t.lookup_pairs(np.asarray([[0, 1], [2, 1], [2, 3]]))
    assert list(conj) == [False, True, False]
    rows = t.rows_matrix(sel[:2], 2)  # pairs (0,1) and (1,2): 2 times each
    # time-sorted within pair: (0,1) has rows 2 (t=1) then 0 (t=2)
    assert rows[:, 0].tolist() == [2, 0]
    assert rows[:, 1].tolist() == [1, 3]
    with pytest.raises(KeyError, match="not present"):
        t.lookup_pairs(np.asarray([[0, 3]]))
    # antennas outside the table's range must raise, never alias: with
    # M=4, (0,6) has key 0*4+6 == key of (1,2) — a silent collision would
    # fit another baseline's rows (review r3)
    with pytest.raises(KeyError, match="not present"):
        t.lookup_pairs(np.asarray([[0, 6]]))
    with pytest.raises(KeyError, match="not present"):
        t.lookup_pairs(np.asarray([[-1, 1]]))
    with pytest.raises(ValueError, match="irregular"):
        t.rows_matrix(sel, 2)  # (2,3) occurs once


def test_pack_data_missing_weights_pol_raises(
    sky_model_projected, dpss_vectors, gains, weights
):
    """A weights object lacking the fitted polarization names it in the
    error instead of a bare IndexError (ADVICE r2; user-reachable via
    --weights_file)."""
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(sky_model_projected, dpss_vectors, ants_map, dtype=np.float64)
    w = weights.copy()
    w.polarization_array = np.asarray([-6])  # yy only; fit asks for xx
    with pytest.raises(ValueError, match="no polarization 'xx'"):
        spec.pack_data(sky_model_projected, "xx", spec.times[0], weights=w)


# --------------------------------------------------------------------- #
# integration: convergence-ratio tests
# --------------------------------------------------------------------- #
def _assert_converged(uvd_in, model, resid):
    assert RMS(model.data_array) >= 1e2 * RMS(resid.data_array)
    assert RMS(uvd_in.data_array) >= 1e2 * RMS(resid.data_array)


@pytest.mark.parametrize(
    "perfect_data, use_min, noweights",
    [(True, False, True), (False, False, True), (False, True, False)],
)
def test_calibrate_and_model_dpss(
    uvdata, sky_model_projected, gains_randomized, gains, weights,
    perfect_data, use_min, noweights,
):
    weight = None if noweights else weights
    if perfect_data:
        uvd_in, g_in = sky_model_projected, gains
    else:
        uvd_in, g_in = uvdata, gains_randomized
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=uvd_in,
        gains=g_in,
        use_redundancy=False,
        sky_model=None,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        weights=weight,
        use_min=use_min,
        model_regularization="post_hoc",
    )
    _assert_converged(uvd_in, model, resid)
    assert len(fit_history) == 1
    assert len(fit_history[0]) == 1
    assert len(fit_history[0][0]["loss"]) >= 1


def test_calibrate_and_model_dpss_multitime(
    sky_model_projected_multitime, gains_multitime
):
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected_multitime,
        gains=gains_multitime,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
    )
    _assert_converged(sky_model_projected_multitime, model, resid)
    assert len(fit_history) == 1
    assert len(fit_history[0]) == 2


def test_calibrate_and_model_dpss_warm_start(
    sky_model_projected_multitime, gains_multitime
):
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected_multitime,
        gains=gains_multitime,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        init_guesses_from_previous_time_step=True,
        model_regularization="post_hoc",
    )
    _assert_converged(sky_model_projected_multitime, model, resid)
    assert len(fit_history[0]) == 2


@pytest.mark.parametrize("comps_precision", ["bfloat16", "mixed"])
def test_calibrate_and_model_dpss_comps_precision(
    sky_model_projected, gains, comps_precision
):
    """bf16 basis storage converges to the documented bf16 floor; the mixed
    schedule recovers the float32 floor (docs/BF16_COMPS.md)."""
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        gains=gains,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        comps_precision=comps_precision,
    )
    ratio = RMS(resid.data_array) / RMS(sky_model_projected.data_array)
    if comps_precision == "bfloat16":
        # floor set by bf16 quantization of the basis (~4e-3 relative)
        assert ratio <= 1e-2
    else:
        assert ratio <= 1e-3
        assert len(fit_history[0][0]["phase_steps"]) == 2
        assert sum(fit_history[0][0]["phase_steps"]) == len(
            fit_history[0][0]["loss"]
        )


def test_comps_precision_time_parallel(sky_model_projected_multitime, gains_multitime):
    """Mixed-precision schedule through the batched (time_parallel) path."""
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected_multitime,
        gains=gains_multitime,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        time_parallel=True,
        comps_precision="mixed",
    )
    _assert_converged(sky_model_projected_multitime, model, resid)
    assert len(fit_history[0]) == 2


def test_default_comps_precision_reaches_f32_floor(sky_model_projected, gains):
    """The DEFAULT configuration (comps_precision=None -> "mixed" for f32
    fits) reaches the same residual floor as an explicit float32 run
    (VERDICT r2 item 3: the shipped default must deliver the measured-best
    schedule)."""
    common = dict(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        maxsteps=3000,
        tol=1e-12,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
    )
    model_d, resid_d, _, hist_d = calibration.calibrate_and_model_dpss(
        gains=gains.copy(), **common
    )
    model_f, resid_f, _, _ = calibration.calibrate_and_model_dpss(
        gains=gains.copy(), comps_precision="float32", **common
    )
    # the default resolved to the two-phase mixed schedule...
    assert "phase_steps" in hist_d[0][0]
    # ...and still reaches the full f32 convergence floor
    _assert_converged(sky_model_projected, model_d, resid_d)
    assert RMS(resid_d.data_array) <= 3 * max(RMS(resid_f.data_array), 1e-12)


def test_default_comps_precision_f64_stays_native(sky_model_projected, gains):
    """Under a float64 fit the default stays native-precision (no bf16
    phase)."""
    model, resid, _, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        gains=gains,
        maxsteps=50,
        tol=0.0,
        dtype=np.float64,
        model_regularization="post_hoc",
    )
    assert "phase_steps" not in hist[0][0]


def test_comps_precision_scan_mixed_supported(
    sky_model_projected_multitime, gains_multitime
):
    """comps_precision='mixed' on the warm-started scan no longer raises
    (VERDICT r3 item 2: the segmented per-time machinery runs the two-phase
    schedule per time); both phases are recorded in the history. Full
    convergence/resume coverage: test_checkpoint.test_scan_mixed_precision."""
    _, _, _, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected_multitime,
        gains=gains_multitime,
        maxsteps=10,
        tol=0.0,
        time_parallel=True,
        init_guesses_from_previous_time_step=True,
        comps_precision="mixed",
    )
    for t in hist[0]:
        assert len(hist[0][t]["loss"]) == 20  # bf16 + f32 phases


def test_wgts_precision_bfloat16(sky_model_projected, gains):
    """bf16 weight storage reaches the same convergence floor: flagged
    samples stay exactly zero-weighted in bf16, and projected data's
    optimum (resid = 0) is weight-quantization invariant."""
    uvd = sky_model_projected.copy()
    # frequency-dependent flags so the weights cube is full-width
    uvd.flag_array[2, :, ::7] = True
    uvd.flag_array[5, :, 3:9] = True
    common = dict(
        gains=gains.copy(), maxsteps=400, tol=1e-12, learning_rate=1e-2,
        model_regularization=None, correct_resid=False, correct_model=False,
        time_parallel=True, comps_precision="float32",
    )
    m32, r32, g32, i32 = calibration.calibrate_and_model_dpss(
        uvdata=uvd, wgts_precision="float32", **common
    )
    m16, r16, g16, i16 = calibration.calibrate_and_model_dpss(
        uvdata=uvd, wgts_precision="bfloat16", **common
    )
    f32 = i32[0][0]["loss"][-1]
    f16 = i16[0][0]["loss"][-1]
    assert f16 < 5e-7  # converged
    assert np.isclose(np.log10(f16 + 1e-30), np.log10(f32 + 1e-30), atol=1.0)
    assert np.allclose(g16.gain_array, g32.gain_array, atol=2e-3)

    # serial path: same storage lever, same floor
    ser = dict(common, time_parallel=False, gains=gains.copy())
    _, _, g_s, i_s = calibration.calibrate_and_model_dpss(
        uvdata=uvd, wgts_precision="bfloat16", **ser
    )
    assert i_s[0][0]["loss"][-1] < 5e-7
    assert np.allclose(g_s.gain_array, g32.gain_array, atol=2e-3)

    with pytest.raises(ValueError, match="wgts_precision"):
        calibration.calibrate_and_model_dpss(
            uvdata=uvd, wgts_precision="float16", **common
        )


def test_comps_precision_invalid_raises(sky_model_projected, gains):
    with pytest.raises(ValueError, match="comps_precision"):
        calibration.calibrate_and_model_dpss(
            min_dly=2.0 / 0.3,
            offset=2.0 / 0.3,
            uvdata=sky_model_projected,
            gains=gains,
            maxsteps=10,
            comps_precision="float16",
        )


@pytest.mark.parametrize("flagtime", [0, 1])
def test_calibrate_and_model_dpss_flagged(
    sky_model_projected_multitime, gains_multitime, flagtime
):
    uvd = sky_model_projected_multitime.copy()
    unflagtime = {0: 1, 1: 0}[flagtime]
    tflag = np.unique(uvd.time_array)[flagtime]
    uvd.flag_array[np.isclose(uvd.time_array, tflag, rtol=0, atol=1e-7)] = True
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=uvd,
        gains=gains_multitime,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        skip_threshold=0.5,
        model_regularization="post_hoc",
    )
    for ap in resid.get_antpairs():
        bl = ap + ("xx",)
        assert np.allclose(resid.get_data(bl)[flagtime, :], 0.0)
        assert np.allclose(model.get_data(bl)[flagtime, :], 0.0)
        assert np.all(model.get_flags(bl)[flagtime, :])
        assert np.all(resid.get_flags(bl)[flagtime, :])
        assert np.allclose(fitted_gains.get_gains(bl[0], "Jxx")[:, flagtime], 1.0)
        assert np.all(fitted_gains.get_flags(bl[1], "Jxx")[:, flagtime])
    # the unflagged time still converges
    tgood = np.unique(resid.time_array)[unflagtime]
    resid_g = resid.select(times=[tgood], inplace=False)
    model_g = model.select(times=[tgood], inplace=False)
    gains_g = fitted_gains.select(times=[tgood], inplace=False)
    resid_g = cal_utils.apply_gains(resid_g, gains_g)
    model_g = cal_utils.apply_gains(model_g, gains_g)
    assert RMS(model_g.data_array) >= 1e2 * RMS(resid_g.data_array)


def test_calibrate_and_model_dpss_freeze_model(
    sky_model_projected, gains_randomized, weights
):
    """Gain-only calibration against a perfect sky model recovers |g| to 1e-4
    (reference test_calibration.py:730-755)."""
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        gains=gains_randomized,
        use_redundancy=False,
        sky_model=sky_model_projected,
        freeze_model=True,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        weights=weights,
        model_regularization="sum",
        learning_rate=1e-2,  # the reference's CLI default (calibration.py:1905)
    )
    assert RMS(model.data_array) >= 1e2 * RMS(resid.data_array)
    # the data have unity true gains; the randomized starting gains must be
    # pulled back to |g| = 1 (meaningful because our driver copies gains)
    assert np.allclose(np.abs(fitted_gains.gain_array), 1.0, rtol=0.0, atol=1e-4)


def test_calibrate_and_model_dpss_with_rfi_flags(noise_with_flags):
    """Heavily flagged noise produces finite outputs under post-hoc
    renormalization (reference test_calibration.py:519-541)."""
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=4.0 / 0.3,
        offset=100.0,
        uvdata=noise_with_flags,
        gains=None,
        maxsteps=200,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        red_tol=0.3,
        model_regularization="post_hoc",
    )
    assert np.all(np.isfinite(resid.data_array))
    assert np.all(np.isfinite(model.data_array))
    assert np.all(np.isfinite(fitted_gains.gain_array))


@pytest.mark.parametrize(
    "use_redundancy, nsamples_in_weights, use_model_snr_weights",
    [(True, True, False), (False, False, False), (False, False, True)],
)
@pytest.mark.slow
def test_calibrate_and_model_dpss_redundant(
    sky_model_redundant, use_redundancy, nsamples_in_weights, use_model_snr_weights
):
    uvd = sky_model_redundant.copy()
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3)
    project_onto_dpss(uvd, comps)
    rng = np.random.default_rng(13)
    uvd.data_array = uvd.data_array + 1e-4 * RMS(uvd.data_array) * (
        rng.standard_normal(uvd.data_array.shape)
        + 1j * rng.standard_normal(uvd.data_array.shape)
    )
    g0 = cal_utils.blank_uvcal_from_uvdata(uvd)
    g0.gain_array = g0.gain_array + 1e-2 * rng.standard_normal(
        g0.gain_array.shape
    ) + 1e-2j * rng.standard_normal(g0.gain_array.shape)
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=uvd,
        gains=g0,
        use_redundancy=use_redundancy,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=False,
        correct_model=False,
        model_regularization="sum",
        nsamples_in_weights=nsamples_in_weights,
        use_model_snr_weights=use_model_snr_weights,
    )
    resid = cal_utils.apply_gains(resid, fitted_gains)
    model = cal_utils.apply_gains(model, fitted_gains)
    _assert_converged(uvd, model, resid)


def test_calibrate_and_model_dft(sky_model, gains):
    """DFT basis variant converges on data projected onto the DFT subspace."""
    uvd = sky_model.copy()
    comps = models.yield_pbl_model_comps(
        uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3, basis="dft"
    )
    for key, mat in comps.items():
        ap = key[0][0]
        d = uvd.get_data(ap + ("xx",))
        proj = (mat @ np.linalg.lstsq(mat, d.T, rcond=None)[0]).T
        rows, conj = uvd._bl_time_rows(*ap)
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_dft(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=uvd,
        gains=gains,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
    )
    _assert_converged(uvd, model, resid)


@pytest.mark.parametrize("use_jax_comps, model_regularization", [(True, "post_hoc"), (False, "sum")])
def test_calibrate_and_model_mixed(
    uvdata, gains_randomized, weights, use_jax_comps, model_regularization
):
    model, resid, fitted_gains, fit_history = calibration.calibrate_and_model_mixed(
        min_dly=0.0,
        offset=0.0,
        ant_dly=2.0 / 3.0,
        red_tol_freq=0.5,
        uvdata=uvdata,
        gains=gains_randomized,
        use_redundancy=False,
        sky_model=None,
        freeze_model=True,
        maxsteps=3000,
        tol=1e-10,
        correct_resid=False,
        correct_model=False,
        weights=weights,
        use_tensorflow_to_derive_modeling_comps=use_jax_comps,
        grp_size_threshold=1,
        model_regularization=model_regularization,
    )
    resid = cal_utils.apply_gains(resid, fitted_gains)
    model = cal_utils.apply_gains(model, fitted_gains)
    _assert_converged(uvdata, model, resid)


def test_nvec_bucketing(sky_model_projected, dpss_vectors, gains):
    """Power-of-two mode-count bucketing splits chunks and bounds padding."""
    chunked = chunk_fitting_groups(dpss_vectors, nvec_bucketing=True)
    assert len(chunked) >= 2  # golomb array spans several mode-count octaves
    for (nbl, maxv), grps in chunked.items():
        for mat in grps.values():
            assert mat.shape[1] <= maxv
            assert maxv < 2 * max(mat.shape[1], 8) + 1
    # end-to-end: bucketed fit converges identically
    model, resid, fitted, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        gains=gains,
        maxsteps=2000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        nvec_bucketing=True,
    )
    assert RMS(model.data_array) >= 1e2 * RMS(resid.data_array)


@pytest.mark.slow
def test_include_autos(redundant_visdata):
    """Autocorrelations can be included in the fit (include_autos=True);
    the model covers them and converges (reference include_autos flag,
    calibration.py:1109-1111)."""
    uvd = redundant_visdata.copy()
    comps = models.yield_pbl_dpss_model_comps(
        uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3, include_autos=True
    )
    project_onto_dpss(uvd, comps)
    model, resid, fitted, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=uvd,
        gains=None,
        include_autos=True,
        maxsteps=2000,
        tol=1e-10,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
    )
    assert model.Nbls == uvd.Nbls  # autos kept
    assert RMS(model.data_array) >= 1e2 * RMS(resid.data_array)


def test_correct_flags_matrix(sky_model_projected, gains):
    """correct_model=False leaves the gain-corrupted model; correcting it
    post hoc reproduces the corrected-model output (reference semantics,
    calibration.py:1322-1330)."""
    common = dict(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        gains=gains,
        maxsteps=1500,
        tol=1e-10,
        model_regularization="post_hoc",
    )
    m1, r1, g1, _ = calibration.calibrate_and_model_dpss(
        correct_model=True, correct_resid=False, **common
    )
    m2, r2, g2, _ = calibration.calibrate_and_model_dpss(
        correct_model=False, correct_resid=False, **common
    )
    # with unity true gains and blank starting gains the fitted gains stay
    # near unity, so corrected and uncorrected models agree to gain scale
    m2c = cal_utils.apply_gains(m2, g2)
    assert np.allclose(m2c.data_array, m1.data_array, atol=1e-5 * RMS(m1.data_array))
    # resid identical either way (computed from uncorrected model)
    assert np.allclose(r1.data_array, r2.data_array, atol=1e-7 * RMS(m1.data_array))


@pytest.mark.slow
def test_shared_basis_chunks(redundant_visdata):
    """Redundant arrays: baselines sharing a DPSS operator get shared-basis
    chunks (comps stored once), and the fit matches the dense path."""
    uvd = redundant_visdata.copy()
    uvd.select(bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]], inplace=True)
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3)
    project_onto_dpss(uvd, comps)
    gains0 = cal_utils.blank_uvcal_from_uvdata(uvd)
    ants_map = {int(a): i for i, a in enumerate(gains0.ant_array)}
    spec = FitSpec(uvd, comps, ants_map, dtype=np.float64, shared_basis=True)
    shared = [
        c for c in spec.chunks
        if c.comps.shape[0] < c.a0.shape[0]
    ]
    assert len(shared) >= 1  # the duplicated-triad pairs share operators
    total_valid = sum(int(m.valid.sum()) for m in spec.meta)
    assert total_valid == uvd.Nbls

    common = dict(
        min_dly=2.0 / 0.3, offset=2.0 / 0.3, uvdata=uvd, gains=gains0,
        maxsteps=1500, tol=1e-10, correct_resid=True, correct_model=True,
        model_regularization="post_hoc",
    )
    m1, r1, g1, _ = calibration.calibrate_and_model_dpss(shared_basis=True, **common)
    m2, r2, g2, _ = calibration.calibrate_and_model_dpss(shared_basis=False, **common)
    assert RMS(m1.data_array) >= 1e2 * RMS(r1.data_array)
    # shared and dense packings converge to the same model
    assert np.allclose(m1.data_array, m2.data_array,
                       atol=1e-4 * RMS(m2.data_array), rtol=0)


@pytest.mark.slow
def test_shared_basis_time_parallel(redundant_visdata):
    uvd = redundant_visdata.copy()
    uvd.select(bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]], inplace=True)
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3)
    project_onto_dpss(uvd, comps)
    u2 = uvd.copy()
    u2.time_array = u2.time_array + 2.0
    both = uvd + u2
    import calamity_tpu.parallel as par

    mesh = par.make_mesh(n_data=2, n_bl=4)
    model, resid, gains, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3, offset=2.0 / 0.3, uvdata=both, gains=None,
        maxsteps=1500, tol=1e-10, correct_resid=True, correct_model=True,
        model_regularization="post_hoc", shared_basis=True,
        time_parallel=True, mesh=mesh,
    )
    assert RMS(model.data_array) >= 1e2 * RMS(resid.data_array)
    assert len(hist[0]) == 2


def test_divergence_watchdog(sky_model_projected, gains):
    """A diverging fit (absurd learning rate) stops early instead of
    burning the full step budget, and reports non-finite loss."""
    model, resid, fitted, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=sky_model_projected,
        gains=gains,
        maxsteps=3000,
        tol=0.0,
        learning_rate=1e12,
        model_regularization="post_hoc",
    )
    losses = np.asarray(hist[0][0]["loss"])
    assert len(losses) < 3000  # stopped early
    assert not np.isfinite(losses[-1])


@pytest.mark.slow
def test_mixed_save_dict_roundtrip(tmp_path, uvdata, gains_randomized, weights):
    """save_dict_to persists the component dict; a reloaded dict feeds
    model_comps_dict= for an identical fit (reference calibration.py:
    1436-1442, 1471-1489)."""
    import os

    dict_path = os.path.join(str(tmp_path), "comps.npy")
    common = dict(
        min_dly=0.0,
        offset=0.0,
        ant_dly=2.0 / 3.0,
        red_tol_freq=0.5,
        uvdata=uvdata,
        gains=gains_randomized,
        freeze_model=True,
        maxsteps=500,
        tol=1e-10,
        correct_resid=False,
        correct_model=False,
        weights=weights,
        grp_size_threshold=1,
        model_regularization="sum",
    )
    m1, r1, g1, _ = calibration.calibrate_and_model_mixed(
        save_dict_to=dict_path, **common
    )
    assert os.path.exists(dict_path)
    reloaded = np.load(dict_path, allow_pickle=True).item()
    assert isinstance(reloaded, dict) and len(reloaded) > 0
    m2, r2, g2, _ = calibration.calibrate_and_model_mixed(
        model_comps_dict=reloaded, **common
    )
    assert np.allclose(m1.data_array, m2.data_array)
    assert np.allclose(g1.gain_array, g2.gain_array)


@pytest.mark.slow
def test_shared_batched_grid_core():
    """Grid-core array: many operator classes bucket into shared-BATCHED
    chunks (1 < U < ngrps, padded classes), and the fit matches the dense
    packing exactly."""
    import itertools

    from calamity_tpu.io.visdata import VisData

    n = 5
    spacing = 14.6
    xs, ys = np.meshgrid(np.arange(n), np.arange(n))
    antpos = np.zeros((n * n, 3))
    antpos[:, 0] = xs.ravel() * spacing
    antpos[:, 1] = ys.ravel() * spacing
    pairs, vecs = [], []
    for i, j in itertools.combinations(range(n * n), 2):
        v = antpos[j] - antpos[i]
        if np.linalg.norm(v) <= 2.1 * spacing:
            pairs.append((i, j))
            vecs.append(v)
    vecs = np.asarray(vecs)
    nbls = len(pairs)
    freqs = 100e6 + 100e3 * np.arange(64)
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    vis_uniq = simulate.point_source_visibilities(uniq, freqs, nsrc=20, seed=2)
    data = vis_uniq[inverse]
    uvd = VisData(
        telescope_name="GRID", instrument="GRID",
        latitude=simulate.HERA_LAT, longitude=simulate.HERA_LON,
        altitude=simulate.HERA_ALT, channel_width=100e3,
        ant_1_array=np.asarray([p[0] for p in pairs], dtype=np.int64),
        ant_2_array=np.asarray([p[1] for p in pairs], dtype=np.int64),
        antenna_numbers=np.arange(n * n, dtype=np.int64),
        antenna_names=[f"A{i}" for i in range(n * n)],
        antenna_positions=simulate._enu_to_ecef_rel(
            antpos, simulate.HERA_LAT, simulate.HERA_LON
        ),
        freq_array=freqs[None, :],
        integration_time=np.full(nbls, 10.7),
        lst_array=np.zeros(nbls),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.full(nbls, 2459122.25),
        uvw_array=vecs,
        data_array=data[:, None, :, None].astype(np.complex128),
        flag_array=np.zeros((nbls, 1, 64, 1), dtype=bool),
        nsample_array=np.ones((nbls, 1, 64, 1), dtype=np.float32),
    )
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3)
    project_onto_dpss(uvd, comps)
    gains0 = cal_utils.blank_uvcal_from_uvdata(uvd)
    ants_map = {int(a): i for i, a in enumerate(gains0.ant_array)}
    spec = FitSpec(uvd, comps, ants_map, dtype=np.float64, shared_basis=True)
    batched = [
        (c, m) for c, m in zip(spec.chunks, spec.meta)
        if 1 < c.comps.shape[0] < c.a0.shape[0]
    ]
    assert batched, "grid core must produce shared-batched chunks"
    assert any(not m.valid.all() for c, m in batched), "padding entries expected"
    assert sum(int(m.valid.sum()) for m in spec.meta) == uvd.Nbls

    common = dict(
        min_dly=2.0 / 0.3, offset=2.0 / 0.3, uvdata=uvd, gains=gains0,
        fg_model_comps_dict=comps, maxsteps=1000, tol=1e-11,
        correct_resid=True, correct_model=True, model_regularization="post_hoc",
    )
    m1, r1, g1, _ = calibration.calibrate_and_model_dpss(shared_basis=True, **common)
    m2, r2, g2, _ = calibration.calibrate_and_model_dpss(shared_basis=False, **common)
    assert RMS(m1.data_array) >= 1e2 * RMS(r1.data_array)
    assert np.allclose(m1.data_array, m2.data_array,
                       atol=1e-4 * RMS(m2.data_array), rtol=0)


@pytest.mark.slow
def test_remat_matches_default(sky_model_projected, gains):
    """remat=True produces the same fit (recompute-in-backward only trades
    memory for FLOPs)."""
    common = dict(
        min_dly=2.0 / 0.3, offset=2.0 / 0.3, uvdata=sky_model_projected,
        gains=gains, maxsteps=500, tol=1e-10, correct_resid=True,
        correct_model=True, model_regularization="post_hoc",
    )
    m1, r1, g1, h1 = calibration.calibrate_and_model_dpss(remat=True, **common)
    m2, r2, g2, h2 = calibration.calibrate_and_model_dpss(remat=False, **common)
    assert np.allclose(m1.data_array, m2.data_array, atol=1e-6 * RMS(m2.data_array))
    assert np.allclose(
        np.asarray(h1[0][0]["loss"]), np.asarray(h2[0][0]["loss"]), rtol=1e-5
    )
