"""Tests for the AOT segment plan's layout self-heal machinery and the
step-0 loss cross-check guard.

The heal path (parallel.batched.BatchedSegmentPlan._apply_required_layouts)
regex-parses argument names and required layouts out of jax's pre-execution
runtime layout check ValueError — the only authoritative source when
``compiled.input_formats`` misreports an entry layout (observed for bf16
leaves at full-array scale; docs/DESIGN.md "Auto-layout entry plans").
These tests feed CANNED error text so the parse, the entry_formats patch,
the _put_format transfer contract and the heal->retry loop are all covered
on CPU.

The guard (check_initial_loss + batched_initial_losses/host_batched_losses)
is the automatic detector for the scrambled-cube class: a compiled relayout
once corrupted cube contents and a full-scale run started at 28x the
correct chi-square, caught only by a human reading logs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.layout import Format, Layout
from jax.sharding import SingleDeviceSharding

from calamity_tpu import cal_utils, calibration, models
from calamity_tpu.parallel import batched
from calamity_tpu.parallel.batched import (
    BatchedSegmentPlan,
    _put_format,
    batched_initial_losses,
    check_initial_loss,
    host_batched_losses,
    loss_guard_factor,
)
from calamity_tpu.solver.fit import FitConfig
from test_calibration import RMS, project_onto_dpss


# ---------------------------------------------------------------------------
# canned runtime layout-check error text (format of jax pxla.check_array_
# xla_sharding_layout_match — "Argument <name>: Passed/Required layout")
# ---------------------------------------------------------------------------

CANNED_ERR = (
    "Computation was compiled for input layouts that disagree with the "
    "layouts of arguments passed to it. Here are the 2 mismatches:\n"
    "Argument wgts[2] with shape bfloat16[1,2048,1,1536]:\n"
    "  Passed layout: Layout(major_to_minor=(0, 2, 1, 3), tiling=None, "
    "sub_byte_element_size_in_bits=0)\n"
    "  Required layout: Layout(major_to_minor=(2, 1, 0, 3), "
    "tiling=((8, 128), (2, 1)), sub_byte_element_size_in_bits=0)\n"
    "Argument data_r[0] with shape float32[1,4,1,16]:\n"
    "  Passed layout: Layout(major_to_minor=(0, 1, 2, 3), tiling=None, "
    "sub_byte_element_size_in_bits=0)\n"
    "  Required layout: Layout(major_to_minor=(3, 1, 0, 2), tiling=None, "
    "sub_byte_element_size_in_bits=0)\n"
)


class _NoLayout:
    """Stand-in for an input_formats entry with no layout constraint."""

    layout = None


def _bare_plan(n_wgts=3, n_data=1):
    """A BatchedSegmentPlan shell (no compile) with unconstrained formats."""
    plan = BatchedSegmentPlan.__new__(BatchedSegmentPlan)
    fmts = []
    for name in BatchedSegmentPlan._ARG_NAMES:
        if name == "wgts":
            fmts.append(tuple(_NoLayout() for _ in range(n_wgts)))
        elif name in ("data_r", "data_i"):
            fmts.append(tuple(_NoLayout() for _ in range(n_data)))
        else:
            fmts.append(_NoLayout())
    plan.entry_formats = fmts
    return plan


def test_apply_required_layouts_parses_canned_error(monkeypatch):
    """Canned error -> parsed major_to_minor/tiling, patched entry_formats,
    device_put of exactly the named nested leaves."""
    plan = _bare_plan()
    puts = []

    def fake_put(x, fmt):
        puts.append((x, fmt))
        return ("PUT", x)

    monkeypatch.setattr(jax, "device_put", fake_put)
    args = [None] * len(BatchedSegmentPlan._ARG_NAMES)
    wi = BatchedSegmentPlan._ARG_NAMES.index("wgts")
    di = BatchedSegmentPlan._ARG_NAMES.index("data_r")
    args[wi] = ("w0", "w1", "w2")
    args[di] = ("d0",)
    fixed = plan._apply_required_layouts(CANNED_ERR, tuple(args))
    assert fixed is not None
    # the named leaves were device_put into the parsed formats
    assert fixed[wi][2] == ("PUT", "w2")
    assert fixed[wi][0] == "w0" and fixed[wi][1] == "w1"
    assert fixed[di][0] == ("PUT", "d0")
    # entry_formats patched at the same nested indices
    f_w = plan.entry_formats[wi][2]
    assert isinstance(f_w, Format)
    assert f_w.layout.major_to_minor == (2, 1, 0, 3)
    assert f_w.layout.tiling == ((8, 128), (2, 1))
    f_d = plan.entry_formats[di][0]
    assert f_d.layout.major_to_minor == (3, 1, 0, 2)
    assert f_d.layout.tiling is None
    # untouched slots keep their unconstrained formats
    assert isinstance(plan.entry_formats[wi][0], _NoLayout)
    assert len(puts) == 2


def test_apply_required_layouts_unknown_arg_returns_none():
    """An error naming no known argument heals nothing -> None (caller
    re-raises the original error instead of retrying blindly)."""
    plan = _bare_plan()
    err = CANNED_ERR.replace("wgts[2]", "bogus[2]").replace(
        "data_r[0]", "mystery[0]"
    )
    assert plan._apply_required_layouts(err, tuple([None] * 19)) is None


def test_apply_required_layouts_missing_m2m_skipped():
    """A Required layout line without major_to_minor= is skipped, not
    crashed on."""
    plan = _bare_plan()
    err = (
        "Computation was compiled for input layouts that disagree...\n"
        "Argument wgts[1] with shape f32[2,2]:\n"
        "  Passed layout: something\n"
        "  Required layout: AUTO\n"
    )
    assert plan._apply_required_layouts(err, tuple([None] * 19)) is None


def test_put_format_none_and_unconstrained_passthrough():
    x = jnp.ones((2, 3))
    assert _put_format(x, None) is x
    assert _put_format(x, _NoLayout()) is x


def test_put_format_honored_roundtrip():
    """device_put into the array's own (default) format is a no-op pass."""
    x = jnp.ones((2, 3))
    fmt = x.format
    assert fmt is not None
    y = _put_format(x, fmt)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_put_format_unhonored_warns_and_defers(monkeypatch):
    """A transfer that ignores the requested layout WARNS and returns the
    realized array: entry_formats is known to misreport (so the request
    itself may be wrong), device_put is value-exact, and the
    pre-execution runtime layout check + heal loop arbitrate a true
    mismatch (the round-5 scan run died on the old hard error for an f32
    cube whose required layout differed only by a size-1-axis
    permutation + tiling)."""
    x = jnp.ones((2, 3, 4, 5))
    fmt = Format(
        Layout((2, 1, 0, 3), None), SingleDeviceSharding(jax.devices()[0])
    )
    monkeypatch.setattr(jax, "device_put", lambda arr, f: arr)  # ignores f
    with pytest.warns(RuntimeWarning, match="did not honor"):
        y = _put_format(x, fmt)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_run_heals_and_retries(monkeypatch):
    """BatchedSegmentPlan.run: a runtime layout-check ValueError triggers
    the parse->patch->retry loop; donated buffers are intact because the
    check fires pre-execution."""
    plan = _bare_plan()
    calls = []

    class FakeCompiled:
        def __call__(self, *args):
            calls.append(args)
            if len(calls) == 1:
                raise ValueError(CANNED_ERR)
            return "RESULT"

    plan._compiled = FakeCompiled()
    monkeypatch.setattr(jax, "device_put", lambda arr, f: ("HEALED", arr))
    wi = BatchedSegmentPlan._ARG_NAMES.index("wgts")
    di = BatchedSegmentPlan._ARG_NAMES.index("data_r")
    args = [jnp.zeros(()) for _ in range(17)]  # through step0
    args[wi] = ("w0", "w1", "w2")
    args[di] = ("d0",)
    out = plan.run(5, True, tuple(args))
    assert out == "RESULT"
    assert len(calls) == 2
    # the retry saw the healed leaves
    assert calls[1][wi][2] == ("HEALED", "w2")
    assert calls[1][di][0] == ("HEALED", "d0")
    # and the patched formats convert future calls up front: run() maps
    # _put_format over entry_formats, so slot formats must be Formats now
    assert isinstance(plan.entry_formats[wi][2], Format)


def test_run_unrelated_valueerror_passes_through():
    plan = _bare_plan()

    class FakeCompiled:
        def __call__(self, *args):
            raise ValueError("some unrelated failure")

    plan._compiled = FakeCompiled()
    args = [jnp.zeros(()) for _ in range(17)]
    wi = BatchedSegmentPlan._ARG_NAMES.index("wgts")
    di = BatchedSegmentPlan._ARG_NAMES.index("data_r")
    args[wi] = ("w0", "w1", "w2")
    args[di] = ("d0",)
    with pytest.raises(ValueError, match="unrelated"):
        plan.run(5, True, tuple(args))


def test_run_unparseable_layout_error_reraises():
    """A layout-check error the parser cannot heal re-raises the ORIGINAL
    error rather than retrying forever."""
    plan = _bare_plan()
    err = CANNED_ERR.replace("wgts[2]", "bogus[2]").replace(
        "data_r[0]", "mystery[0]"
    )

    class FakeCompiled:
        def __call__(self, *args):
            raise ValueError(err)

    plan._compiled = FakeCompiled()
    args = [jnp.zeros(()) for _ in range(17)]
    wi = BatchedSegmentPlan._ARG_NAMES.index("wgts")
    di = BatchedSegmentPlan._ARG_NAMES.index("data_r")
    args[wi] = ("w0", "w1", "w2")
    args[di] = ("d0",)
    with pytest.raises(ValueError, match="bogus"):
        plan.run(5, True, tuple(args))


def test_run_heal_loop_is_bounded(monkeypatch):
    """An error that keeps naming healable arguments (e.g. a backend whose
    transfers never stick) must not loop forever."""
    plan = _bare_plan()
    calls = []

    class FakeCompiled:
        def __call__(self, *args):
            calls.append(args)
            raise ValueError(CANNED_ERR)

    plan._compiled = FakeCompiled()
    monkeypatch.setattr(jax, "device_put", lambda arr, f: arr)
    args = [jnp.zeros(()) for _ in range(17)]
    wi = BatchedSegmentPlan._ARG_NAMES.index("wgts")
    di = BatchedSegmentPlan._ARG_NAMES.index("data_r")
    args[wi] = ("w0", "w1", "w2")
    args[di] = ("d0",)
    with pytest.raises(ValueError):
        plan.run(5, True, tuple(args))
    assert len(calls) <= 10


# ---------------------------------------------------------------------------
# step-0 loss cross-check guard
# ---------------------------------------------------------------------------


def test_check_initial_loss_ok():
    check_initial_loss(np.array([1.0e-2, 2.0e-2]), np.array([1.1e-2, 1.9e-2]), 4.0)


def test_check_initial_loss_aborts_on_scramble():
    with pytest.raises(RuntimeError, match="step-0 loss cross-check"):
        check_initial_loss(np.array([0.28]), np.array([0.01]), 4.0)


def test_check_initial_loss_floor_tolerates_rounding_noise():
    """A near-perfect warm start sits at rounding noise where one Adam
    warm-up step legitimately raises the loss by orders of magnitude in
    RELATIVE terms — absolute floor keeps the guard quiet there."""
    check_initial_loss(np.array([5.9e-9]), np.array([8.5e-13]), 4.0)


def test_check_initial_loss_skips_zero_expected():
    """Zero-weight dummy batch rows evaluate to exactly 0 both ways."""
    check_initial_loss(np.array([0.0, 0.5]), np.array([0.0, 0.4]), 4.0)


def test_check_initial_loss_warns_below(capsys):
    check_initial_loss(np.array([1.0e-2]), np.array([0.9]), 4.0)
    assert "BELOW" in capsys.readouterr().err


def test_check_initial_loss_env_off(monkeypatch):
    monkeypatch.setenv("CALAMITY_LOSS_GUARD", "off")
    assert loss_guard_factor() is None
    monkeypatch.delenv("CALAMITY_LOSS_GUARD")
    monkeypatch.setenv("CALAMITY_LOSS_GUARD_FACTOR", "7.5")
    assert loss_guard_factor() == 7.5


@pytest.mark.parametrize("regularization", [None, "sum"])
def test_host_losses_match_device(regularization):
    """host_batched_losses (the scan path's guard reference) agrees with
    the jitted device evaluation on dense and shared-batched chunks."""
    rng = np.random.default_rng(7)
    nbatch, nants, nfreqs = 2, 4, 16
    chunks = []
    fg_r, fg_i, data_r, data_i, wgts = [], [], [], [], []
    # chunk 0: dense (ngrps = 3, nbls = 2, nvecs = 5)
    # chunk 1: shared-batched (nu = 2, gmax = 2 -> ngrps = 4, nbls = 1)
    for shape_c, ngrps, nbls in [((3, 2, nfreqs, 5), 3, 2), ((2, 1, nfreqs, 5), 4, 1)]:
        comps = rng.standard_normal(shape_c).astype(np.float32)
        a0 = rng.integers(0, nants, (ngrps, nbls)).astype(np.int32)
        a1 = rng.integers(0, nants, (ngrps, nbls)).astype(np.int32)
        chunks.append((jnp.asarray(comps), jnp.asarray(a0), jnp.asarray(a1)))
        fg_r.append(rng.standard_normal((nbatch, ngrps, 5)).astype(np.float32))
        fg_i.append(rng.standard_normal((nbatch, ngrps, 5)).astype(np.float32))
        data_r.append(rng.standard_normal((nbatch, ngrps, nbls, nfreqs)).astype(np.float32))
        data_i.append(rng.standard_normal((nbatch, ngrps, nbls, nfreqs)).astype(np.float32))
        w = rng.random((nbatch, ngrps, nbls, nfreqs)).astype(np.float32)
        wgts.append(w / w.sum())
    g_r = rng.standard_normal((nbatch, nants, nfreqs)).astype(np.float32)
    g_i = rng.standard_normal((nbatch, nants, nfreqs)).astype(np.float32)
    pr = rng.standard_normal((nbatch,)).astype(np.float32)
    pi = rng.standard_normal((nbatch,)).astype(np.float32)
    cfg = FitConfig(
        optimizer="Adamax", opt_kwargs=(), maxsteps=1, tol=0.0,
        regularization=regularization,
    )
    dev = np.asarray(
        batched_initial_losses(
            cfg, tuple(chunks),
            tuple(jnp.asarray(x) for x in data_r),
            tuple(jnp.asarray(x) for x in data_i),
            tuple(jnp.asarray(x) for x in wgts),
            jnp.asarray(g_r), jnp.asarray(g_i),
            tuple(jnp.asarray(x) for x in fg_r),
            tuple(jnp.asarray(x) for x in fg_i),
            jnp.asarray(pr), jnp.asarray(pi),
        )
    )
    host = host_batched_losses(
        g_r, g_i, fg_r, fg_i,
        [(np.asarray(c), np.asarray(a0), np.asarray(a1)) for c, a0, a1 in chunks],
        data_r, data_i, wgts,
        prior_r=pr, prior_i=pi, regularization=regularization,
    )
    np.testing.assert_allclose(host, dev, rtol=2e-4)


# ---------------------------------------------------------------------------
# end-to-end: a scrambled entry cube aborts the fit at step 0
# ---------------------------------------------------------------------------


@pytest.fixture()
def corrupted_multitime(golomb_visdata):
    """Projected data corrupted by wiggly (non-DPSS-fittable) gains so the
    initial chi-square sits well above the guard's absolute floor."""
    uvd = golomb_visdata.copy()
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=2.0 / 0.3, min_dly=2.0 / 0.3)
    project_onto_dpss(uvd, comps)
    uvd2 = uvd.copy()
    uvd2.time_array = uvd2.time_array + 2.0
    both = uvd + uvd2
    truth = cal_utils.blank_uvcal_from_uvdata(both)
    rng = np.random.default_rng(3)
    truth.gain_array = truth.gain_array * (
        1 + 0.15 * rng.standard_normal(truth.gain_array.shape)
        + 0.15j * rng.standard_normal(truth.gain_array.shape)
    )
    return cal_utils.apply_gains(both, truth, inverse=True)


def _scramble_put_entries(monkeypatch, index_to_scramble):
    orig = BatchedSegmentPlan.put_entries

    def evil(self, index, tree):
        out = orig(self, index, tree)
        if index == index_to_scramble:
            out = tuple(jnp.asarray(np.asarray(x)[..., ::-1].copy()) for x in out)
        return out

    monkeypatch.setattr(BatchedSegmentPlan, "put_entries", evil)


def test_guard_catches_scrambled_cube_time_parallel(monkeypatch, corrupted_multitime):
    """A put_entries that corrupts the data cube (the relayout-scramble
    class) aborts the batched fit at step 0 instead of silently fitting
    corrupted data."""
    _scramble_put_entries(monkeypatch, index_to_scramble=1)
    with pytest.raises(RuntimeError, match="step-0 loss cross-check"):
        calibration.calibrate_and_model_dpss(
            min_dly=2.0 / 0.3,
            offset=2.0 / 0.3,
            uvdata=corrupted_multitime,
            gains=None,
            maxsteps=50,
            tol=0.0,
            time_parallel=True,
            mesh=False,
            comps_precision="float32",
        )


def test_guard_catches_scrambled_cube_scan(monkeypatch, corrupted_multitime):
    """Same detection on the warm-started time scan, whose guard reference
    is computed on the HOST (cubes upload straight into plan layouts).
    The scan defaults to the plain-jit path (nbatch=1 needs no
    auto-layout plan, and nbatch=1 entry relayouts once scrambled a cube);
    CALAMITY_SCAN_PLANS=1 re-enables the guarded plan path under test."""
    monkeypatch.setenv("CALAMITY_SCAN_PLANS", "1")
    _scramble_put_entries(monkeypatch, index_to_scramble=1)
    with pytest.raises(RuntimeError, match="step-0 loss cross-check"):
        calibration.calibrate_and_model_dpss(
            min_dly=2.0 / 0.3,
            offset=2.0 / 0.3,
            uvdata=corrupted_multitime,
            gains=None,
            maxsteps=50,
            tol=0.0,
            time_parallel=True,
            init_guesses_from_previous_time_step=True,
            steps_per_execution=25,
            mesh=False,
            comps_precision="float32",
        )


def test_clean_fit_passes_guard(corrupted_multitime):
    """The guard stays quiet on an honest run of the same configuration."""
    model, resid, gains, hist = calibration.calibrate_and_model_dpss(
        min_dly=2.0 / 0.3,
        offset=2.0 / 0.3,
        uvdata=corrupted_multitime,
        gains=None,
        maxsteps=300,
        tol=0.0,
        time_parallel=True,
        mesh=False,
        comps_precision="float32",
    )
    assert np.all(np.isfinite(model.data_array))
    assert RMS(corrupted_multitime.data_array) > RMS(resid.data_array)
