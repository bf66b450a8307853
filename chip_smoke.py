#!/usr/bin/env python
"""Smoke test of calamity_tpu on NVIDIA GPUs: the quickest proof that the
system still starts, computes correctly and runs at full width on the card.

    python chip_smoke.py          # one GPU: phases (a)-(d)
    python chip_smoke.py --four   # four GPUs: the mesh fit of phase (e) only

Phases, all in this one process (a JAX process reserves most of the card):

(a) device: a GPU must be JAX's platform (no CPU fallback); prints the card's
    name and power limit from nvidia-smi and the compile-cache directory.
(b) main path: ``calibration.calibrate_and_model_dpss`` with
    ``time_parallel=True`` on the HERA-core array (361 antennas, ~4.4k
    baselines <= 45 m, 1536 channels, 4 times), sky projected onto the DPSS
    basis, gains corrupted, fit blind with the default "mixed" comps
    precision. Checks finite outputs, a falling loss, foreground suppression
    rms(model)/rms(resid) >= 100, and the gains against the truth.
(c) dense non-redundant hot step at benchmark widths (2048 baselines x 1536
    channels x 128 modes): ``chunked_loss`` and its gradient against the
    float64 numpy reference ``ops.loss.chi_square_host``, for float32 and
    bfloat16 basis storage.
(d) plain XLA loss + gradient + Adamax step at the shapes of (c): ms/step,
    the bytes it must move and the share of the card's HBM bandwidth.
(e) ``--four``: the fit of (b) over 8 times on a mesh across 4 GPUs against
    the same fit on one GPU.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; a failed check
raises, so the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# (b): the reference's documented target class, 350 antennas x 1536 channels
CORE = dict(nside=19, nfreqs=1536, ntimes=4)
# step budget per precision phase of the mixed schedule (demo settings:
# examples/hera_core_demo.py)
FIT = dict(maxsteps=3000, patience=500, tol=1e-11)
SUPPRESSION_MIN = 100.0
# rms over antennas/channels of |g_fit - c g_true| / |c g_true|, after
# removing the per-(time, channel) complex factor c that the data cannot
# fix (global phase; post-hoc amplitude renormalization). The truth carries
# 3% random gain errors, so 1% means two thirds of them were recovered; the
# floor is the part of the truth inside the smooth DPSS span, which the
# per-baseline foreground model absorbs.
GAIN_TOL = 1e-2

# (c)/(d): benchmark widths of the dense non-redundant chunk
DENSE = dict(ngrps=2048, nbls=1, nfreqs=1536, nvecs=128, nants=352)
LOSS_RTOL_F32 = 1e-5
GRAD_RTOL_F32 = 1e-4
# bfloat16 basis storage: relative floor against the unquantized basis
# (docs/BF16_COMPS.md)
BF16_FLOOR = 4e-3

# published peak HBM bandwidth per device_kind (NVIDIA H100 SXM data sheet);
# a device missing here is an error, not a default
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------- #
# (a) device
# --------------------------------------------------------------------- #
def require_gpu(devices, count=None):
    """The device phase: fail unless every device is a GPU (and, with
    ``count``, exactly that many are visible)."""
    check(len(devices) > 0, "JAX found no device")
    platforms = sorted({d.platform for d in devices})
    check(platforms == ["gpu"], f"JAX platform is {platforms}, not ['gpu']")
    if count is not None:
        check(len(devices) == count,
              f"need {count} GPUs, JAX sees {len(devices)}")
    return devices[0]


def card_info():
    """Name and power limit of each card, read by nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


# --------------------------------------------------------------------- #
# (b) main path
# --------------------------------------------------------------------- #
def corrupt_gains(uvd, seed=11, amp=0.03):
    """Per-antenna, per-channel, per-time complex gains 1 + amp * N(0, 1)
    (real and imaginary), applied to ``uvd``; returns (corrupted, truth)."""
    from calamity_tpu import cal_utils

    rng = np.random.default_rng(seed)
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    shape = truth.gain_array.shape
    truth.gain_array = 1.0 + amp * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    )
    return cal_utils.apply_gains(uvd, truth, inverse=True), truth


def gain_error(fit, truth):
    """Per-time relative gain error after removing the per-(time, channel)
    complex factor the data cannot determine. Arrays are CalData
    gain_arrays (nants, 1, nfreqs, ntimes, njones)."""
    f = np.asarray(fit)[:, 0]
    t = np.asarray(truth)[:, 0]
    c = np.sum(f * np.conj(t), axis=0) / np.sum(np.abs(t) ** 2, axis=0)
    err = np.abs(f - c * t) ** 2
    ref = np.abs(c * t) ** 2
    return np.sqrt(np.sum(err, axis=(0, 1)) / np.sum(ref, axis=(0, 1))).ravel()


def rms(x):
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def run_core_fit(uvd, comps, mesh=None, timings=None, **fit):
    from calamity_tpu import calibration

    return calibration.calibrate_and_model_dpss(
        uvdata=uvd,
        fg_model_comps_dict=comps,
        time_parallel=True,
        mesh=mesh,
        use_min=fit.get("patience", 0) > 0,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        nvec_bucketing=True,
        timings=timings,
        **fit,
    )


def main_path(nside, nfreqs, ntimes, maxsteps, patience, tol,
              suppression_min=SUPPRESSION_MIN, gain_tol=GAIN_TOL):
    """Phase (b). Returns a dict of what it measured; raises SmokeFailure
    when a check fails."""
    import jax

    from calamity_tpu import simulate

    t0 = time.time()
    uvd, comps = simulate.make_hera_core(nside=nside, nfreqs=nfreqs, ntimes=ntimes)
    corrupted, truth = corrupt_gains(uvd)
    log(f"(b) HERA core: {uvd.Nants_data} antennas, {uvd.Nbls} baselines, "
        f"{uvd.Nfreqs} channels, {uvd.Ntimes} times "
        f"(simulated in {time.time() - t0:.1f} s)")
    timings = {}
    t0 = time.time()
    model, resid, gains, info = run_core_fit(
        corrupted, comps, timings=timings,
        maxsteps=maxsteps, patience=patience, tol=tol,
    )
    wall = time.time() - t0
    losses = [info[0][t]["loss"] for t in sorted(info[0])]
    mem = timings.pop("descent_memory", None)
    log(f"(b) fit wall {wall:.2f} s; timings= "
        + ", ".join(f"{k}={v:.3f}" for k, v in sorted(timings.items())))
    for phase, m in enumerate(mem or ()):
        log(f"(b) descent {phase} memory_analysis: " + ", ".join(
            f"{k}={getattr(m, k + '_in_bytes') / 2**30:.4f} GiB"
            for k in ("argument_size", "output_size", "temp_size",
                      "alias_size", "peak_memory")))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"(b) device peak_bytes_in_use: "
        f"{'not available' if peak is None else f'{peak / 2**30:.3f} GiB'}")

    check(np.isfinite(model.data_array).all(), "model has non-finite values")
    check(np.isfinite(resid.data_array).all(), "residual has non-finite values")
    check(np.isfinite(gains.gain_array).all(), "gains have non-finite values")
    for t, h in enumerate(losses):
        check(len(h) > 1 and np.isfinite(h).all(), f"time {t}: bad loss history")
        check(min(h) < h[0], f"time {t}: loss did not fall ({h[0]:.3e} -> {min(h):.3e})")
    suppression = rms(model.data_array) / rms(resid.data_array)
    gerr = gain_error(gains.gain_array, truth.gain_array)
    log(f"(b) steps per time: {[len(h) for h in losses]}; loss "
        f"{[f'{h[0]:.3e}->{min(h):.3e}' for h in losses]}")
    log(f"(b) suppression rms(model)/rms(resid) = {suppression:.1f} "
        f"(need >= {suppression_min:g}); gain error per time "
        f"{np.array2string(gerr, precision=5)} (need <= {gain_tol:g})")
    check(suppression >= suppression_min,
          f"suppression {suppression:.1f} < {suppression_min:g}")
    check(np.all(gerr <= gain_tol), f"gain error {gerr.max():.3e} > {gain_tol:g}")
    return dict(suppression=suppression, gain_error=gerr, wall_s=wall,
                timings=timings, peak_bytes=peak, nsteps=[len(h) for h in losses])


# --------------------------------------------------------------------- #
# (c) dense hot step against the float64 reference
# --------------------------------------------------------------------- #
def dense_inputs(ngrps, nbls, nfreqs, nvecs, nants, seed=0):
    """Host float32 inputs of one dense chunk (orthonormal-scale basis,
    gains near unity, unit-sum weights)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return (scale * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)

    comps = normal((ngrps, nbls, nfreqs, nvecs), 1.0 / np.sqrt(nfreqs))
    a0 = rng.integers(0, nants, size=(ngrps, nbls), dtype=np.int32)
    a1 = (a0 + 1 + rng.integers(0, nants - 1, size=(ngrps, nbls), dtype=np.int32)) % nants
    g_r = 1.0 + normal((nants, nfreqs), 0.03)
    g_i = normal((nants, nfreqs), 0.03)
    fg_r = normal((ngrps, nvecs))
    fg_i = normal((ngrps, nvecs))
    data_r = normal((ngrps, nbls, nfreqs))
    data_i = normal((ngrps, nbls, nfreqs))
    wgts = np.abs(normal((ngrps, nbls, nfreqs)))
    wgts /= wgts.sum(dtype=np.float64)
    return dict(comps=comps, a0=a0, a1=a1, g_r=g_r, g_i=g_i, fg_r=fg_r,
                fg_i=fg_i, data_r=data_r, data_i=data_i, wgts=wgts)


def _flat(grads):
    g_r, g_i, fg_r, fg_i = grads
    parts = [g_r, g_i] + list(fg_r) + list(fg_i)
    return np.concatenate([np.asarray(p, dtype=np.float64).ravel() for p in parts])


def loss_and_grad_device(inp, comps_dtype):
    """chunked_loss and its gradient on the default device."""
    import jax
    import jax.numpy as jnp

    from calamity_tpu.ops.loss import chunked_loss

    comps = jnp.asarray(inp["comps"]).astype(comps_dtype)
    dev = {k: jnp.asarray(v) for k, v in inp.items() if k != "comps"}

    @jax.jit
    def vg(params, comps, a0, a1, dr, di, w):
        def f(p):
            return chunked_loss(p[0], p[1], (p[2],), (p[3],), ((comps, a0, a1),),
                                (dr,), (di,), (w,))
        return jax.value_and_grad(f)(params)

    loss, grads = vg(
        (dev["g_r"], dev["g_i"], dev["fg_r"], dev["fg_i"]), comps,
        dev["a0"], dev["a1"], dev["data_r"], dev["data_i"], dev["wgts"],
    )
    g_r, g_i, fg_r, fg_i = grads
    return float(loss), (g_r, g_i, [fg_r], [fg_i]), comps


def compare_to_reference(inp, comps_dtype):
    """(rel. loss error, rel. gradient error) of the device step against
    the float64 reference evaluated on the basis as stored, plus the same
    pair against the reference on the unquantized float32 basis."""
    from calamity_tpu.ops.loss import chi_square_host

    loss, grads, comps_dev = loss_and_grad_device(inp, comps_dtype)
    g = _flat(grads)
    out = []
    for comps in (comps_dev, inp["comps"]):
        ref_loss, ref_grads = chi_square_host(
            inp["g_r"], inp["g_i"], [inp["fg_r"]], [inp["fg_i"]],
            ((comps, inp["a0"], inp["a1"]),),
            [inp["data_r"]], [inp["data_i"]], [inp["wgts"]],
        )
        gr = _flat(ref_grads)
        out.append((abs(loss - ref_loss) / abs(ref_loss),
                    float(np.linalg.norm(g - gr) / np.linalg.norm(gr))))
    return out


def dense_step_check(shapes):
    """Phase (c)."""
    import jax.numpy as jnp

    inp = dense_inputs(**shapes)
    (le, ge), _ = compare_to_reference(inp, jnp.float32)
    log(f"(c) float32 comps: loss rel err {le:.3e} (<= {LOSS_RTOL_F32:g}), "
        f"grad rel err {ge:.3e} (<= {GRAD_RTOL_F32:g})")
    check(le <= LOSS_RTOL_F32 and ge <= GRAD_RTOL_F32,
          "float32 loss/gradient off the float64 reference: a contraction "
          "lost its Precision.HIGHEST pin")
    (le_q, ge_q), (le_b, ge_b) = compare_to_reference(inp, jnp.bfloat16)
    log(f"(c) bfloat16 comps: vs reference on the stored basis loss {le_q:.3e} "
        f"grad {ge_q:.3e}; vs unquantized basis loss {le_b:.3e} grad {ge_b:.3e} "
        f"(floor {BF16_FLOOR:g})")
    check(le_q <= LOSS_RTOL_F32 and ge_q <= GRAD_RTOL_F32,
          "bfloat16-comps arithmetic off the float64 reference")
    check(le_b <= BF16_FLOOR and ge_b <= BF16_FLOOR,
          "bfloat16-comps error above the documented floor")
    return dict(f32=(le, ge), bf16_stored=(le_q, ge_q), bf16_vs_f32=(le_b, ge_b))


# --------------------------------------------------------------------- #
# (d) plain XLA step time against the HBM roofline
# --------------------------------------------------------------------- #
def step_bytes(ngrps, nbls, nfreqs, nvecs, comps_itemsize):
    """Least bytes one loss+grad step must move: the basis read twice
    (forward and transpose) and, once each, the data, weight and foreground
    model cubes (vr, vi)."""
    cube = ngrps * nbls * nfreqs * 4
    return 2 * ngrps * nbls * nfreqs * nvecs * comps_itemsize + 5 * cube


def time_adamax_step(inp, comps_dtype, n_short=10, n_long=110, lr=1e-2):
    """ms per plain-XLA loss+grad+Adamax step: one jitted loop with a traced
    trip count, warmed at both lengths, timed as the difference of the two
    (cancels dispatch and the final fetch)."""
    import jax
    import jax.numpy as jnp
    import optax

    from calamity_tpu.ops.loss import chunked_loss

    comps = jnp.asarray(inp["comps"]).astype(comps_dtype)
    dev = {k: jnp.asarray(v) for k, v in inp.items() if k != "comps"}
    opt = optax.adamax(lr)

    @jax.jit
    def run(params, opt_state, n, comps, a0, a1, dr, di, w):
        def loss_fn(p):
            return chunked_loss(p[0], p[1], (p[2],), (p[3],), ((comps, a0, a1),),
                                (dr,), (di,), (w,))

        def body(_, carry):
            p, s, _ = carry
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, s = opt.update(grads, s, p)
            return optax.apply_updates(p, updates), s, loss

        return jax.lax.fori_loop(0, n, body, (params, opt_state, jnp.float32(0)))

    params = (dev["g_r"], dev["g_i"], dev["fg_r"], dev["fg_i"])
    state = opt.init(params)
    big = (comps, dev["a0"], dev["a1"], dev["data_r"], dev["data_i"], dev["wgts"])

    def timed(n):
        t0 = time.perf_counter()
        out = run(params, state, jnp.int32(n), *big)
        jax.block_until_ready(out)
        return time.perf_counter() - t0, float(out[2])

    timed(n_short)  # compile (the trip count is traced: one program)
    timed(n_long)
    t_short = min(timed(n_short)[0] for _ in range(3))
    t_long, loss = min(timed(n_long) for _ in range(3))
    check(np.isfinite(loss), "non-finite loss in the timed step")
    return (t_long - t_short) / (n_long - n_short) * 1e3


def roofline(shapes, kind, power):
    """Phase (d)."""
    import jax.numpy as jnp

    check(kind in HBM_BYTES_PER_S, f"no published HBM bandwidth for {kind!r}")
    peak = HBM_BYTES_PER_S[kind]
    inp = dense_inputs(**shapes)
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        ms = time_adamax_step(inp, dt)
        nbytes = step_bytes(shapes["ngrps"], shapes["nbls"], shapes["nfreqs"],
                            shapes["nvecs"], jnp.dtype(dt).itemsize)
        rate = nbytes / (ms * 1e-3)
        log(f"(d) {name} comps: {ms:.4f} ms/step, >= {nbytes / 1e9:.4f} GB/step, "
            f"{rate / 1e9:.1f} GB/s = {rate / peak:.3f} of {peak / 1e12:.2f} TB/s "
            f"({kind}, power limit {power})")
        out[name] = dict(ms=ms, bytes=nbytes, share=rate / peak)
    return out


# --------------------------------------------------------------------- #
# (e) four-card mesh against one card
# --------------------------------------------------------------------- #
FOUR = dict(nside=19, nfreqs=1536, ntimes=8)
# fixed step count (no tol or patience stop) so both fits take the same
# steps and differ only in reduction order
FOUR_FIT = dict(maxsteps=300, patience=0, tol=0.0)
FOUR_LOSS_RTOL = 1e-4
FOUR_GAIN_RTOL = 1e-3
# device 0's peak against the median of the others: a cube placed on device
# 0 alone instead of sharded would show as a multiple
FOUR_PEAK_RATIO = 1.5


def mesh_vs_single(nside, nfreqs, ntimes, maxsteps, patience, tol,
                   loss_rtol=FOUR_LOSS_RTOL, gain_rtol=FOUR_GAIN_RTOL,
                   peak_ratio=FOUR_PEAK_RATIO):
    """Phase (e): the same fit with the default mesh over every device and
    with ``mesh=False`` on one device."""
    import jax

    from calamity_tpu import simulate

    devices = jax.devices()
    uvd, comps = simulate.make_hera_core(nside=nside, nfreqs=nfreqs, ntimes=ntimes)
    corrupted, _ = corrupt_gains(uvd)
    fit = dict(maxsteps=maxsteps, patience=patience, tol=tol)
    t0 = time.time()
    _, _, g_mesh, info_mesh = run_core_fit(corrupted, comps, mesh=None, **fit)
    t_mesh = time.time() - t0
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices]
    t0 = time.time()
    _, _, g_one, info_one = run_core_fit(corrupted, comps, mesh=False, **fit)
    t_one = time.time() - t0
    final_mesh = np.array([info_mesh[0][t]["loss"][-1] for t in sorted(info_mesh[0])])
    final_one = np.array([info_one[0][t]["loss"][-1] for t in sorted(info_one[0])])
    loss_err = np.abs(final_mesh - final_one) / np.abs(final_one)
    gain_err = float(np.max(np.abs(g_mesh.gain_array - g_one.gain_array)
                            / np.abs(g_one.gain_array)))
    log(f"(e) {len(devices)}-device mesh fit {t_mesh:.2f} s, one-device fit "
        f"{t_one:.2f} s ({uvd.Ntimes} times, {maxsteps} steps per phase)")
    log(f"(e) per-slice final loss mesh {np.array2string(final_mesh, precision=6)} "
        f"one {np.array2string(final_one, precision=6)}; max rel diff "
        f"{loss_err.max():.3e} (<= {loss_rtol:g}); gains max rel diff "
        f"{gain_err:.3e} (<= {gain_rtol:g})")
    log("(e) peak_bytes_in_use per device after the mesh fit: "
        + ", ".join("n/a" if p is None else f"{p / 2**30:.3f} GiB" for p in peaks))
    check(np.isfinite(final_mesh).all() and np.isfinite(final_one).all(),
          "non-finite final loss")
    check(loss_err.max() <= loss_rtol, "mesh and one-device losses differ")
    check(gain_err <= gain_rtol, "mesh and one-device gains differ")
    if len(devices) > 1 and all(p is not None for p in peaks):
        ratio = peaks[0] / float(np.median(peaks[1:]))
        log(f"(e) device 0 peak / median of the others = {ratio:.3f} "
            f"(<= {peak_ratio:g})")
        check(ratio <= peak_ratio, "device 0 holds more than its shard")
    return dict(loss_err=loss_err, gain_err=gain_err, peaks=peaks,
                t_mesh=t_mesh, t_one=t_one)


# --------------------------------------------------------------------- #
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh fit against one GPU")
    args = ap.parse_args(argv)

    import calamity_tpu

    check(Path(calamity_tpu.__file__).resolve().parent.parent == HERE,
          f"calamity_tpu imported from {calamity_tpu.__file__}, not this checkout")
    import jax

    from calamity_tpu.utils import configure_compile_cache

    dev = require_gpu(jax.devices(), count=4 if args.four else None)
    cards = card_info()
    for line in cards:
        log(line)
    power = cards[0].split(",")[-1].strip() if cards else "unknown"
    log(f"(a) JAX {jax.__version__}: {len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform}); compile cache {configure_compile_cache()}")

    if args.four:
        mesh_vs_single(**FOUR, **FOUR_FIT)
    else:
        main_path(**CORE, **FIT)
        dense_step_check(DENSE)
        roofline(DENSE, dev.device_kind, power)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
