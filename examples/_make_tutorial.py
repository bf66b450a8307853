"""Build + execute examples/calamity_tpu_tutorial.ipynb.

The notebook mirrors the reference's examples/Calamity_Tutorial.ipynb
deliverable (in-memory API walkthrough with EoR-window / delay-spectrum
figures) on this framework's synthetic fixtures.
"""
import nbformat as nbf

cells = []
md = lambda s: cells.append(nbf.v4.new_markdown_cell(s))
code = lambda s: cells.append(nbf.v4.new_code_cell(s))

md("""# calamity_tpu tutorial — direction-independent calibration without redundancy

This walkthrough mirrors the reference CALAMITY tutorial
(`examples/Calamity_Tutorial.ipynb` upstream): calibrate a simulated
array **in memory** (no files needed), inspect the fitted foreground
model and gains, and verify in delay space that the **EoR window is
preserved** — the point of the method (arXiv:2110.11994).

The sky here is a smooth-spectrum point-source foreground plus a faint
wideband "EoR" signal 40 dB down. A perfect calibration removes the
foregrounds *inside the horizon wedge* while leaving the EoR power at
high delays untouched.""")

code("""import jax
jax.config.update("jax_platforms", "cpu")  # tutorial runs anywhere; drop this line on a GPU host

import numpy as np
import matplotlib.pyplot as plt

from calamity_tpu import calibration, cal_utils, models, simulate""")

md("""## 1. Simulate a 15-antenna Golomb array

`simulate.make_golomb_array` builds a non-redundant east-west array
observing a random point-source sky (smooth spectra, delays confined to
the horizon). We project the foregrounds onto the DPSS basis so a
perfect foreground model exists, then add the faint EoR-like noise that
must survive calibration.""")

code("""nants, nfreqs = 15, 200
uvd_fg = simulate.make_golomb_array(nants=nants, nfreqs=nfreqs, spacing=3.0, seed=7)

# confine the foregrounds exactly to the DPSS modeling space
dpss_vectors = models.yield_pbl_dpss_model_comps(
    uvd_fg, offset=2.0 / 0.3, min_dly=2.0 / 0.3
)
for fit_grp, mat in dpss_vectors.items():
    ap = fit_grp[0][0]
    rows = uvd_fg.antpair2ind(*ap)
    d = uvd_fg.data_array[rows, 0, :, 0]
    uvd_fg.data_array[rows, 0, :, 0] = (mat @ (mat.T @ d.T)).T

# faint wideband EoR: complex gaussian at -40 dB of the foreground rms
rng = np.random.default_rng(11)
fg_rms = np.sqrt(np.mean(np.abs(uvd_fg.data_array) ** 2))
eor = fg_rms * 10 ** (-40 / 20) * (
    rng.standard_normal(uvd_fg.data_array.shape)
    + 1j * rng.standard_normal(uvd_fg.data_array.shape)
) / np.sqrt(2)
uvd = uvd_fg.copy()
uvd.data_array = uvd.data_array + eor
print(f"{uvd.Nbls} baselines, {uvd.Nfreqs} channels, EoR at -40 dB")""")

md("""## 2. Corrupt with unknown per-antenna gains

Each antenna gets a random complex bandpass error; the calibrator must
recover these blindly (no redundancy in a Golomb array!).""")

code("""gains_true = cal_utils.blank_uvcal_from_uvdata(uvd)
gains_true.gain_array = gains_true.gain_array * (
    1.0
    + 0.05 * rng.standard_normal(gains_true.gain_array.shape)
    + 0.05j * rng.standard_normal(gains_true.gain_array.shape)
)
uvd_corrupt = cal_utils.apply_gains(uvd, gains_true, inverse=True)""")

md("""## 3. Calibrate in memory

`calibrate_and_model_dpss` is the same entry point the CLI drives: it
fits per-antenna gains and a per-baseline DPSS foreground model jointly
by gradient descent on the flag-weighted chi-square. Returns
`(model, resid, gains, fit_history)` — all in-memory containers.""")

code("""model, resid, gains_fit, fit_history = calibration.calibrate_and_model_dpss(
    uvdata=uvd_corrupt,
    gains=None,                     # start from unity gains
    min_dly=2.0 / 0.3,
    offset=2.0 / 0.3,
    maxsteps=4000,
    tol=1e-12,
    learning_rate=1e-2,
    correct_resid=True,
    correct_model=True,
    model_regularization="post_hoc",
    verbose=False,
)
losses = np.asarray(fit_history[0][0]["loss"])
rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))
print(f"{len(losses)} steps, loss {losses[0]:.2e} -> {losses[-1]:.2e}")
print(f"resid rms / data rms = {rms(resid.data_array) / rms(uvd.data_array):.2e}")""")

code("""fig, ax = plt.subplots(figsize=(6, 3.2))
ax.semilogy(losses, color="#2a6fdb", lw=1.2)
ax.set_xlabel("gradient step")
ax.set_ylabel(r"$\\chi^2$ loss")
ax.set_title("descent history")
ax.grid(alpha=0.3)
plt.tight_layout()""")

md("""## 4. Did we recover the gains?

The fitted gains match the true corruption up to the overall
amplitude/phase degeneracies the method cannot constrain (fixed post hoc
to the data scale).""")

code("""fig, axes = plt.subplots(1, 2, figsize=(10, 3.4), sharex=True)
freqs_mhz = uvd.freq_array[0] / 1e6
for i, ant in enumerate(gains_fit.ant_array):
    gt = gains_true.get_gains(ant, "xx")[:, 0]
    gf = gains_fit.get_gains(ant, "xx")[:, 0]
    axes[0].plot(freqs_mhz, np.abs(gt), color="k", alpha=0.35, lw=0.8)
    axes[0].plot(freqs_mhz, np.abs(gf), color="#d1495b", alpha=0.5, lw=0.8, ls="--")
    axes[1].plot(freqs_mhz, np.angle(gt * np.conj(gf)), color="#2a6fdb", alpha=0.4, lw=0.8)
axes[0].set_title("|g| true (solid) vs fitted (dashed)")
axes[0].set_xlabel("frequency [MHz]"); axes[0].set_ylabel("|g|")
axes[1].set_title("phase(true / fitted) per antenna")
axes[1].set_xlabel("frequency [MHz]"); axes[1].set_ylabel("radians")
for a in axes: a.grid(alpha=0.3)
plt.tight_layout()""")

md("""## 5. The EoR window in delay space

The science check. For each baseline we Fourier transform the spectra
(Blackman-Harris taper) into delay space:

- the **corrupted data** is foreground-dominated at all delays (gain
  errors scatter foreground power out of the wedge),
- the **calibrated residual** (data − gains·model) drops to the EoR
  floor *outside the horizon* (dashed lines) while the foregrounds are
  absorbed into the model,
- the **injected EoR** level is preserved — not absorbed by the fit.""")

code("""def delay_spectrum(wf, df):
    taper = np.blackman(wf.shape[-1])
    ft = np.fft.fftshift(np.fft.fft(wf * taper, axis=-1), axes=-1)
    delays = np.fft.fftshift(np.fft.fftfreq(wf.shape[-1], df))
    return delays * 1e9, np.abs(ft) ** 2  # ns, power

df = uvd.freq_array[0, 1] - uvd.freq_array[0, 0]
aps = uvd.get_antpairs()
bl_lens = {ap: np.linalg.norm(uvd.uvw_array[uvd.antpair2ind(*ap)[0]]) for ap in aps}
longest = sorted(aps, key=lambda ap: bl_lens[ap])[-1]

fig, ax = plt.subplots(figsize=(7.5, 4.2))
for label, obj, color in [
    ("corrupted data", uvd_corrupt, "#999999"),
    ("calibrated residual", resid, "#d1495b"),
    ("injected EoR", None, "#2a6fdb"),
]:
    if obj is None:
        rows = uvd.antpair2ind(*longest)
        wf = eor[rows, 0, :, 0]
    else:
        wf = obj.get_data(longest + ("xx",))
    delays, p = delay_spectrum(wf, df)
    ax.semilogy(delays, p.mean(axis=0), color=color, lw=1.3, label=label)

horizon_ns = bl_lens[longest] / 0.3  # |b|/c in ns
for s in (-1, 1):
    ax.axvline(s * horizon_ns, color="k", ls="--", lw=0.8)
ax.set_xlabel("delay [ns]")
ax.set_ylabel("|V(tau)|^2")
ax.set_title(f"delay spectrum, longest baseline {longest} "
             f"(horizon ±{horizon_ns:.0f} ns)")
ax.legend(loc="upper right")
ax.grid(alpha=0.3)
plt.tight_layout()""")

code("""rows = uvd.antpair2ind(*longest)
_, p_resid = delay_spectrum(resid.get_data(longest + ("xx",)), df)
delays, p_eor = delay_spectrum(eor[rows, 0, :, 0], df)
outside = np.abs(delays) > 1.5 * horizon_ns
ratio = p_resid.mean(axis=0)[outside].mean() / p_eor.mean(axis=0)[outside].mean()
print(f"residual / injected-EoR power outside the wedge: {ratio:.2f}x")
assert ratio < 3.0, "EoR window not preserved!"
print("EoR window preserved.")""")

md("""## 6. Faster descents: bfloat16 basis storage

At scale the descent step is bound by streaming the DPSS basis tensors
from device memory. The DEFAULT `comps_precision="mixed"` schedule runs the bulk of
the descent against a bfloat16 copy of the basis (half the basis bytes at
array scale) and then polishes in float32 — carrying the optimizer state
across the switch — so the final residual floor is identical to a
pure-float32 fit. Here we spell the flag out explicitly (it is what you
get by default on 32-bit fits); pass `comps_precision="float32"` to opt
out. See `docs/BF16_COMPS.md`.""")

code("""model_m, resid_m, gains_m, hist_m = calibration.calibrate_and_model_dpss(
    uvdata=uvd_corrupt,
    gains=None,
    min_dly=2.0 / 0.3,
    offset=2.0 / 0.3,
    maxsteps=4000,
    tol=1e-12,
    learning_rate=1e-2,
    correct_resid=True,
    correct_model=True,
    model_regularization="post_hoc",
    comps_precision="mixed",
)
n_bf16, n_f32 = hist_m[0][0]["phase_steps"]
print(f"bf16 phase: {n_bf16} steps, float32 polish: {n_f32} steps")
print(f"resid rms / data rms = {rms(resid_m.data_array) / rms(uvd.data_array):.2e} "
      f"(float32 fit above: {rms(resid.data_array) / rms(uvd.data_array):.2e})")""")

md("""## 7. Where to go from here

- **Files instead of memory**: `calibration.read_calibrate_and_model_dpss`
  reads `uvh5`, writes `uvh5` residual/model and `calfits` gains — same
  knobs as this API, shell-ready via `scripts/calibrate_and_model_dpss.py`.
- **Scale**: `time_parallel=True` batches every (time, pol) fit into one
  compiled descent; pass `mesh=calamity_tpu.parallel.make_mesh()` to
  shard over every GPU of the host. See `examples/hera_full_demo.py` for the
  331-antenna / 54,615-baseline configuration.
- **Other bases**: `calibrate_and_model_mixed` (multi-baseline
  covariance eigenmodes for redundant arrays), DFT basis via
  `calibrate_and_model_dft`.""")

nb = nbf.v4.new_notebook(cells=cells, metadata={
    "kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
    "language_info": {"name": "python"},
})

import sys
out = sys.argv[1] if len(sys.argv) > 1 else "examples/calamity_tpu_tutorial.ipynb"
with open(out, "w") as f:
    nbf.write(nb, f)
print("wrote", out)
