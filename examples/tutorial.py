#!/usr/bin/env python
"""calamity_tpu tutorial: simulate, corrupt, calibrate, inspect.

Runnable equivalent of the reference's Calamity_Tutorial notebook
(reference examples/Calamity_Tutorial.ipynb): build a 15-antenna Golomb
array observing a point-source foreground sky plus a faint "EoR" noise
floor, corrupt it with random per-antenna gains, then jointly solve for the
gains and a per-baseline DPSS foreground model, and report how well the
residual preserves the EoR-level signal.

Run on CPU:
    python examples/tutorial.py
Run on a GPU machine (default backend):
    python examples/tutorial.py --backend default
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cpu", choices=["cpu", "default"],
                    help="force the CPU backend (default) or use the platform default")
    ap.add_argument("--nants", type=int, default=15)
    ap.add_argument("--nfreqs", type=int, default=200)
    ap.add_argument("--maxsteps", type=int, default=3000)
    ap.add_argument("--eor_dB", type=float, default=-40.0)
    ap.add_argument("--time_parallel", action="store_true",
                    help="batch all (time, pol) fits into one descent")
    args = ap.parse_args()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from calamity_tpu.utils import configure_compile_cache

    configure_compile_cache()

    from calamity_tpu import cal_utils, calibration, simulate

    rng = np.random.default_rng(42)

    # --- simulate: Golomb-ruler array, smooth foregrounds + faint EoR ------
    print("simulating sky...")
    marks = np.array([0, 1, 4, 10, 12, 17, 25, 30, 36, 43, 50, 57, 62, 68, 72][: args.nants])
    antpos = np.zeros((len(marks), 3))
    antpos[:, 0] = marks * 2.0
    freqs = 150e6 + 200e3 * np.arange(args.nfreqs)
    uvd = simulate.make_visdata(antpos, freqs, nsrc=100, seed=1)
    fg_rms = np.sqrt(np.mean(np.abs(uvd.data_array) ** 2))
    eor_amp = fg_rms * 10 ** (args.eor_dB / 20.0)
    eor = eor_amp * (
        rng.standard_normal(uvd.data_array.shape)
        + 1j * rng.standard_normal(uvd.data_array.shape)
    ) / np.sqrt(2)
    uvd.data_array = uvd.data_array + eor

    # --- corrupt with random gains ----------------------------------------
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.05 * rng.standard_normal(truth.gain_array.shape)
        + 0.05j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)

    # --- calibrate + model -------------------------------------------------
    print("calibrating...")
    t0 = time.time()
    model, resid, gains, info = calibration.calibrate_and_model_dpss(
        uvdata=corrupted,
        gains=None,  # start from unity: a true blind self-cal
        min_dly=10.0,
        offset=10.0,
        maxsteps=args.maxsteps,
        tol=1e-12,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        time_parallel=args.time_parallel,
        verbose=False,
    )
    dt = time.time() - t0

    # --- inspect ------------------------------------------------------------
    rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))
    nsteps = len(info[0][0]["loss"])
    print(f"\nfit: {nsteps} steps in {dt:.1f}s "
          f"({1e3 * dt / max(nsteps, 1):.2f} ms/step incl. compile)")
    print(f"data rms      : {rms(corrupted.data_array):.4e}")
    print(f"model rms     : {rms(model.data_array):.4e}")
    print(f"resid rms     : {rms(resid.data_array):.4e}")
    print(f"EoR floor rms : {rms(eor):.4e}")
    print(f"model/resid   : {rms(model.data_array) / rms(resid.data_array):.1f}x")
    ratio = rms(resid.data_array) / rms(eor)
    print(f"resid vs EoR  : {ratio:.2f}x  (≈1 means the EoR window survived calibration)")


if __name__ == "__main__":
    main()
