#!/usr/bin/env python
"""Array-scale calibration demo: wall-clock to chi-square convergence.

The headline metric (BASELINE.md): wall-clock to convergence of a full-array,
full-band joint gain + foreground fit. This script builds an N-antenna
pseudo-random 2-D array observing a point-source sky at 1536 channels
(HERA bandwidth), corrupts it with per-antenna gains, and runs the blind
self-cal on the default backend (GPU when present), reporting stage timings
and convergence quality.

    python examples/scale_demo.py --nants 48          # ~1128 baselines
    python examples/scale_demo.py --nants 48 --backend cpu
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nants", type=int, default=48)
    ap.add_argument("--nfreqs", type=int, default=1536)
    ap.add_argument("--nsrc", type=int, default=100)
    ap.add_argument("--maxsteps", type=int, default=5000)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--patience", type=int, default=500,
                    help="stop when the loss has not improved for this many "
                         "steps and return the tracked argmin (use_min); the "
                         "measured-best stopping config for long blind-cal "
                         "fits (docs/DESIGN.md 'Patience stopping'); 0 "
                         "restores reference semantics")
    ap.add_argument("--backend", default="default", choices=["cpu", "default"])
    ap.add_argument("--comps_precision", default=None,
                    choices=["float32", "bfloat16", "mixed"],
                    help="basis storage precision for the descent "
                         "(docs/BF16_COMPS.md)")
    ap.add_argument("--repeat_fit", action="store_true",
                    help="run the fit twice; the second run reuses the compiled "
                         "program, isolating steady-state step time")
    ap.add_argument("--cache", default=None,
                    help="npz path to cache the simulated data + projection")
    args = ap.parse_args()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from calamity_tpu.utils import configure_compile_cache

    configure_compile_cache()

    from calamity_tpu import cal_utils, calibration, models, simulate
    from tests.test_calibration import project_onto_dpss

    rng = np.random.default_rng(7)

    def stage(label):
        print(f"[{time.strftime('%H:%M:%S')}] {label}", file=sys.stderr, flush=True)

    # --- array + sky ------------------------------------------------------
    import os

    cached = args.cache and os.path.exists(args.cache)
    stage(f"simulating {args.nants}-antenna array, {args.nfreqs} channels"
          + (" [cached]" if cached else ""))
    t0 = time.time()
    antpos = np.zeros((args.nants, 3))
    antpos[:, 0] = rng.uniform(0, 300, args.nants)
    antpos[:, 1] = rng.uniform(0, 300, args.nants)
    freqs = 100e6 + 100e3 * np.arange(args.nfreqs)
    uvd = simulate.make_visdata(antpos, freqs, nsrc=(1 if cached else args.nsrc), seed=1)
    t_sim = time.time() - t0

    # --- basis + projection (perfect-fit ground truth) ---------------------
    stage("generating DPSS operators (one per unique baseline length)")
    t0 = time.time()
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=10.0, offset=10.0)
    t_basis = time.time() - t0
    nvecs = [m.shape[1] for m in comps.values()]
    stage(f"  {len(comps)} groups, modes per baseline: "
          f"min {min(nvecs)} / median {int(np.median(nvecs))} / max {max(nvecs)}")
    t0 = time.time()
    if cached:
        uvd.data_array = np.load(args.cache)["data"]
    else:
        stage("projecting data onto the basis")
        project_onto_dpss(uvd, comps)
        if args.cache:
            np.savez_compressed(args.cache, data=uvd.data_array)
    t_proj = time.time() - t0

    # --- corrupt ------------------------------------------------------------
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)

    # --- fit ----------------------------------------------------------------
    stage(f"fitting on backend={jax.default_backend()} "
          f"(maxsteps={args.maxsteps}, tol={args.tol})")
    t0 = time.time()
    model, resid, gains, info = calibration.calibrate_and_model_dpss(
        uvdata=corrupted,
        gains=None,
        fg_model_comps_dict=comps,
        maxsteps=args.maxsteps,
        comps_precision=args.comps_precision,
        tol=args.tol,
        patience=args.patience,
        use_min=args.patience > 0,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        nvec_bucketing=True,
    )
    t_fit = time.time() - t0
    t_fit2 = None
    if args.repeat_fit:
        stage("repeating fit (compiled program cached)")
        t0 = time.time()
        model, resid, gains, info = calibration.calibrate_and_model_dpss(
            uvdata=corrupted,
            gains=None,
            fg_model_comps_dict=comps,
            maxsteps=args.maxsteps,
            tol=args.tol,
            patience=args.patience,
            use_min=args.patience > 0,
            learning_rate=1e-2,
            correct_resid=True,
            correct_model=True,
            model_regularization="post_hoc",
            nvec_bucketing=True,
        )
        t_fit2 = time.time() - t0

    rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))
    nsteps = len(info[0][0]["loss"])
    nbl = corrupted.Nbls
    print(f"\n=== scale demo: {args.nants} ants / {nbl} baselines / "
          f"{args.nfreqs} channels ===")
    print(f"simulate  : {t_sim:8.1f}s")
    print(f"basis     : {t_basis:8.1f}s  ({len(comps)} DPSS operators)")
    print(f"project   : {t_proj:8.1f}s")
    print(f"fit       : {t_fit:8.1f}s  ({nsteps} steps, "
          f"{1e3 * t_fit / max(nsteps, 1):.2f} ms/step incl. compile+packing)")
    if t_fit2 is not None:
        print(f"fit(warm) : {t_fit2:8.1f}s  "
              f"({1e3 * t_fit2 / max(nsteps, 1):.2f} ms/step steady state)")
    print(f"loss      : {info[0][0]['loss'][0]:.3e} -> {info[0][0]['loss'][-1]:.3e}")
    print(f"model/resid: {rms(model.data_array) / rms(resid.data_array):.1f}x")
    print(f"data/resid : {rms(corrupted.data_array) / rms(resid.data_array):.1f}x")


if __name__ == "__main__":
    main()
