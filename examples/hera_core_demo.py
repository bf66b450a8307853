#!/usr/bin/env python
"""HERA-core-scale demo: 361 antennas, full band, one chip.

The BASELINE north star targets a 350-antenna x 1536-channel fit. HERA is a
maximally-redundant array, which is exactly what the shared-basis packing
exploits: a compact redundant core has few unique baseline vectors, so the
basis operators and the foreground components are stored once per unique
spacing and the per-step HBM traffic is dominated by the data, not the
(shared) components.

This demo builds a 19x19 grid core (361 antennas, 14.6 m spacing — HERA's
dish pitch), keeps baselines up to ``--bllen_max`` (the calibration-relevant
short spacings; the same cut the reference CLI exposes as --bllen_max),
simulates a point-source sky per unique spacing (simulate.make_hera_core),
corrupts with per-antenna gains, and runs the blind self-cal on the default
backend (time_parallel when ``--ntimes`` > 1).

    python examples/hera_core_demo.py                 # GPU if present
    python examples/hera_core_demo.py --backend cpu --nside 8 --nfreqs 256
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=19, help="grid side (nants = nside^2)")
    ap.add_argument("--spacing", type=float, default=14.6)
    ap.add_argument("--bllen_max", type=float, default=45.0)
    ap.add_argument("--nfreqs", type=int, default=1536)
    ap.add_argument("--nsrc", type=int, default=50)
    ap.add_argument("--ntimes", type=int, default=1)
    ap.add_argument("--maxsteps", type=int, default=3000)
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
    args = ap.parse_args()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from calamity_tpu import cal_utils, calibration, simulate
    from calamity_tpu.utils import configure_compile_cache

    configure_compile_cache()
    rng = np.random.default_rng(11)

    def stage(label):
        print(f"[{time.strftime('%H:%M:%S')}] {label}", file=sys.stderr, flush=True)

    # --- grid core, short-baseline cut; sky per unique spacing projected
    # onto its DPSS operator (simulate.make_hera_core) --------------------
    stage("simulating the grid core")
    t0 = time.time()
    uvd, comps = simulate.make_hera_core(
        nside=args.nside, spacing=args.spacing, bllen_max=args.bllen_max,
        nfreqs=args.nfreqs, ntimes=args.ntimes, nsrc=args.nsrc,
    )
    t_sim = time.time() - t0
    nants, nbls = uvd.Nants_data, uvd.Nbls
    stage(f"{nants} antennas, {nbls} baselines <= {args.bllen_max} m, "
          f"{uvd.Ntimes} times")

    # --- corrupt + fit -------------------------------------------------------
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)

    stage(f"fitting on backend={jax.default_backend()}")
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
        time_parallel=args.ntimes > 1,
    )
    t_fit = time.time() - t0

    rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))
    nsteps = len(info[0][0]["loss"])
    print(f"\n=== HERA-core demo: {nants} ants / {nbls} baselines / "
          f"{args.nfreqs} channels / {uvd.Ntimes} times ===")
    print(f"simulate  : {t_sim:7.1f}s (sky, basis and projection)")
    print(f"fit       : {t_fit:7.1f}s ({nsteps} steps, "
          f"{1e3 * t_fit / max(nsteps, 1):.2f} ms/step incl. compile+packing)")
    print(f"loss      : {info[0][0]['loss'][0]:.3e} -> {info[0][0]['loss'][-1]:.3e}")
    print(f"model/resid: {rms(model.data_array) / rms(resid.data_array):.1f}x")
    print(f"data/resid : {rms(corrupted.data_array) / rms(resid.data_array):.1f}x")


if __name__ == "__main__":
    main()
