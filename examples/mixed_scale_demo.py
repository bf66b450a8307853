#!/usr/bin/env python
"""Mixed multi-baseline-covariance mode at scale.

The reference treats `calibrate_and_model_mixed` as a first-class
production mode (reference calibration.py:1353-1500) whose scaling wall
is the `eigh((Nbl*Nf)^2)` of the analytic covariance (reference
simple_cov.py:100-182; SURVEY.md section 3.3). Two modes:

  fit    python examples/mixed_scale_demo.py --rings 3 --nfreqs 256
         Hex-lattice array, DPSS-projected point-source sky, 3% gain
         corruption; uv-overlap grouping + mixed DPSS/covariance
         components (timed separately), then the full blind self-cal on
         the default backend to a convergence result.

  probe  python examples/mixed_scale_demo.py --probe --nfreqs 128 \
             --probe_nbls 8,16,32,64,128
         The eigh scaling ladder: for each Nbl, build the (Nbl*Nf)^2
         covariance and time host numpy f64 eigh vs jax eigh on the
         default backend (f32; f64 optional). Prints the eigh timing
         table of DESIGN.md "Mixed mode at scale".
"""

import argparse
import sys
import time

import numpy as np


def hex_lattice(rings, pitch):
    pts = []
    for i in range(-rings, rings + 1):
        for j in range(-rings, rings + 1):
            if abs(i + j) <= rings:
                pts.append((pitch * (i + j / 2.0), pitch * j * np.sqrt(3) / 2.0, 0.0))
    return np.asarray(pts)


def stage(label):
    print(f"[{time.strftime('%H:%M:%S')}] {label}", file=sys.stderr, flush=True)


def run_probe(args, jax):
    import jax.numpy as jnp

    from calamity_tpu.models import simple_cov

    nfreqs = args.nfreqs
    freqs = 100e6 + 100e3 * np.arange(nfreqs)
    rng = np.random.default_rng(11)
    rows = []
    for nbl in [int(x) for x in args.probe_nbls.split(",")]:
        n = nbl * nfreqs
        # an EW-dominated scatter of baseline vectors (overlap groups merge
        # along uv tracks, so same-orientation vectors are the real shape)
        blvecs = np.zeros((nbl, 3))
        blvecs[:, 0] = 14.6 * (1 + np.arange(nbl)) + rng.normal(0, 0.3, nbl)
        blvecs[:, 1] = rng.normal(0, 0.5, nbl)

        t0 = time.perf_counter()
        cmat = simple_cov.simple_cov_matrix(
            blvecs, freqs, ant_dly=10.0 / 1e9, horizon=1.0, offset=10.0,
            min_dly=10.0, dtype=np.float64, use_jax=False,
        )
        t_build_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        evals_h, evecs_h = np.linalg.eigh(cmat)
        t_eigh_np = time.perf_counter() - t0
        ncomp_h = int(np.count_nonzero(evals_h / evals_h[-1] >= 1e-10))

        t_build_j = t_eigh_j = float("nan")
        ncomp_j = -1
        sub = float("nan")
        if not args.skip_jax:
            dtype_j = np.float64 if args.jax_f64 else np.float32
            t0 = time.perf_counter()
            cj = simple_cov.simple_cov_matrix(
                blvecs, freqs, ant_dly=10.0 / 1e9, horizon=1.0, offset=10.0,
                min_dly=10.0, dtype=dtype_j, use_jax=True,
            )
            cj = jax.block_until_ready(cj)
            t_build_j = time.perf_counter() - t0
            t0 = time.perf_counter()
            evals_j, evecs_j = jnp.linalg.eigh(cj)
            evals_j = np.asarray(jax.block_until_ready(evals_j))
            evecs_j = np.asarray(evecs_j)
            t_eigh_j = time.perf_counter() - t0
            # f32 cannot resolve relative eigenvalues below ~1e-7, so the
            # 1e-10 cutoff keeps extra near-null vectors; count at both
            ncomp_j = int(np.count_nonzero(evals_j / evals_j[-1] >= 1e-10))
            # subspace agreement on the host-f64 retained components:
            # || (I - Pj) Ph ||_F / sqrt(k) where Pj projects onto the jax
            # basis truncated at the same rank
            k = ncomp_h
            vh = evecs_h[:, -k:]
            vj = evecs_j[:, -k:].astype(np.float64)
            sub = float(
                np.linalg.norm(vh - vj @ (vj.T @ vh)) / np.sqrt(k)
            )
        rows.append(
            (nbl, n, t_build_np, t_eigh_np, ncomp_h, t_build_j, t_eigh_j,
             ncomp_j, sub)
        )
        stage(
            f"nbl={nbl:4d} N={n:6d}: numpy f64 build {t_build_np:7.1f}s "
            f"eigh {t_eigh_np:7.1f}s keep {ncomp_h:5d} | jax build "
            f"{t_build_j:6.1f}s eigh {t_eigh_j:6.1f}s keep {ncomp_j:5d} "
            f"subspace-err {sub:.2e}"
        )
    print("\n| Nbl | Nbl*Nf | np-f64 build | np-f64 eigh | kept | "
          "jax build | jax eigh | kept | subspace err |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r[0]} | {r[1]} | {r[2]:.1f}s | {r[3]:.1f}s | {r[4]} | "
            f"{r[5]:.1f}s | {r[6]:.1f}s | {r[7]} | {r[8]:.2e} |"
        )


def run_fit(args, jax):
    from calamity_tpu import cal_utils, calibration, models, simulate
    from calamity_tpu.io.visdata import VisData

    rng = np.random.default_rng(13)
    antpos = hex_lattice(args.rings, 14.6)
    nants = len(antpos)
    iu, ju = np.triu_indices(nants, k=1)
    vecs = antpos[ju] - antpos[iu]
    nbls = len(vecs)
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    stage(f"{nants} antennas, {nbls} baselines, {len(uniq)} unique spacings")

    freqs = 100e6 + 100e3 * np.arange(args.nfreqs)
    vis_uniq = simulate.point_source_visibilities(uniq, freqs, nsrc=30, seed=1)
    cache = {}
    lengths = np.linalg.norm(uniq, axis=1)
    for u in range(len(uniq)):
        mat = models.yield_dpss_model_comps_bl_grp(
            lengths[u], freqs, min_dly=10.0, offset=10.0, operator_cache=cache
        )
        vis_uniq[u] = mat @ (mat.T @ vis_uniq[u])
    data = vis_uniq[inverse]

    uvd = VisData(
        telescope_name="HERA-MIXED-SIM",
        instrument="HERA-MIXED-SIM",
        latitude=simulate.HERA_LAT,
        longitude=simulate.HERA_LON,
        altitude=simulate.HERA_ALT,
        channel_width=100e3,
        ant_1_array=iu.astype(np.int64),
        ant_2_array=ju.astype(np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=simulate._enu_to_ecef_rel(
            antpos, simulate.HERA_LAT, simulate.HERA_LON
        ),
        freq_array=freqs[None, :],
        integration_time=np.full(nbls, 10.7),
        lst_array=np.zeros(nbls),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.full(nbls, 2459122.25),
        uvw_array=vecs,
        data_array=data[:, None, :, None].astype(np.complex64),
        flag_array=np.zeros((nbls, 1, args.nfreqs, 1), dtype=bool),
        nsample_array=np.ones((nbls, 1, args.nfreqs, 1), dtype=np.float32),
    )

    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)

    stage("uv-overlap grouping")
    t0 = time.time()
    fitting_grps, blvecs, _, _ = models.get_uv_overlapping_grps_conjugated(
        corrupted, red_tol=1.0, red_tol_freq=args.red_tol_freq,
        n_angle_bins=200,
    )
    t_grp = time.time() - t0
    sizes = [len(g) for g in fitting_grps]
    big = [s for s in sizes if s > args.grp_size_threshold]
    stage(
        f"  {len(fitting_grps)} fitting groups in {t_grp:.1f}s; "
        f"{len(big)} covariance groups (largest {max(sizes)} red-grps -> "
        f"eigh N = {max(sizes) * args.nfreqs})"
    )

    stage(f"mixed components (use_jax={args.use_jax})")
    t0 = time.time()
    comps = models.yield_mixed_comps(
        fitting_grps, blvecs, freqs,
        eigenval_cutoff=1e-10,
        ant_dly=10.0 / 1e9,
        horizon=1.0, offset=10.0, min_dly=10.0,
        dtype=np.float64 if not args.use_jax else np.float32,
        use_jax=args.use_jax,
        grp_size_threshold=args.grp_size_threshold,
        verbose=True,
    )
    t_comps = time.time() - t0
    stage(f"  built in {t_comps:.1f}s")

    stage(f"fitting on backend={jax.default_backend()}")
    t0 = time.time()
    model, resid, gains, info = calibration.calibrate_and_model_mixed(
        uvdata=corrupted,
        model_comps_dict=comps,
        grp_size_threshold=args.grp_size_threshold,
        maxsteps=args.maxsteps,
        tol=1e-11,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        patience=500,
        use_min=True,
        verbose=True,
    )
    t_fit = time.time() - t0

    rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))
    nsteps = len(info[0][0]["loss"])
    print(f"\n=== mixed demo: {nants} ants / {nbls} bls / {args.nfreqs} ch ===")
    print(f"grouping  : {t_grp:7.1f}s ({len(fitting_grps)} groups, "
          f"{len(big)} covariance-mode)")
    print(f"components: {t_comps:7.1f}s (use_jax={args.use_jax})")
    print(f"fit       : {t_fit:7.1f}s ({nsteps} steps, "
          f"{1e3 * t_fit / max(nsteps, 1):.2f} ms/step incl. compile)")
    print(f"loss      : {info[0][0]['loss'][0]:.3e} -> {info[0][0]['loss'][-1]:.3e}")
    print(f"model/resid: {rms(model.data_array) / rms(resid.data_array):.1f}x")
    print(f"data/resid : {rms(corrupted.data_array) / rms(resid.data_array):.1f}x")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rings", type=int, default=3, help="hex rings (3 -> 37 ants)")
    ap.add_argument("--nfreqs", type=int, default=256)
    ap.add_argument("--maxsteps", type=int, default=3000)
    ap.add_argument("--grp_size_threshold", type=int, default=5)
    ap.add_argument("--red_tol_freq", type=float, default=0.5)
    ap.add_argument("--use_jax", action="store_true",
                    help="device covariance build + eigh")
    ap.add_argument("--probe", action="store_true", help="eigh scaling ladder")
    ap.add_argument("--probe_nbls", default="8,16,32,64")
    ap.add_argument("--jax_f64", action="store_true")
    ap.add_argument("--skip_jax", action="store_true")
    ap.add_argument("--backend", default="default", choices=["cpu", "default"])
    args = ap.parse_args()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from calamity_tpu.utils import configure_compile_cache

    configure_compile_cache()
    if args.probe:
        run_probe(args, jax)
    else:
        run_fit(args, jax)


if __name__ == "__main__":
    main()
