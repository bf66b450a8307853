#!/usr/bin/env python
"""Full-HERA-scale demo: 331-antenna hex lattice, ALL baselines, full band.

The BASELINE north star is a 350-antenna x 1536-channel fit. This demo
builds a complete hexagonal lattice (rings=10 -> 331 antennas at HERA's
14.6 m pitch), keeps EVERY cross baseline (54,615 of them), and runs the
blind self-cal on one chip. The shared-batched packing makes this tractable:
the lattice has only a few hundred unique baseline vectors, so the basis
operators and foreground components are stored per unique spacing and
bucketed into a handful of batched-matmul chunks.

    python examples/hera_full_demo.py                  # GPU if present
    python examples/hera_full_demo.py --rings 4 --nfreqs 256 --backend cpu
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rings", type=int, default=10, help="hex rings (10 -> 331 ants)")
    ap.add_argument("--pitch", type=float, default=14.6)
    ap.add_argument("--nfreqs", type=int, default=1536)
    ap.add_argument("--nsrc", type=int, default=50)
    ap.add_argument("--maxsteps", type=int, default=2000)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--backend", default="default", choices=["cpu", "default"])
    ap.add_argument("--comps_precision", default=None,
                    choices=["float32", "bfloat16", "mixed"],
                    help="basis storage precision for the descent "
                         "(docs/BF16_COMPS.md)")
    ap.add_argument("--time_parallel", action="store_true",
                    help="run the batched fit path (sharded over the mesh)")
    ap.add_argument("--warm_start_times", action="store_true",
                    help="with --time_parallel: fit times SEQUENTIALLY, each "
                         "warm-started from the previous time's solution "
                         "(init_guesses_from_previous_time_step). With any "
                         "endurance flag (--checkpoint_dir, "
                         "--steps_per_execution, --loss_block_ngrps) each "
                         "time's descent runs through the segmented batched "
                         "machinery; device holds ONE time slice")
    ap.add_argument("--mesh", default=None,
                    help="'auto' or 'N_DATA,N_BL': shard the fit over a "
                         "('data','bl') jax.sharding.Mesh")
    ap.add_argument("--ntimes", type=int, default=1)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="mid-fit checkpoint/resume directory (endurance runs)")
    ap.add_argument("--checkpoint_every", type=int, default=1000)
    ap.add_argument("--steps_per_execution", type=int, default=None,
                    help="bound a single device execution's step count "
                         "(execution time limits)")
    ap.add_argument("--prep_cache", default=None,
                    help="directory caching the prepared inputs (corrupted "
                         "data uvh5 + component dict). The ~hour of host "
                         "prep at full scale then runs once; supervised "
                         "relaunches (calamity_tpu.supervisor) reload in "
                         "minutes")
    ap.add_argument("--prep_only", action="store_true",
                    help="build + cache the prepared inputs and exit "
                         "without touching the device (fill the cache "
                         "while the device is busy or down)")
    ap.add_argument("--patience", type=int, default=500,
                    help="freeze a slice when its loss has not improved for "
                         "this many steps (with use_min bookkeeping; 0 off). "
                         "Default 500: the measured-best stopping config for "
                         "long blind-cal fits — on the measured plateau the "
                         "argmin lands at step ~3,200 and 21,788 further "
                         "steps produce no new minimum (docs/DESIGN.md "
                         "'Patience stopping'); reference semantics need an "
                         "explicit --patience 0")
    ap.add_argument("--loss_block_ngrps", type=int, default=None,
                    help="group-block size for the scanned batched loss "
                         "(bounds activation HBM at many times)")
    ap.add_argument("--wgts_precision", default="float32",
                    choices=["float32", "bfloat16"],
                    help="weight-cube storage precision; bfloat16 halves "
                         "the weights' HBM footprint (matters with "
                         "--rfi_flag_frac: frequency-dependent weights "
                         "defeat the freq-invariant compression)")
    ap.add_argument("--rfi_flag_frac", type=float, default=0.0,
                    help="flag this fraction of channels in RFI-like bands "
                         "(per time; makes the weights frequency-dependent "
                         "like the reference's MWA RFI fixture)")
    ap.add_argument("--data_dtype", default="complex64",
                    choices=["complex64", "complex128"],
                    help="host storage dtype for the visibility cubes. The "
                         "fit computes in float32 either way; complex64 "
                         "halves every host VisData copy (~10 GiB each at "
                         "331 ants x 1536 ch x 8 times — the first "
                         "endurance run OOM'd a 125 GiB host on complex128 "
                         "copies in the write-back)")
    args = ap.parse_args()
    if args.prep_only and args.prep_cache is None:
        raise SystemExit("--prep_only requires --prep_cache")

    import os

    if args.backend == "cpu":
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from calamity_tpu.utils import configure_compile_cache

    configure_compile_cache()

    from calamity_tpu import cal_utils, calibration, models, simulate
    from calamity_tpu.io.visdata import VisData

    rng = np.random.default_rng(13)

    def stage(label):
        print(f"[{time.strftime('%H:%M:%S')}] {label}", file=sys.stderr, flush=True)

    antpos = hex_lattice(args.rings, args.pitch)
    nants = len(antpos)
    # all cross baselines
    iu, ju = np.triu_indices(nants, k=1)
    vecs = antpos[ju] - antpos[iu]
    nbls = len(vecs)
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    stage(f"{nants} antennas, {nbls} baselines, {len(uniq)} unique spacings")

    # prepared-input cache: at full scale the sim/basis/corrupt prep below
    # is ~an hour of host time; supervised relaunches after a device
    # failure reload the finished inputs in minutes instead
    cache_key = dict(rings=args.rings, pitch=args.pitch, nfreqs=args.nfreqs,
                     nsrc=args.nsrc, ntimes=args.ntimes)
    if args.prep_cache is not None:
        meta_p = os.path.join(args.prep_cache, "meta.npz")
        if os.path.isfile(meta_p):
            meta = np.load(meta_p)
            # a cache built with MORE times serves a smaller run (select
            # the leading subset) — the fallback path when a full
            # many-times config exceeds the device
            cached_nt = int(meta["ntimes"])
            mismatch = {
                k: (v, meta[k].item()) for k, v in cache_key.items()
                if k != "ntimes" and meta[k].item() != v
            }
            if args.ntimes > cached_nt:
                mismatch["ntimes"] = (args.ntimes, cached_nt)
            if mismatch:
                raise SystemExit(
                    f"--prep_cache {args.prep_cache} was built for a "
                    f"different configuration: {mismatch}"
                )
            if args.prep_only:
                stage("prep_only: cache already present")
                return
            stage(f"loading prepared inputs from {args.prep_cache}")
            t0 = time.time()
            # cast DURING the read (per-HDF5-chunk conversion): loading the
            # cache's file dtype and casting after would materialize the
            # full-precision cube plus the cast copy simultaneously — the
            # exact host transient the data_dtype lever exists to avoid
            corrupted = VisData.from_uvh5(
                os.path.join(args.prep_cache, "corrupted.uvh5"),
                data_dtype=np.dtype(args.data_dtype),
            )
            if args.ntimes < cached_nt:
                keep = np.unique(corrupted.time_array)[: args.ntimes]
                corrupted.select(times=keep, inplace=True)
                stage(f"  selected {args.ntimes} of {cached_nt} cached times")
            comps = np.load(
                os.path.join(args.prep_cache, "comps.npy"), allow_pickle=True
            ).item()
            t_sim = float(meta["t_sim"])
            t_basis = float(meta["t_basis"])
            stage(f"  loaded in {time.time() - t0:.0f}s")
            run_fit(args, corrupted, comps, nants, nbls, len(uniq),
                    t_sim, t_basis, jax, calibration, stage)
            return

    stage("simulating + projecting per unique spacing")
    t0 = time.time()
    freqs = 100e6 + 100e3 * np.arange(args.nfreqs)
    vis_uniq = simulate.point_source_visibilities(uniq, freqs, nsrc=args.nsrc, seed=1)
    cache = {}
    lengths = np.linalg.norm(uniq, axis=1)
    for u in range(len(uniq)):
        mat = models.yield_dpss_model_comps_bl_grp(
            lengths[u], freqs, min_dly=10.0, offset=10.0, operator_cache=cache
        )
        vis_uniq[u] = mat @ (mat.T @ vis_uniq[u])
    data = vis_uniq[inverse]
    t_sim = time.time() - t0
    stage(f"  {len(cache)} distinct operators")

    uvd = VisData(
        telescope_name="HERA-FULL-SIM",
        instrument="HERA-FULL-SIM",
        latitude=simulate.HERA_LAT,
        longitude=simulate.HERA_LON,
        altitude=simulate.HERA_ALT,
        channel_width=100e3,
        ant_1_array=np.tile(iu, args.ntimes).astype(np.int64),
        ant_2_array=np.tile(ju, args.ntimes).astype(np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=simulate._enu_to_ecef_rel(antpos, simulate.HERA_LAT,
                                                    simulate.HERA_LON),
        freq_array=freqs[None, :],
        integration_time=np.full(nbls * args.ntimes, 10.7),
        lst_array=np.zeros(nbls * args.ntimes),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.repeat(2459122.25 + 2.0 * np.arange(args.ntimes), nbls),
        uvw_array=np.tile(vecs, (args.ntimes, 1)),
        data_array=np.tile(data[:, None, :, None], (args.ntimes, 1, 1, 1)).astype(
            np.dtype(args.data_dtype)
        ),
        flag_array=np.zeros((nbls * args.ntimes, 1, args.nfreqs, 1), dtype=bool),
        nsample_array=np.ones((nbls * args.ntimes, 1, args.nfreqs, 1), dtype=np.float32),
    )
    del data, vis_uniq

    stage("building component dict")
    t0 = time.time()
    # share the projection loop's operator cache: each distinct delay
    # width costs an O(Nfreqs) tridiagonal eigh at the full band
    comps = models.yield_pbl_dpss_model_comps(
        uvd, min_dly=10.0, offset=10.0, operator_cache=cache
    )
    t_basis = time.time() - t0

    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)
    del uvd

    if args.prep_cache is not None:
        stage(f"caching prepared inputs to {args.prep_cache}")
        t0 = time.time()
        os.makedirs(args.prep_cache, exist_ok=True)
        corrupted.write_uvh5(
            os.path.join(args.prep_cache, "corrupted.uvh5"), clobber=True
        )
        # the dict's matrices are shared objects (operator cache); pickle
        # memoizes by identity so the file stays ~per-distinct-operator
        np.save(os.path.join(args.prep_cache, "comps.npy"),
                np.asarray(comps, dtype=object), allow_pickle=True)
        # meta is the cache-valid gate: written LAST and atomically, so an
        # interrupted prep leaves no meta and the next run just rebuilds
        tmp = os.path.join(args.prep_cache, "meta.tmp.npz")
        np.savez(tmp, t_sim=t_sim, t_basis=t_basis, n_uniq=len(uniq),
                 **cache_key)
        os.replace(tmp, os.path.join(args.prep_cache, "meta.npz"))
        stage(f"  cached in {time.time() - t0:.0f}s")

    if args.prep_only:
        stage("prep_only: done")
        return

    run_fit(args, corrupted, comps, nants, nbls, len(uniq),
            t_sim, t_basis, jax, calibration, stage)


def run_fit(args, corrupted, comps, nants, nbls, n_uniq, t_sim, t_basis,
            jax, calibration, stage):
    if args.rfi_flag_frac > 0:
        # RFI-like contiguous channel bands, identical across times (the
        # persistent-transmitter pattern of the reference's MWA fixture);
        # frequency-dependent flags defeat the freq-invariant weight
        # compression, exercising the full weights cube (+ bf16 storage)
        frng = np.random.default_rng(99)
        nf = corrupted.Nfreqs
        target = int(args.rfi_flag_frac * nf)
        flagged = np.zeros(nf, dtype=bool)
        while flagged.sum() < target:
            c = int(frng.integers(0, nf))
            w = int(frng.integers(2, 24))
            flagged[max(0, c - w // 2): c + w // 2 + 1] = True
        corrupted.flag_array[:, :, flagged, :] = True
        stage(f"RFI flags: {int(flagged.sum())}/{nf} channels in bands")
    mesh = None
    if args.mesh is not None:
        from calamity_tpu.parallel.mesh import make_mesh

        if args.mesh == "auto":
            mesh = make_mesh()
        else:
            n_data, n_bl = (int(x) for x in args.mesh.split(","))
            mesh = make_mesh(n_data=n_data, n_bl=n_bl)
        stage(f"mesh: {dict(mesh.shape)} over {len(jax.devices())} devices")

    stage(f"fitting on backend={jax.default_backend()}"
          f" (time_parallel={args.time_parallel})")
    t0 = time.time()
    timings = {}
    model, resid, gains, info = calibration.calibrate_and_model_dpss(
        uvdata=corrupted,
        gains=None,
        fg_model_comps_dict=comps,
        maxsteps=args.maxsteps,
        comps_precision=args.comps_precision,
        wgts_precision=args.wgts_precision,
        tol=args.tol,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        nvec_bucketing=True,
        remat=True,
        time_parallel=args.time_parallel,
        init_guesses_from_previous_time_step=args.warm_start_times,
        mesh=mesh,
        timings=timings,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        steps_per_execution=args.steps_per_execution,
        loss_block_ngrps=args.loss_block_ngrps,
        patience=args.patience,
        use_min=args.patience > 0,
        verbose=True,
    )
    t_fit = time.time() - t0

    # device memory headroom (GPUs report it; CPU backends may not)
    mem_line = ""
    try:
        stats = jax.devices()[0].memory_stats()
        if stats and "bytes_in_use" in stats:
            used = stats["bytes_in_use"] / 2**30
            lim = stats.get("bytes_limit", 0) / 2**30
            mem_line = f"device mem : {used:6.2f} GiB in use" + (
                f" of {lim:.2f} GiB" if lim else ""
            )
    except Exception:
        pass

    rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))
    nsteps = len(info[0][0]["loss"])
    print(f"\n=== full-HERA demo: {nants} ants / {nbls} baselines / "
          f"{args.nfreqs} channels / {n_uniq} unique spacings ===")
    print(f"sim+proj  : {t_sim:7.1f}s")
    print(f"basis     : {t_basis:7.1f}s")
    print(f"packing   : {timings.get('packing_s', float('nan')):7.2f}s "
          "(FitSpec: chunk tensors + row/conj tables)")
    print(f"fit       : {t_fit:7.1f}s ({nsteps} steps, "
          f"{1e3 * t_fit / max(nsteps, 1):.2f} ms/step incl. compile+packing)")
    if "writeback_s" in timings:
        print(f"write-back: {timings['writeback_s']:7.1f}s "
              f"(host RSS at end {timings.get('writeback_rss_gib', float('nan')):.1f} GiB)")
    stage_keys = [
        ("select_s", "baseline select"),
        ("model_resid_copies_s", "model/resid copies"),
        ("gains_init_s", "gains init"),
        ("sky_init_s", "sky-model init"),
        ("extract_s", "host extraction into padded stacks"),
        ("upload_s", "device upload"),
        ("warmstart_s", "lstsq warm starts"),
        ("loss_guard_s", "step-0 loss guard"),
        ("plan_compile_s", "segment executable compiles"),
        ("descent_s", "descent (device)"),
        ("scan_guard_s", "scan: step-0 host guard"),
        ("scan_upload_s", "scan: per-time uploads"),
        ("scan_descent_s", "scan: descents"),
        ("scan_fetch_s", "scan: solution fetches"),
        ("scan_save_s", "scan: marker saves"),
    ]
    if any(k in timings for k, _ in stage_keys):
        print("--- per-stage wall-clock ---")
        for k, label in stage_keys:
            if k in timings:
                print(f"  {label:36s}: {timings[k]:8.1f}s")
    print(f"loss      : {info[0][0]['loss'][0]:.3e} -> {info[0][0]['loss'][-1]:.3e}")
    print(f"model/resid: {rms(model.data_array) / rms(resid.data_array):.1f}x")
    print(f"data/resid : {rms(corrupted.data_array) / rms(resid.data_array):.1f}x")
    if mem_line:
        print(mem_line)
    from calamity_tpu.utils import rss_gib

    print(f"host RSS  : {rss_gib():6.1f} GiB (data dtype {args.data_dtype})")


if __name__ == "__main__":
    main()
