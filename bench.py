"""Benchmark: time per Adam(ax) step on a HERA-scale single-chip chunk.

Prints ONE JSON line:
    {"metric": "adam_step_time", "value": <ms>, "unit": "ms/step",
     "vs_baseline": <speedup>}

The reference publishes no benchmark numbers (BASELINE.md), so the baseline
is the reference's own computational pattern measured on the SAME device:
the (nvecs, ngrps, nbls, nfreqs) broadcast-multiply-reduce foreground model
(reference calibration.py:1587-1590, a pure vector-unit op reading nvecs x
the model size from HBM), per-step eager dispatch (graph_mode=False default,
calibration.py:670-679), and the per-step host sync of loss.numpy()
(calibration.py:701). "Ours" is this framework's production step:
batched-matvec layout, whole loop jit-compiled, convergence checked on
device. vs_baseline = baseline_ms / ours_ms (>1 means faster than the
reference pattern on identical hardware and config).

Config: one chunk of a 350-antenna x 1536-channel HERA fit — 2048 baselines,
128 DPSS modes, float32 (the chunking the solver uses at full scale; the
full problem shards chunks like this across the mesh). All inputs are
generated on device (no host->device payloads in the timing path).

Runs only on a GPU: without one it exits nonzero before measuring. The
card's name and power limit are printed (stderr) before the result.
"""

from __future__ import annotations

import json
import time
from functools import partial


def _device_inputs(ngrps, nbls, nfreqs, nvecs, nants, dtype):
    """Deterministic pseudo-random inputs generated on device.

    Uses sin-of-linear-index synthesis instead of jax.random: benchmark
    inputs only need decorrelated values, generated in one small program."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    def synth(shape, phase):
        # reduce an int32 index modulo a large prime BEFORE the float
        # multiply: a float32 arange is only integer-exact to 2^24, and at
        # benchmark sizes sin() would be constant over ~34-index runs,
        # degenerating the basis
        n = int(np.prod(shape))
        idx = jnp.arange(n, dtype=jnp.int32) % jnp.int32(7_368_787)
        return jnp.sin(
            idx.astype(dtype) * dtype(0.9310) + dtype(phase)
        ).reshape(shape)

    @jax.jit
    def build():
        comps = synth((ngrps, nbls, nfreqs, nvecs), 0.1)
        comps = comps / (
            jnp.linalg.norm(comps, axis=2, keepdims=True) + jnp.asarray(1e-6, dtype)
        )
        idx = jnp.arange(ngrps * nbls, dtype=jnp.int32).reshape(ngrps, nbls)
        a0 = (idx * 7919) % nants
        a1 = (idx * 104729 + 1) % nants
        g_r = jnp.ones((nants, nfreqs), dtype)
        g_i = jnp.zeros((nants, nfreqs), dtype)
        fg_r = synth((ngrps, nvecs), 1.2)
        fg_i = synth((ngrps, nvecs), 2.3)
        data_r = synth((ngrps, nbls, nfreqs), 3.4)
        data_i = synth((ngrps, nbls, nfreqs), 4.5)
        wgts = jnp.abs(synth((ngrps, nbls, nfreqs), 5.6))
        wgts = wgts / jnp.sum(wgts)
        return comps, a0, a1, g_r, g_i, fg_r, fg_i, data_r, data_i, wgts

    out = build()
    jax.block_until_ready(out[0])
    return out


def bench_ours(inputs, nsteps, lr=1e-2, comps_dtype=None):
    """Production step: batched-matvec loss, whole fori_loop jit-compiled.

    ``comps_dtype=bfloat16`` benches the bf16 basis-storage
    step — the bulk phase of the DEFAULT comps_precision="mixed" schedule
    (docs/BF16_COMPS.md), i.e. the step time the shipped default
    configuration actually delivers."""
    import jax
    import jax.numpy as jnp
    import optax

    from calamity_tpu.ops.loss import chunked_loss

    comps, a0, a1, g_r, g_i, fg_r, fg_i, data_r, data_i, wgts = inputs
    if comps_dtype is not None:
        comps = comps.astype(comps_dtype)
    opt = optax.adamax(lr)

    # NOTE: all large arrays are explicit jit arguments — captured device
    # arrays would be baked into the program as constants.
    @partial(jax.jit, static_argnames=("n",))
    def run(params, opt_state, comps, a0, a1, data_r, data_i, wgts, n):
        chunks = ((comps, a0, a1),)

        def loss_fn(params):
            gr, gi, fr, fi = params
            return chunked_loss(
                gr, gi, (fr,), (fi,), chunks, (data_r,), (data_i,), (wgts,),
            )

        vg = jax.value_and_grad(loss_fn)

        def body(i, carry):
            params, opt_state, _ = carry
            loss, grads = vg(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return jax.lax.fori_loop(0, n, body, (params, opt_state, jnp.zeros((), data_r.dtype)))

    params = (g_r, g_i, fg_r, fg_i)
    opt_state = opt.init(params)
    big = (comps, a0, a1, data_r, data_i, wgts)
    n_small = max(2, nsteps // 10)

    def timed(n, s):
        # every timed call gets DISTINCT parameter values; the timed region
        # ends with a device->host scalar fetch of the final loss
        p = jax.tree_util.tree_map(
            lambda x: x * (jnp.ones((), x.dtype) + jnp.asarray(1e-6 * s, x.dtype)),
            params,
        )
        jax.block_until_ready(p)
        t0 = time.perf_counter()
        out = run(p, opt_state, *big, n=n)
        loss = float(out[2])
        return time.perf_counter() - t0, loss

    timed(n_small, 0)  # compile at n_small
    timed(nsteps, 1)  # compile at nsteps
    t_small, _ = timed(n_small, 2)
    t_big, loss = timed(nsteps, 3)
    # difference cancels the constant dispatch + fetch overhead
    return (t_big - t_small) / (nsteps - n_small) * 1e3, loss


def bench_shared_batched(nsteps, U, gmax, nfreqs, nvecs, nants, lr=1e-2,
                         dtype=None):
    """Shared-BATCHED packing step (redundant arrays): ngrps = U x gmax
    baselines share U basis operators stored once — the production packing
    for HERA-class redundant arrays (docs/DESIGN.md "Shared-basis
    packing"). Returns ms/step; compare against the dense headline row
    measured at the same ngrps/nfreqs/nvecs to corroborate the packing
    win (docs claim 9.3x at U=16, gmax=128, F=1536, V=128)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    if dtype is None:
        dtype = jnp.float32
    ngrps = U * gmax

    @jax.jit
    def build():
        n = U * 1 * nfreqs * nvecs
        idx = jnp.arange(n, dtype=jnp.int32) % jnp.int32(7_368_787)
        comps = jnp.sin(idx.astype(dtype) * dtype(0.9310)).reshape(
            (U, 1, nfreqs, nvecs)
        )
        comps = comps / (
            jnp.linalg.norm(comps, axis=2, keepdims=True) + jnp.asarray(1e-6, dtype)
        )
        gidx = jnp.arange(ngrps, dtype=jnp.int32).reshape(ngrps, 1)
        a0 = (gidx * 7919) % nants
        a1 = (gidx * 104729 + 1) % nants
        g_r = jnp.ones((nants, nfreqs), dtype)
        g_i = jnp.zeros((nants, nfreqs), dtype)

        def synth(shape, phase):
            m = int(np.prod(shape))
            ix = jnp.arange(m, dtype=jnp.int32) % jnp.int32(7_368_787)
            return jnp.sin(ix.astype(dtype) * dtype(0.9310) + dtype(phase)).reshape(shape)

        fg_r = synth((ngrps, nvecs), 1.2)
        fg_i = synth((ngrps, nvecs), 2.3)
        data_r = synth((ngrps, 1, nfreqs), 3.4)
        data_i = synth((ngrps, 1, nfreqs), 4.5)
        wgts = jnp.abs(synth((ngrps, 1, nfreqs), 5.6))
        wgts = wgts / jnp.sum(wgts)
        return comps, a0, a1, g_r, g_i, fg_r, fg_i, data_r, data_i, wgts

    inputs = build()
    jax.block_until_ready(inputs[0])
    return bench_ours(inputs, nsteps)[0]


def bench_segment_plan(nbatch, U, gmax, nfreqs, nvecs, nants, seg_len,
                       nsegs, loss_block, comps_dtype=None, lr=1e-2):
    """ms/step through the REAL production machinery: a BatchedSegmentPlan
    AOT auto-layout executable driven in bounded segments — the exact code
    path full-scale single-chip campaigns take (segmented descent, blocked
    loss, per-segment host bookkeeping). A reduced-full-footprint
    configuration (e.g. 8 poltimes x 8192 groups x 1536 ch shared-batched)
    corroborates the campaign-recorded production step times with a
    driver-captured number."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from calamity_tpu.parallel.batched import make_segment_plan
    from calamity_tpu.solver.fit import FitConfig
    from calamity_tpu.solver.optimizers import get_optimizer

    dtype = jnp.float32
    ngrps = U * gmax

    @jax.jit
    def build():
        def synth(shape, phase):
            m = int(np.prod(shape))
            ix = jnp.arange(m, dtype=jnp.int32) % jnp.int32(7_368_787)
            return jnp.sin(ix.astype(dtype) * dtype(0.9310) + dtype(phase)).reshape(shape)

        comps = synth((U, 1, nfreqs, nvecs), 0.1)
        comps = comps / (
            jnp.linalg.norm(comps, axis=2, keepdims=True) + jnp.asarray(1e-6, dtype)
        )
        gidx = jnp.arange(ngrps, dtype=jnp.int32).reshape(ngrps, 1)
        a0 = (gidx * 7919) % nants
        a1 = (gidx * 104729 + 1) % nants
        g_r = jnp.ones((nbatch, nants, nfreqs), dtype)
        g_i = jnp.zeros((nbatch, nants, nfreqs), dtype)
        fg_r = synth((nbatch, ngrps, nvecs), 1.2)
        fg_i = synth((nbatch, ngrps, nvecs), 2.3)
        data_r = synth((nbatch, ngrps, 1, nfreqs), 3.4)
        data_i = synth((nbatch, ngrps, 1, nfreqs), 4.5)
        wgts = jnp.abs(synth((nbatch, ngrps, 1, nfreqs), 5.6))
        wgts = wgts / jnp.sum(wgts)
        return comps, a0, a1, g_r, g_i, fg_r, fg_i, data_r, data_i, wgts

    comps, a0, a1, g_r, g_i, fg_r, fg_i, data_r, data_i, wgts = build()
    if comps_dtype is not None:
        comps = jax.jit(lambda c: c.astype(comps_dtype))(comps)
    jax.block_until_ready(comps)

    cfg = FitConfig(
        optimizer="Adamax",
        opt_kwargs=(("learning_rate", lr),),
        maxsteps=seg_len * nsegs + 1,
        tol=0.0,
        use_min=True,
        patience=0,
        loss_block=loss_block,
        loss_block_unit=1,
    )
    chunks = ((comps, a0, a1),)
    t0 = time.perf_counter()
    plan = make_segment_plan(
        cfg, seg_len, chunks, [data_r], [data_i], [wgts], g_r, [fg_r],
        jnp.zeros((nbatch,), dtype),
    )
    compile_s = time.perf_counter() - t0
    chunks = plan.put_entries(0, chunks)
    data_r = plan.put_entries(1, (data_r,))[0]
    data_i = plan.put_entries(2, (data_i,))[0]
    wgts = plan.put_entries(3, (wgts,))[0]

    opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
    params = (g_r, g_i, (fg_r,), (fg_i,))
    opt_state = opt.init(params)
    big = jnp.asarray(3e38, dtype)
    prev = jnp.full((nbatch,), big, dtype)
    frozen = jnp.zeros((nbatch,), bool)
    nsteps_slice = jnp.full((nbatch,), cfg.maxsteps, jnp.int32)
    best_loss = jnp.full((nbatch,), big, dtype)
    best_params = jax.tree_util.tree_map(jnp.copy, params)
    since_best = ()
    pr = jnp.zeros((nbatch,), dtype)
    step_total = 0
    times = []

    def one_segment(warmup):
        nonlocal params, opt_state, prev, frozen, nsteps_slice, best_loss
        nonlocal best_params, since_best, step_total
        seg_args = (
            chunks, (data_r,), (data_i,), (wgts,), (), (), pr, pr,
            params, opt_state, prev, frozen, nsteps_slice, best_loss,
            best_params, since_best, jnp.asarray(step_total, jnp.int32),
        )
        t0 = time.perf_counter()
        out = plan.run(seg_len, warmup, seg_args)
        (params, opt_state, prev, frozen, nsteps_slice, best_loss,
         best_params, since_best, hist, nrec) = out
        # per-segment host bookkeeping exactly as production pays it
        np.asarray(hist)
        nrec = int(nrec)
        step_total += nrec
        times.append(time.perf_counter() - t0)
        return nrec

    one_segment(True)   # warm-up segment (includes the unrecorded step)
    one_segment(False)  # settle
    for _ in range(nsegs - 2):
        one_segment(False)
    steady = times[2:]
    ms_per_step = float(np.sum(steady)) / (len(steady) * seg_len) * 1e3
    assert np.all(np.isfinite(np.asarray(prev)))
    return ms_per_step, compile_s


def bench_reference_pattern(inputs, nsteps, lr=1e-2):
    """The reference's computational pattern on the same device:
    (nvecs, ...) broadcast-reduce layout + per-step dispatch + host sync."""
    import jax
    import jax.numpy as jnp
    import optax

    comps, a0, a1, g_r, g_i, fg_r, fg_i, data_r, data_i, wgts = inputs
    # reference layout: comps (nvecs, ngrps, nbls, nfreqs), coeffs (nvecs, ngrps, 1, 1)
    comps_t = jax.jit(lambda c: jnp.moveaxis(c, -1, 0))(comps)
    fg_r_t = jnp.moveaxis(fg_r, -1, 0)[:, :, None, None]
    fg_i_t = jnp.moveaxis(fg_i, -1, 0)[:, :, None, None]
    opt = optax.adamax(lr)

    @jax.jit
    def step(params, opt_state, comps_t, a0, a1, data_r, data_i, wgts):
        def loss_fn(params):
            gr, gi, fr, fi = params
            vr = jnp.sum(fr * comps_t, axis=0)
            vi = jnp.sum(fi * comps_t, axis=0)
            gr0 = jnp.take(gr, a0, axis=0)
            gr1 = jnp.take(gr, a1, axis=0)
            gi0 = jnp.take(gi, a0, axis=0)
            gi1 = jnp.take(gi, a1, axis=0)
            grgr = gr0 * gr1
            gigi = gi0 * gi1
            grgi = gr0 * gi1
            gigr = gi0 * gr1
            model_r = (grgr + gigi) * vr + (grgi - gigr) * vi
            model_i = (gigr - grgi) * vr + (grgr + gigi) * vi
            return jnp.sum(
                (jnp.square(data_r - model_r) + jnp.square(data_i - model_i)) * wgts
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return loss, params, opt_state

    params = (g_r, g_i, fg_r_t, fg_i_t)
    opt_state = opt.init(params)
    big = (comps_t, a0, a1, data_r, data_i, wgts)
    loss, params2, opt_state2 = step(params, opt_state, *big)
    float(loss)  # compile + sync
    t0 = time.perf_counter()
    for _ in range(nsteps):
        loss, params, opt_state = step(params, opt_state, *big)
        float(loss)  # the reference's per-step loss.numpy() host sync
    t1 = time.perf_counter()
    return (t1 - t0) / nsteps * 1e3, float(loss)


def main():
    import sys

    import jax
    import numpy as np

    from calamity_tpu.utils import configure_compile_cache
    from chip_smoke import card_info, require_gpu

    dev = require_gpu(jax.devices())
    for line in card_info():
        print(f"# bench: {line}", file=sys.stderr, flush=True)
    print(f"# bench: {dev.device_kind}, compile cache {configure_compile_cache()}",
          file=sys.stderr, flush=True)
    cfg = dict(ngrps=2048, nbls=1, nfreqs=1536, nvecs=128, nants=352)
    nsteps = 100

    print(f"# bench: building inputs ({cfg})", file=sys.stderr, flush=True)
    inputs = _device_inputs(dtype=jax.numpy.float32, **cfg)
    print("# bench: timing f32 step (round-over-round continuity)",
          file=sys.stderr, flush=True)
    f32_ms, f32_loss = bench_ours(inputs, nsteps)
    print(f"# bench: f32 {f32_ms:.3f} ms/step; timing the DEFAULT "
          "configuration's step (bf16 comps — the bulk phase of the "
          "default comps_precision='mixed' schedule)",
          file=sys.stderr, flush=True)
    ours_ms, ours_loss = bench_ours(inputs, nsteps, comps_dtype=jax.numpy.bfloat16)
    print(f"# bench: fast {ours_ms:.3f} ms/step; timing reference pattern",
          file=sys.stderr, flush=True)
    ref_ms, ref_loss = bench_reference_pattern(inputs, min(nsteps, 30))
    print(f"# bench: ref {ref_ms:.3f} ms/step", file=sys.stderr, flush=True)
    assert np.isfinite(ours_loss) and np.isfinite(ref_loss) and np.isfinite(f32_loss)

    # secondary rows: shared-batched packing and the segment-plan route
    secondary = []
    # 2048 baselines sharing 16 operators
    sb_cfg = dict(U=16, gmax=128, nfreqs=1536, nvecs=128, nants=352)
    print(f"# bench: shared-batched packing row ({sb_cfg})",
          file=sys.stderr, flush=True)
    sb_ms = bench_shared_batched(200, **sb_cfg)
    print(f"# bench: shared-batched {sb_ms:.3f} ms/step "
          f"({f32_ms / sb_ms:.1f}x vs dense f32 at the same ngrps)",
          file=sys.stderr, flush=True)
    secondary.append(
        {
            "metric": "shared_basis_step_time",
            "value": round(sb_ms, 4),
            "unit": "ms/step",
            "vs_dense_f32": round(f32_ms / sb_ms, 3),
            "config": "U={U} gmax={gmax} F={nfreqs} V={nvecs}".format(**sb_cfg),
        }
    )
    # reduced-full-footprint production configuration: 8 poltimes x 8192
    # groups x 1536 ch shared-batched, bf16 comps, blocked loss, 40-step
    # bounded executions — the real segment machinery
    seg_cfg = dict(nbatch=8, U=512, gmax=16, nfreqs=1536, nvecs=128,
                   nants=352, seg_len=40, nsegs=6, loss_block=2048)
    print(f"# bench: segment-plan row ({seg_cfg})", file=sys.stderr, flush=True)
    seg_ms, seg_compile_s = bench_segment_plan(
        comps_dtype=jax.numpy.bfloat16, **seg_cfg
    )
    print(f"# bench: segment-plan {seg_ms:.3f} ms/step "
          f"(plan compile {seg_compile_s:.1f}s)", file=sys.stderr, flush=True)
    secondary.append(
        {
            "metric": "segment_plan_step_time",
            "value": round(seg_ms, 4),
            "unit": "ms/step",
            "plan_compile_s": round(seg_compile_s, 2),
            "config": (
                "nbatch={nbatch} U={U} gmax={gmax} F={nfreqs} V={nvecs} "
                "bf16-comps loss_block={loss_block} "
                "steps_per_execution={seg_len}"
            ).format(**seg_cfg),
        }
    )

    print(
        json.dumps(
            {
                "metric": "adam_step_time",
                "value": round(ours_ms, 4),
                "unit": "ms/step",
                "vs_baseline": round(ref_ms / ours_ms, 3),
                "secondary": secondary,
            }
        )
    )


if __name__ == "__main__":
    main()
