"""The float64 host reference of the loss, compile-cache placement, and the
optional file-I/O dependencies."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from calamity_tpu import utils
from calamity_tpu.ops.loss import chi_square_host, chunked_loss

ROOT = Path(__file__).resolve().parent.parent


def _chunk(kind, rng, nants=7, nbls=2, nfreqs=32, nvecs=8, ngrps=12):
    nu = {"dense": ngrps, "shared": 1, "shared_batched": 3}[kind]
    comps = (rng.standard_normal((nu, nbls, nfreqs, nvecs)) / np.sqrt(nfreqs)).astype(np.float32)
    a0 = rng.integers(0, nants, (ngrps, nbls)).astype(np.int32)
    a1 = ((a0 + 1 + rng.integers(0, nants - 1, (ngrps, nbls))) % nants).astype(np.int32)
    cube = (ngrps, nbls, nfreqs)
    return dict(
        comps=comps, a0=a0, a1=a1,
        g_r=(1 + 0.1 * rng.standard_normal((nants, nfreqs))).astype(np.float32),
        g_i=(0.1 * rng.standard_normal((nants, nfreqs))).astype(np.float32),
        fg_r=rng.standard_normal((ngrps, nvecs)).astype(np.float32),
        fg_i=rng.standard_normal((ngrps, nvecs)).astype(np.float32),
        data_r=rng.standard_normal(cube).astype(np.float32),
        data_i=rng.standard_normal(cube).astype(np.float32),
        wgts=np.abs(rng.standard_normal(cube)).astype(np.float32),
    )


@pytest.mark.parametrize("comps_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["dense", "shared", "shared_batched"])
def test_chunked_loss_matches_float64_reference(kind, comps_dtype):
    """Loss and gradient of every basis packing against the closed-form
    float64 reference, evaluated on the basis as stored (float32 arithmetic
    tolerance: loss 1e-5, gradient 1e-4 relative)."""
    x = _chunk(kind, np.random.default_rng(3))
    comps = jnp.asarray(x["comps"]).astype(comps_dtype)
    chunks = ((comps, jnp.asarray(x["a0"]), jnp.asarray(x["a1"])),)

    def loss(p):
        return chunked_loss(p[0], p[1], (p[2],), (p[3],), chunks,
                            (jnp.asarray(x["data_r"]),), (jnp.asarray(x["data_i"]),),
                            (jnp.asarray(x["wgts"]),))

    params = tuple(jnp.asarray(x[k]) for k in ("g_r", "g_i", "fg_r", "fg_i"))
    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    ref, (dg_r, dg_i, dfg_r, dfg_i) = chi_square_host(
        x["g_r"], x["g_i"], [x["fg_r"]], [x["fg_i"]], chunks,
        [x["data_r"]], [x["data_i"]], [x["wgts"]],
    )
    g = np.concatenate([np.asarray(a, np.float64).ravel() for a in grads])
    g_ref = np.concatenate([a.ravel() for a in (dg_r, dg_i, dfg_r[0], dfg_i[0])])
    assert abs(float(val) - ref) <= 1e-5 * abs(ref)
    assert np.linalg.norm(g - g_ref) <= 1e-4 * np.linalg.norm(g_ref)


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = str(ROOT / ".jax_cache")
    else:
        expected = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expected)
    assert utils.compile_cache_dir() == expected
    previous = jax.config.jax_compilation_cache_dir
    try:
        assert utils.configure_compile_cache() == expected
        # the env var is JAX's own setting: nothing else is configured then
        if env_dir is None:
            assert jax.config.jax_compilation_cache_dir == expected
        else:
            assert jax.config.jax_compilation_cache_dir == previous
    finally:
        jax.config.update("jax_compilation_cache_dir", previous)


def test_progress_without_tqdm(monkeypatch):
    monkeypatch.setitem(sys.modules, "tqdm", None)
    items = range(4)
    assert utils.progress(items) is items
    assert utils.progress(items, notebook=True) is items


def test_calibration_imports_without_h5py_and_tqdm():
    code = (
        "import builtins\n"
        "real = builtins.__import__\n"
        "def guarded(name, *a, **k):\n"
        "    if name.split('.')[0] in ('h5py', 'tqdm'):\n"
        "        raise ImportError(name)\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = guarded\n"
        "import calamity_tpu.calibration, calamity_tpu.simulate\n"
        "from calamity_tpu import models, simulate\n"
        "uvd = simulate.make_golomb_array(nants=4, nfreqs=16)\n"
        "models.yield_pbl_dpss_model_comps(uvd, offset=5.0)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
