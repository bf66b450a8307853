"""CPU tests of chip_smoke.py: the device gate, the main-path and mesh
phases at tiny sizes, and the script's refusal to run without a GPU.

The phases' device numbers come only from GPU runs; here they run on the
virtual CPU devices of conftest.py to check control flow and checks."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load_smoke()


def test_require_gpu_refuses_cpu_platform(smoke):
    with pytest.raises(smoke.SmokeFailure, match="not \\['gpu'\\]"):
        smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("count,ok", [(None, True), (2, True), (4, False)])
def test_require_gpu_device_count(smoke, count, ok):
    gpus = [SimpleNamespace(platform="gpu", device_kind="fake")] * 2
    if ok:
        assert smoke.require_gpu(gpus, count=count) is gpus[0]
    else:
        with pytest.raises(smoke.SmokeFailure, match="need 4 GPUs"):
            smoke.require_gpu(gpus, count=count)


def _run_script(cwd, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path),
               PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            continue
    return False


def test_script_fails_without_gpu(tmp_path):
    res = _run_script(ROOT, tmp_path)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "gpu" in res.stderr


def test_script_fails_without_the_package(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    res = _run_script(alone, tmp_path)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)


def test_gain_error_ignores_per_channel_phase_and_scale(smoke):
    rng = np.random.default_rng(0)
    shape = (7, 1, 16, 2, 1)
    truth = 1 + 0.03 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    phase = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(1, 1, 16, 2, 1)))
    assert np.all(smoke.gain_error(1.7 * phase * truth, truth) < 1e-12)
    noisy = truth * (1 + 0.01 * rng.standard_normal(shape))
    err = smoke.gain_error(noisy, truth)
    assert err.shape == (2,) and np.all((err > 3e-3) & (err < 3e-2))


def test_step_bytes(smoke):
    # two basis reads + five (ngrps, nbls, nfreqs) float32 cubes
    assert smoke.step_bytes(2, 1, 3, 4, 2) == 2 * 2 * 3 * 4 * 2 + 5 * 2 * 3 * 4


def test_main_path_tiny(smoke):
    # 128 channels leave a larger share of the truth's random gain errors
    # inside the smooth DPSS span than 1536 do, hence the looser gain bound
    res = smoke.main_path(nside=3, nfreqs=128, ntimes=2, maxsteps=2000,
                          patience=300, tol=1e-11, gain_tol=2e-2)
    assert res["suppression"] >= smoke.SUPPRESSION_MIN
    assert len(res["nsteps"]) == 2
    assert {"select_s", "descent_s", "writeback_s"} <= set(res["timings"])


def test_mesh_vs_single_tiny(smoke):
    res = smoke.mesh_vs_single(nside=3, nfreqs=64, ntimes=8, maxsteps=50,
                               patience=0, tol=0.0)
    assert res["loss_err"].shape == (8,)
    assert res["gain_err"] <= smoke.FOUR_GAIN_RTOL
