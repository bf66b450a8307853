"""Test configuration: force CPU jax with 8 virtual devices before import.

Multi-device sharding tests run against a virtual 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), mirroring the
driver's dryrun_multichip validation. x64 is enabled because the f64
paths (basis generation parity, precision=64) are exercised in tests;
solver code is dtype-explicit so f32 paths stay f32.
"""

import os

# force CPU: the unit tests run on the local virtual-device CPU backend even
# on a machine with a GPU (GPU runs go through chip_smoke.py); the platform
# is pinned in the environment and at the jax-config level before any
# backend is initialized
os.environ["JAX_PLATFORMS"] = "cpu"
# the sharding tests REQUIRE exactly 8 virtual devices: rewrite any
# preexisting device-count flag rather than keeping a foreign value (a
# shell tuned for another project would otherwise fail every mesh test
# with an opaque device-count error)
import re as _re  # noqa: E402

_flags = os.environ.get("XLA_FLAGS", "")
_flags = _re.sub(r"--xla_force_host_platform_device_count=\d+", "", _flags)
os.environ["XLA_FLAGS"] = (
    _flags.strip() + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from calamity_tpu import simulate  # noqa: E402


@pytest.fixture(scope="session")
def golomb_visdata():
    """6-ant Golomb array, 200 channels, single time, no autos."""
    return simulate.make_golomb_array(nants=6, nfreqs=200, seed=0)


@pytest.fixture()
def sky_model(golomb_visdata):
    return golomb_visdata.copy()


@pytest.fixture(scope="session")
def redundant_visdata():
    """3-ant Golomb array duplicated (redundant pairs), with autos."""
    return simulate.make_redundant_array(include_autos=True, seed=5)


@pytest.fixture()
def sky_model_redundant(redundant_visdata):
    uvd = redundant_visdata.copy()
    uvd.select(bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]], inplace=True)
    return uvd


@pytest.fixture()
def noise_with_flags():
    return simulate.make_noise_with_rfi_flags()


def zero_plateau_fit_args():
    """A deterministic patience scenario: a fit with zero data and zero
    coefficient start has loss exactly 0 every step — never a new strict
    minimum, so patience fires after exactly `patience` recorded steps.
    Shared by the serial (test_checkpoint) and batched (test_parallel)
    patience tests so they exercise the same scenario."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    nants, nfreqs, ngrps, nvecs = 4, 32, 6, 4
    comps = jnp.asarray(rng.standard_normal((ngrps, 1, nfreqs, nvecs)))
    a0 = jnp.asarray([[0], [0], [0], [1], [1], [2]], dtype=np.int32)
    a1 = jnp.asarray([[1], [2], [3], [2], [3], [3]], dtype=np.int32)
    chunks = ((comps, a0, a1),)
    shape = (ngrps, 1, nfreqs)
    data_r = (jnp.zeros(shape),)
    data_i = (jnp.zeros(shape),)
    wgts = (jnp.full(shape, 1.0 / (ngrps * nfreqs)),)
    g_r = jnp.ones((nants, nfreqs))
    g_i = jnp.zeros((nants, nfreqs))
    fg = (jnp.zeros((ngrps, nvecs)),)
    return chunks, data_r, data_i, wgts, g_r, g_i, fg
