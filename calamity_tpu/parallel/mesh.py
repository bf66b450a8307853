"""Device mesh construction and sharding layouts.

The reference's entire distribution story is single-GPU placement
(tf.config.set_visible_devices, reference calibration.py:1741-1753). Here
scaling is first-class (SURVEY.md §2.8, §7): a 2-D logical mesh

    ('data', 'bl')

where 'data' shards the embarrassingly-parallel (time x pol) fit batch and
'bl' shards baseline chunks across devices. Placement rules:

    gains   (nbatch, nants, nfreqs)        -> P('data', None, None)  [replicated over bl]
    coeffs  (nbatch, ngrps, nvecs)         -> P('data', 'bl', None)
    comps   (ngrps, nbls, nfreqs, nvecs)   -> P('bl', None, None, None)
    data/wgts (nbatch, ngrps, nbls, nfreqs)-> P('data', 'bl', None, None)

The scalar loss sums over sharded axes, so XLA inserts the psum for the
loss/grad reduction over 'bl' and the gain-gradient all-reduce, which XLA
hands to NCCL over NVLink on GPUs — no hand-written collectives needed.
Every GPU of a host reaches every other at the same rate, so the mesh
shape follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data=None, n_bl=None, devices=None):
    """Build a ('data', 'bl') mesh over the available devices.

    Default factorization puts as many devices as possible on 'bl' (the
    large axis for HERA-scale fits) and the rest on 'data'."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_data is None and n_bl is None:
        n_bl = n
        n_data = 1
    elif n_data is None:
        n_data = n // n_bl
    elif n_bl is None:
        n_bl = n // n_data
    if n_data * n_bl != n:
        raise ValueError(f"mesh {n_data}x{n_bl} != {n} devices")
    dev_array = np.asarray(devices).reshape(n_data, n_bl)
    return Mesh(dev_array, axis_names=("data", "bl"))


def fit_shardings(mesh):
    """NamedShardings for the batched fit state (see module docstring)."""
    return {
        "gains": NamedSharding(mesh, P("data", None, None)),
        "coeffs": NamedSharding(mesh, P("data", "bl", None)),
        "comps": NamedSharding(mesh, P("bl", None, None, None)),
        "ants": NamedSharding(mesh, P("bl", None)),
        "data": NamedSharding(mesh, P("data", "bl", None, None)),
        "scalar": NamedSharding(mesh, P()),
    }


def shard_chunk(mesh, chunk, data_r, data_i, wgts):
    """device_put one chunk's static tensors + batched data onto the mesh.

    Handles the package's chunk layouts: a plain-shared operator matrix
    (comps group dim 1) is replicated rather than sharded over 'bl', and
    non-divisible group/batch axes raise a clear error — the driver
    (`calibrate_and_model_tensor(time_parallel=True, mesh=...)`) pads both
    axes to mesh multiples before calling device_put; use it (or pad the
    same way) rather than sharding ragged chunks directly."""
    sh = fit_shardings(mesh)
    n_bl = mesh.shape["bl"]
    n_data = mesh.shape["data"]
    comps, a0, a1 = chunk[0], chunk[1], chunk[2]
    ngrps = a0.shape[0]
    if ngrps % n_bl or data_r.shape[0] % n_data:
        raise ValueError(
            f"chunk group axis ({ngrps}) and batch axis ({data_r.shape[0]}) "
            f"must be multiples of the mesh ({n_data}x{n_bl}); pad with "
            "zero-weight entries as _calibrate_time_parallel does, or call "
            "the driver with time_parallel=True, mesh=..."
        )
    if comps.shape[0] == 1:
        # plain-shared operator: one matrix serves every group — replicate
        comps = jax.device_put(
            comps, NamedSharding(mesh, P(None, None, None, None))
        )
    elif comps.shape[0] % n_bl:
        raise ValueError(
            f"comps leading axis ({comps.shape[0]}) must be 1 (shared) or a "
            f"multiple of n_bl={n_bl} (dense / shared-batched class axis)"
        )
    else:
        comps = jax.device_put(comps, sh["comps"])
    a0 = jax.device_put(a0, sh["ants"])
    a1 = jax.device_put(a1, sh["ants"])
    data_r = jax.device_put(data_r, sh["data"])
    data_i = jax.device_put(data_i, sh["data"])
    wgts = jax.device_put(wgts, sh["data"])
    return (comps, a0, a1), data_r, data_i, wgts
