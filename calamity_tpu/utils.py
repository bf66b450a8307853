"""Small shared utilities (logging, progress bars, baseline selection,
compile-cache placement).

Parity targets: reference calamity/utils.py (echo, PBARS, select_baselines).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# fixed in-checkout location of JAX's persistent compilation cache when
# JAX_COMPILATION_CACHE_DIR is unset (the path is part of the cache key, so
# it must not move between runs)
DEFAULT_COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def progress(iterable, notebook=False):
    """Progress bar over ``iterable`` (reference PBARS, utils.py:5).

    tqdm is optional: without it the iterable is returned unchanged."""
    try:
        if notebook:
            from tqdm.notebook import tqdm
        else:
            from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable)


def echo(message, verbose=True):
    """Print-if-verbose (reference utils.py:8-10)."""
    if verbose:
        print(message)


def compile_cache_dir():
    """Directory of JAX's persistent compilation cache for this program:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else DEFAULT_COMPILE_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_COMPILE_CACHE_DIR
    )


def configure_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only when it is unset
    does this point the cache at the fixed in-checkout default. Entry points
    (CLI, examples, benchmark, smoke test) call this before compiling."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def rss_gib():
    """Current process resident-set size in GiB (0.0 where unreadable).

    Host-memory telemetry for full-array runs: a 331-ant x 1536-ch x
    8-poltime fit carries several ~10 GiB VisData copies, and the drivers
    log RSS at the stages that historically approached the host limit."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except (OSError, ValueError, IndexError):  # pragma: no cover
        pass
    return 0.0


def select_baselines(
    visdata, bllen_min=0.0, bllen_max=np.inf, bl_ew_min=0.0, ex_ants=None, select_ants=None
):
    """In-place selection by baseline length / EW projection / antenna lists.

    Reference parity: utils.select_baselines (utils.py:13-37). Baseline
    vector is ENU(ant1) - ENU(ant2); the EW cut uses its absolute east
    component, so orientation does not matter."""
    antpos, antnums = visdata.get_ENU_antpos(pick_data_ants=True)
    slot = {int(a): i for i, a in enumerate(antnums.tolist())}
    pairs = np.asarray(visdata.get_antpairs(), dtype=np.int64).reshape(-1, 2)
    if pairs.shape[0] == 0:
        visdata.select(bls=[], inplace=True)
        return
    i0 = np.vectorize(slot.__getitem__)(pairs[:, 0])
    i1 = np.vectorize(slot.__getitem__)(pairs[:, 1])
    blvec = antpos[i0] - antpos[i1]
    bllen = np.linalg.norm(blvec, axis=1)
    keep = (bllen >= bllen_min) & (bllen <= bllen_max)
    if bl_ew_min > 0.0:
        # strict > for a user-set threshold (reference utils.py:30); the
        # default 0.0 must be a NO-OP — the reference's unconditional
        # strict > silently drops every purely north-south baseline
        keep &= np.abs(blvec[:, 0]) > bl_ew_min
    if ex_ants is not None:
        ex = np.asarray(list(ex_ants), dtype=np.int64)
        keep &= ~np.isin(pairs, ex).any(axis=1)
    if select_ants is not None:
        sel = np.asarray(list(select_ants), dtype=np.int64)
        keep &= np.isin(pairs, sel).all(axis=1)
    visdata.select(bls=[tuple(p) for p in pairs[keep]], inplace=True)
