"""Polarization string <-> AIPS integer conventions.

Standalone reimplementation of the polarization-identifier handling that the
reference delegates to ``pyuvdata.utils.polstr2num`` / ``polnum2str``
(used at e.g. reference calibration.py:294, 338, 395). pyuvdata is not a
dependency of this framework; this module provides the small subset of the
convention the calibration stack needs.

AIPS / casacore linear-polarization integers:
    -5: XX   -6: YY   -7: XY   -8: YX
Circular:
    -1: RR   -2: LL   -3: RL   -4: LR
Pseudo-Stokes:
     1: pI    2: pQ    3: pU    4: pV
Jones terms use the same integers with a ``J`` prefix ("Jxx" -> -5).

When ``x_orientation`` is set, physical feed names may be used:
    x_orientation="east":  e->x, n->y  (so "ee" == "xx" == -5)
    x_orientation="north": n->x, e->y  (so "nn" == "xx" == -5)
"""

from __future__ import annotations

POL_STR2NUM = {
    "pI": 1,
    "pQ": 2,
    "pU": 3,
    "pV": 4,
    "I": 1,
    "Q": 2,
    "U": 3,
    "V": 4,
    "rr": -1,
    "ll": -2,
    "rl": -3,
    "lr": -4,
    "xx": -5,
    "yy": -6,
    "xy": -7,
    "yx": -8,
}

POL_NUM2STR = {
    1: "pI",
    2: "pQ",
    3: "pU",
    4: "pV",
    -1: "rr",
    -2: "ll",
    -3: "rl",
    -4: "lr",
    -5: "xx",
    -6: "yy",
    -7: "xy",
    -8: "yx",
}


def _feed_map(x_orientation):
    """Map physical feed letters to x/y given an x_orientation."""
    if x_orientation is None:
        return None
    xo = str(x_orientation).lower()
    if xo.startswith("east") or xo == "e":
        return {"e": "x", "n": "y"}
    if xo.startswith("north") or xo == "n":
        return {"n": "x", "e": "y"}
    return None


def polstr2num(pol, x_orientation=None):
    """Convert a polarization string to its AIPS integer.

    Accepts canonical names ("xx", "rr", "pI") and, when ``x_orientation``
    is provided, physical feed names ("ee", "nn", ...).
    """
    if isinstance(pol, (int,)):
        return int(pol)
    key = str(pol)
    if key in POL_STR2NUM:
        return POL_STR2NUM[key]
    lower = key.lower()
    if lower in POL_STR2NUM:
        return POL_STR2NUM[lower]
    fmap = _feed_map(x_orientation)
    if fmap is not None and len(lower) == 2:
        translated = "".join(fmap.get(c, c) for c in lower)
        if translated in POL_STR2NUM:
            return POL_STR2NUM[translated]
    raise KeyError(f"Polarization {pol!r} not recognized.")


def polnum2str(num, x_orientation=None):
    """Convert an AIPS polarization integer to a string.

    With ``x_orientation`` set, linear pols are rendered with physical feed
    names (mirrors pyuvdata behavior relied on by reference get_pols()).
    """
    num = int(num)
    base = POL_NUM2STR[num]
    fmap = _feed_map(x_orientation)
    if fmap is not None and base[0] in ("x", "y"):
        inv = {v: k for k, v in fmap.items()}
        return "".join(inv.get(c, c) for c in base)
    return base


# conjugating a visibility swaps the feed order: xy <-> yx, rl <-> lr;
# parallel-hand and pseudo-Stokes pols are their own conjugates
_CONJ_POL = {-7: -8, -8: -7, -3: -4, -4: -3}


def conj_pol(pol, x_orientation=None):
    """Polarization of the conjugated visibility (pyuvdata conj_pol parity).

    Accepts an AIPS integer or a string; returns the same type.
    """
    if not isinstance(pol, str):
        num = int(pol)
        return _CONJ_POL.get(num, num)
    num = polstr2num(pol, x_orientation=x_orientation)
    return polnum2str(_CONJ_POL.get(num, num), x_orientation=x_orientation)


def jstr2num(jones, x_orientation=None):
    """Convert a Jones string ("Jxx", "Jee") to its integer."""
    if isinstance(jones, int):
        return int(jones)
    key = str(jones)
    if key.lower().startswith("j"):
        key = key[1:]
    return polstr2num(key, x_orientation=x_orientation)


def conj_pol_ind(polarization_array, polnum):
    """Column index of the conjugate polarization of AIPS number ``polnum``
    in ``polarization_array`` — equals the direct index for parallel-hand
    pols (their conjugate is themselves), -1 if the conjugate is absent.

    Shared by VisData._conj_pol_ind and FitSpec (which also applies it to
    FlagWeights objects)."""
    import numpy as np

    cnum = conj_pol(polnum)
    matches = np.nonzero(np.asarray(polarization_array) == cnum)[0]
    return int(matches[0]) if len(matches) else -1
