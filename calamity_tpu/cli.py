"""Console entry point for the DPSS calibration CLI.

Same behavior as scripts/calibrate_and_model_dpss.py (reference parity:
reference scripts/calibrate_and_model_dpss.py), installable as the
``calibrate_and_model_dpss`` console script.
"""

from __future__ import annotations

from . import calibration
from .utils import configure_compile_cache


def main(argv=None):
    ap = calibration.dpss_fit_argparser()
    args = ap.parse_args(argv)
    configure_compile_cache()
    calibration.read_calibrate_and_model_dpss(**vars(args))


if __name__ == "__main__":  # pragma: no cover
    main()
