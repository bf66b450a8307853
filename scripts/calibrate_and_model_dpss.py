#!/usr/bin/env python
"""Shell entry point: DPSS-basis calibration + foreground modeling.

Argument-compatible with the reference's script of the same name; parses
the layered dpss_fit_argparser and hands the namespace to the file-level
driver. The installed console script (``calamity_tpu.cli``) does the same.
"""


def main():
    from calamity_tpu.calibration import (
        dpss_fit_argparser,
        read_calibrate_and_model_dpss,
    )
    from calamity_tpu.utils import configure_compile_cache

    args = dpss_fit_argparser().parse_args()
    configure_compile_cache()
    read_calibrate_and_model_dpss(**vars(args))


if __name__ == "__main__":
    main()
