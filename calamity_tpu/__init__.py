"""calamity_tpu: redundancy-free interferometric self-calibration in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
CALAMITY package (simultaneous per-antenna gain calibration and
smooth-basis foreground modeling for 21 cm interferometers), built for
accelerators: dense padded tensors, jit-compiled optimization loops with
on-device convergence checks, and sharding over device meshes. Its target
device is an NVIDIA GPU.
"""

from . import version

__version__ = version.version
