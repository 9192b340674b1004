"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors, runs its plain torch
version for CPU tensors, and counts its launches in ``<wrapper>.launches``.
"""

from .planesweep_sample import planesweep_sample, planesweep_sample_reference  # noqa: F401

# every kernel wrapper of the port, for launch accounting and builds
KERNELS = {"planesweep_sample": planesweep_sample}
