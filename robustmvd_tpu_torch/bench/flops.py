"""A workload's FLOP count and the card's peak, for the bench's MFU.

The JAX bench takes its FLOPs from XLA's cost analysis and divides by a
table of TPU peaks (bench.py:41-67). PyTorch has no cost analysis, so the
port counts one untimed call: ``torch.utils.flop_counter.FlopCounterMode``
counts the aten operations (matmuls and convolutions, forward and
backward), and each kernel wrapper adds its own work by formula and keeps
its route out of the count (``ops/kernels/work.py``), so that the count of
the same shapes is the same on the CPU (plain versions) and on the card
(kernels). Elementwise work is not counted on either side (XLA's cost
analysis counts it), so the port's MFU is that of its matmuls,
convolutions and kernels.
"""

from __future__ import annotations

from ..ops.kernels import work

# dense bf16 tensor-core FLOP/s of one card by a substring of
# torch.cuda.get_device_name() (NVIDIA's data sheet, no sparsity). Every
# workload's MFU is against this peak, the float32 ones too (their entries
# say so).
PEAK_FLOPS = (("H100 80GB HBM3", 989.4e12),)  # the H100 SXM


def peak_flops(device_kind):
    """The card's peak from :data:`PEAK_FLOPS`, or None for another name."""
    for sub, peak in PEAK_FLOPS:
        if sub in device_kind:
            return peak
    return None


def count_flops(fn, *args):
    """The FLOPs of one call ``fn(*args)`` and each kernel's share of them:
    (total, {kernel source name: flops})."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with work.open_count(mode) as count, mode:
        fn(*args)
    return count.total(), dict(count.by_kernel)
