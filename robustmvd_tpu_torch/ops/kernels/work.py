"""The kernels' work in a FLOP count, the same whichever route runs.

PyTorch's ``FlopCounterMode`` counts the aten operations a program runs. It
does not see a kernel launched through ctypes, but on the CPU it sees the
plain version that a wrapper runs instead, and counts some of it (K5's
channel contractions are matmuls). So each wrapper states its work by a
formula of its shapes (the ``*_flops`` function beside it, the one that
``chip_smoke.py``'s bounds use) and runs its route, kernel or plain
version, inside :func:`kernel`: while a count is open, that adds the
formula and takes back whatever the mode saw of the route. No wrapper runs
inside another's route. A backward outside the wrappers' routes (K5's and
K3's, in torch ops) is counted by the mode as it runs.
``bench/flops.py::count_flops`` opens a count.
"""

from __future__ import annotations

import contextlib

# the counts open now, innermost last (``open_count``)
_open = []


class Count:
    """One open count: the mode's total, less what it saw inside kernel
    routes (``hidden``), plus each kernel's formula (``by_kernel``)."""

    def __init__(self, mode):
        self.mode = mode
        self.hidden = 0
        self.by_kernel = {}

    def total(self):
        return self.mode.get_total_flops() - self.hidden + sum(self.by_kernel.values())


@contextlib.contextmanager
def open_count(mode):
    """Count the kernels' work into ``mode`` (a ``FlopCounterMode``, entered
    by the caller) for the block; yields the :class:`Count`."""
    count = Count(mode)
    _open.append(count)
    try:
        yield count
    finally:
        _open.remove(count)


@contextlib.contextmanager
def kernel(name, flops):
    """A wrapper's route: where a count is open, its work is ``flops`` and
    nothing the route runs."""
    if not _open:
        yield
        return
    count = _open[-1]
    before = count.mode.get_total_flops()
    yield
    count.hidden += count.mode.get_total_flops() - before
    count.by_kernel[name] = count.by_kernel.get(name, 0) + flops
