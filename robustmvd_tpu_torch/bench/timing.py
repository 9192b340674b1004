"""The bench's timer: the JAX bench's ``_timeit`` (bench.py:70-83).

One first call and ``burn_in`` more are not timed; then ``iters`` calls are
queued back to back and timed as one span, with one synchronisation at the
end (``utils/profiler.py::time_fn``: CUDA events on a card, the host clock
on the CPU). ``run_iter(i)`` takes the iteration's index, as JAX's does:
0 for the first call, 1..burn_in for the burn-in, 100.. for the timed
calls, so that a workload salts each call's input by its index.
"""

from __future__ import annotations

import itertools

from ..utils.profiler import time_fn


def timeit(run_iter, iters=15, burn_in=3, device=None):
    """Seconds per call of ``run_iter`` over ``iters`` timed calls."""
    calls = itertools.count()

    def call():
        i = next(calls)
        return run_iter(i if i <= burn_in else 100 + i - burn_in - 1)

    return time_fn(call, iters=iters, burn_in=burn_in + 1, device=device)
