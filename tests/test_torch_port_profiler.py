"""The port's profiler (``utils/profiler.py``), the JAX package's
``utils/profiler.py`` in torch, on the CPU: ``time_fn`` returns seconds per
timed call with the burn-in calls excluded, ``trace`` writes a Chrome trace
of the block, ``device_memory_stats`` is {} on the CPU as JAX's is on a
device without statistics, and ``force_fetch`` returns its argument."""

import json
import time

import torch

from robustmvd_tpu.utils import profiler as jax_profiler
from robustmvd_tpu_torch.utils import profiler


def test_time_fn_excludes_the_burn_in():
    calls = []

    def fn(x):
        calls.append(len(calls))
        time.sleep(0.2 if len(calls) <= 2 else 0.01)  # the two burn-in calls are slow
        return x + 1

    seconds = profiler.time_fn(fn, torch.zeros(3), iters=5, burn_in=2)
    assert len(calls) == 7
    assert 0.01 <= seconds < 0.1, seconds


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiler.trace(tmp_path, device="cpu") as prof:
        (x @ x).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(row.key == "aten::mm" for row in prof.key_averages())


def test_device_memory_stats_are_empty_on_the_cpu():
    assert profiler.device_memory_stats("cpu") == {}
    assert jax_profiler.device_memory_stats() == {}  # JAX's CPU device has no statistics either


def test_force_fetch_returns_its_argument():
    out = {"depth": torch.ones(2), "aux": [torch.zeros(1)]}
    assert profiler.force_fetch(out) is out and profiler.force_fetch(3) == 3
