"""The port's bench: the JAX package's ``bench.py``, ``bench_scaling.py`` and
``tools/bench_eval_protocol.py``, run on the card.

    python -m robustmvd_tpu_torch.bench [--device cpu]
    BENCH_ONLY=robust_mvd,vis python -m robustmvd_tpu_torch.bench
    python -m robustmvd_tpu_torch.bench.scaling

- ``workloads.py``: the ten workloads of the JAX bench, each model alone on
  inputs on the device (``inputs.py``), timed by ``timing.py``;
- ``flops.py``: each workload's FLOP count, the same whichever route runs a
  kernel, and the card's peak, for the MFU;
- ``eval_protocol.py``: the five-dataset evaluation protocol at its shapes;
- ``scaling.py``: robust_mvd's forward by device count;
- ``__main__.py``: the suite, one JSON line per workload and JAX's summary
  line last.
"""
