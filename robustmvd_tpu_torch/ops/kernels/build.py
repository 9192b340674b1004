"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``build/robustmvd_tpu_torch/lib<name>.so`` at the root of
the checkout (``/build/`` is git-ignored). A library is rebuilt when its
source is newer. :func:`build` starts one ``nvcc`` per source, all at once,
and waits for all of them. :func:`refuse_gradient` is the guard of the
wrappers whose kernels have no backward.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "robustmvd_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict = {}


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def refuse_gradient(kernel, *tensors):
    """Raise where a forward-only kernel would drop a gradient: grad mode
    is on and one of ``tensors`` requires grad. Inference runs under
    ``torch.no_grad()`` / ``torch.inference_mode()``; the models train through
    their ``warp_impl="xla"`` routes."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} is forward-only and would drop the gradient of its inputs: run it under "
                           "torch.no_grad(), or train through the model's warp_impl='xla' route "
                           "(create_model(..., train=True) takes it)")


def library_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name):
    lib = library_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(names, force=False):
    """Compile the named kernels in parallel; return {name: (seconds, log)}.

    Raises RuntimeError with the compiler's output if any build fails.
    """
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # a name of its own (O_EXCL) for each build: processes that reach a first build at once (the ranks of
        # a mesh on one machine, or on hosts sharing the checkout) each compile and rename a whole library
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".tmp.so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            os.remove(tmp)
            continue
        os.replace(tmp, library_path(name))
        results[name] = (seconds, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def load(name):
    """The ctypes library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
