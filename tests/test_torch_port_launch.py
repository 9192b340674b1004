"""The port's launcher, ``python -m robustmvd_tpu_torch.launch`` (the JAX
package's root ``launch.py``): ``--local N`` children get the environment
contract (``RMVD_TPU_COORDINATOR``, ``RMVD_TPU_NUM_PROCESSES``,
``RMVD_TPU_PROCESS_ID``, ``LOCAL_RANK``); the exit code is 0 only if every
child exits 0, else the first failing child's; ``--timeout`` kills them
(124); ``--devices_per_process`` above 1 is refused. Per-host mode exports
the contract and replaces itself with the command (run as a module in a
subprocess). A group that trains over the contract is
``tests/test_torch_port_parallel.py``'s. The ``--local`` cases call
``main`` in this process; their children run ``python -c``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from robustmvd_tpu_torch.launch import main

ROOT = Path(__file__).resolve().parents[1]
PROBE = """
import os, sys
keys = ("RMVD_TPU_COORDINATOR", "RMVD_TPU_NUM_PROCESSES", "RMVD_TPU_PROCESS_ID", "LOCAL_RANK", "RMVD_TPU_DIST_AUTO")
print(" ".join(f"{k}={os.environ.get(k)}" for k in keys))
sys.exit(3 if os.environ.get("FAIL_RANK") == os.environ["RMVD_TPU_PROCESS_ID"] else 0)
"""


def test_local_children_get_the_contract_and_exit_0(capfd):
    assert main(["--local", "2", "--", "-c", PROBE]) == 0
    lines = [line for line in capfd.readouterr().out.splitlines() if "RMVD_TPU_COORDINATOR=127.0.0.1:" in line]
    assert len(lines) == 2
    for rank, line in enumerate(lines):
        assert line.startswith(f"[proc {rank}] ") and f"RMVD_TPU_PROCESS_ID={rank} LOCAL_RANK={rank}" in line
        assert "RMVD_TPU_NUM_PROCESSES=2" in line and "RMVD_TPU_DIST_AUTO=None" in line


def test_local_returns_a_failing_childs_code(capfd, monkeypatch):
    monkeypatch.setenv("FAIL_RANK", "1")
    assert main(["--local", "2", "--", "-c", PROBE]) == 3
    assert "[launch] process 1 exited 3" in capfd.readouterr().err


def test_local_timeout_kills_the_children(capfd):
    assert main(["--local", "2", "--timeout", "1", "--", "-c", "import time; time.sleep(60)"]) == 124
    assert capfd.readouterr().err.count("killed") == 2


def test_per_host_mode_exports_the_contract_and_execs():
    out = subprocess.run([sys.executable, "-m", "robustmvd_tpu_torch.launch", "--coordinator", "10.0.0.2:29500",
                          "--num_processes", "4", "--process_id", "3", "--", "-c", PROBE], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ("RMVD_TPU_COORDINATOR=10.0.0.2:29500 RMVD_TPU_NUM_PROCESSES=4 "
                                  "RMVD_TPU_PROCESS_ID=3 LOCAL_RANK=None RMVD_TPU_DIST_AUTO=None")


def test_devices_per_process_above_one_is_refused(capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(["--local", "2", "--devices_per_process", "2", "--", "-c", PROBE])
    assert exit_info.value.code == 2 and "devices_per_process" in capsys.readouterr().err


def test_auto_mode_exports_its_flag(monkeypatch):
    calls = []
    monkeypatch.setattr(os, "execvpe", lambda file, args, env: calls.append((file, args, env)))
    main(["--auto", "--", "-m", "robustmvd_tpu_torch.train", "--data_parallel"])
    (file, args, env), = calls
    assert file == sys.executable and args == [sys.executable, "-m", "robustmvd_tpu_torch.train", "--data_parallel"]
    assert env["RMVD_TPU_DIST_AUTO"] == "1" and "RMVD_TPU_COORDINATOR" not in {k for k in env if k not in os.environ}
