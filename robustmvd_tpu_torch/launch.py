"""Multi-process launcher (the JAX package's root ``launch.py``):

    python -m robustmvd_tpu_torch.launch <mode> -- <python arguments ...>

It runs ``python <python arguments>`` (a script with its arguments, or ``-m
module ...``, or ``-c code``) with the environment contract that
``parallel.init_distributed_from_env`` reads: ``RMVD_TPU_COORDINATOR``
(host:port of rank 0's TCP rendezvous), ``RMVD_TPU_NUM_PROCESSES``,
``RMVD_TPU_PROCESS_ID`` and ``LOCAL_RANK`` (the card of the process).

Modes
-----
Per host (one launcher per host, each with its process id)::

    python -m robustmvd_tpu_torch.launch --coordinator 10.0.0.2:29500 --num_processes 2 \\
        --process_id $HOST_ID -- -m robustmvd_tpu_torch.train --data_parallel ...

``--auto`` exports ``RMVD_TPU_DIST_AUTO=1`` instead, for a scheduler that sets
torch's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (as
``torchrun`` does). Both replace the launcher's process with the command.

On this machine (``--local N``): N children with ranks 0..N-1 and a
rendezvous on a free local port; where cards are visible each child drives
card ``LOCAL_RANK`` = its rank (NCCL), else the CPU (gloo)::

    python -m robustmvd_tpu_torch.launch --local 2 -- -m robustmvd_tpu_torch.train --data_parallel ...

The children's output is collected in temporary files and printed with a
``[proc i]`` prefix when they end; the exit code is 0 only if every child
exits 0, and ``--timeout`` kills them all (exit code 124). The JAX
launcher's ``--devices_per_process`` (virtual XLA devices) has no torch
counterpart: a process drives one device, and values above 1 are refused.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port():
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local(args, command):
    """Spawn ``--local N`` children and wait for them; their exit code."""
    import torch

    cards = torch.cuda.device_count()
    if cards and args.local > cards:
        print(f"[launch] --local {args.local} needs one card per process; {cards} visible", file=sys.stderr)
        return 2
    coordinator = f"127.0.0.1:{free_port()}"
    # files, not pipes: a child that filled a pipe nobody reads would block inside a collective and stall the
    # whole group
    procs, logs = [], []
    for rank in range(args.local):
        env = dict(os.environ, RMVD_TPU_COORDINATOR=coordinator, RMVD_TPU_NUM_PROCESSES=str(args.local),
                   RMVD_TPU_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
        log = tempfile.TemporaryFile()
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *command], env=env, stdout=log, stderr=subprocess.STDOUT))

    rc = 0
    deadline = time.monotonic() + args.timeout
    while not rc:  # until every child has ended, one has failed (the others would wait for it), or the deadline
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            rc = failed[0] if failed[0] > 0 else 128 - failed[0]  # a signal n as a shell reports it, 128 + n
        elif all(c is not None for c in codes):
            break
        elif time.monotonic() > deadline:
            print(f"[launch] timed out after {args.timeout} s; killing every process", file=sys.stderr)
            rc = 124
        else:
            time.sleep(0.05)
    ended = [p.poll() for p in procs]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for rank, (p, log, code) in enumerate(zip(procs, logs, ended)):
        log.seek(0)
        out = log.read().decode(errors="replace")
        log.close()
        sys.stdout.write("".join(f"[proc {rank}] {line}\n" for line in out.splitlines()))
        if code is None:
            print(f"[launch] process {rank} killed", file=sys.stderr)
        elif code != 0:
            print(f"[launch] process {rank} exited {code}", file=sys.stderr)
    sys.stdout.flush()
    return rc


def run_per_host(args, command):
    """Export the contract and replace this process with the command."""
    env = dict(os.environ)
    if args.auto:
        env["RMVD_TPU_DIST_AUTO"] = "1"
    else:
        env.update(RMVD_TPU_COORDINATOR=args.coordinator, RMVD_TPU_NUM_PROCESSES=str(args.num_processes),
                   RMVD_TPU_PROCESS_ID=str(args.process_id))
    os.execvpe(sys.executable, [sys.executable, *command], env)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m robustmvd_tpu_torch.launch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--local", type=int, metavar="N", help="spawn N processes on this machine")
    mode.add_argument("--coordinator", metavar="HOST:PORT", help="rank 0's rendezvous address (per-host mode)")
    mode.add_argument("--auto", action="store_true", help="torch's env:// variables, set by the scheduler")
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--devices_per_process", type=int, default=1,
                        help="only 1: a process drives one device (the JAX launcher's virtual devices)")
    parser.add_argument("--timeout", type=float, default=1800.0, help="--local: seconds before the children "
                                                                      "are killed")
    parser.add_argument("command", nargs=argparse.REMAINDER, help="-- python arguments (script.py ... or -m ...)")
    args = parser.parse_args(argv)

    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no command given (usage: python -m robustmvd_tpu_torch.launch <mode> -- script.py ...)")
    if args.devices_per_process != 1:
        parser.error("--devices_per_process: a torch process drives one device; start one process per device")
    if args.local is not None:
        if args.local < 1:
            parser.error("--local needs N >= 1")
        return run_local(args, command)
    return run_per_host(args, command)


if __name__ == "__main__":
    sys.exit(main())
