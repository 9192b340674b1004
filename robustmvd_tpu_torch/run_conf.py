"""Run-configuration launcher (the JAX package's root ``run_conf.py``):

    python -m robustmvd_tpu_torch.run_conf robustmvd_tpu_torch/run_confs/robust_mvd.yaml [--output_base DIR]

The reference replays experiments through an external Torque/SSH job tool
consuming ``run_confs/*.yaml`` (run_confs/robust_mvd.yaml). This launcher
executes the same YAML format on the machine it runs on: each run's
``pre_commands`` and then its ``run_commands`` execute one after another in a
shell, with ``%LOGDIR%`` (``<output_base>/<run_name>/<run id>``), ``%RUNID%``
(the start time, ``%Y%m%d-%H%M%S``) and ``%COMMENT%`` (``meta.comment``)
substituted. A failing run command ends the launcher with its exit code; a
failing pre-command raises. The port's recipes are
``robustmvd_tpu_torch/run_confs/{robust_mvd,mvsnet}.yaml``; a multi-process
run goes through ``python -m robustmvd_tpu_torch.launch`` inside a command.
"""

import argparse
import os
import os.path as osp
import subprocess
import sys
import time

import yaml


def main(args):
    with open(args.conf) as f:
        conf = yaml.safe_load(f)

    meta = conf.get("meta", {})
    run_name = meta.get("run_name", osp.splitext(osp.basename(args.conf))[0])
    comment = meta.get("comment", "")
    out_base = args.output_base or meta.get("output_base_path", "./experiments")

    run_id = time.strftime("%Y%m%d-%H%M%S")
    log_dir = osp.join(out_base, run_name, run_id)
    os.makedirs(log_dir, exist_ok=True)
    print(f"Run {run_name} ({run_id}) -> {log_dir}")

    for run in conf.get("runs", []):
        for cmd in run.get("pre_commands", []) or []:
            cmd = _substitute(cmd, log_dir, run_id, comment)
            print(f"[pre] {cmd}")
            subprocess.run(cmd, shell=True, check=True)
        for cmd in run.get("run_commands", []) or []:
            cmd = _substitute(cmd, log_dir, run_id, comment)
            print(f"[run] {cmd}")
            result = subprocess.run(cmd, shell=True)
            if result.returncode != 0:
                print(f"Command failed with code {result.returncode}")
                sys.exit(result.returncode)

    print("All runs finished.")


def _substitute(cmd, log_dir, run_id, comment):
    return cmd.replace("%LOGDIR%", log_dir).replace("%RUNID%", run_id).replace("%COMMENT%", comment)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m robustmvd_tpu_torch.run_conf")
    parser.add_argument("conf", help="Path to a run_confs/*.yaml file.")
    parser.add_argument("--output_base", help="Override the output base path.")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
