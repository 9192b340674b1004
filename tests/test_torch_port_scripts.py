"""The port's data scripts and ``run_conf`` vs the JAX package's.

- Each converter of ``robustmvd_tpu_torch/data/scripts/`` runs as a script
  (its ``__main__``, through ``runpy``) on a raw download tree of
  ``tests/test_conversion_scripts.py`` / ``test_dataset_fixtures.py``, and
  the JAX package's script on the same tree: the output trees hold the same
  paths, symlinks to the same targets and files equal byte for byte.
  ``make_sample_data`` likewise.
- ``python -m robustmvd_tpu_torch.run_conf`` against the root ``run_conf.py``
  on yaml files of ``echo`` / ``false`` commands: the same output (run ids
  aside), the same substitutions and order, the same exit code.
- The port's two run configurations parse, name only the port's entry
  points, and each command's arguments are taken by that entry point's own
  parser (nothing is run).
"""

import os
import re
import runpy
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from test_conversion_scripts import _make_raw_dtu
from test_dataset_fixtures import _synthesize_sens, _write_pfm

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("robustmvd_tpu", "robustmvd_tpu_torch")


def raw_staticthings3d(tmp_path, rng):
    """The raw StaticThings3D layout of ``test_convert_staticthings3d_end_to_end``
    with both passes, poses and per-camera frames."""
    raw = tmp_path / "raw"
    for dtype, ext, cams in [("frames_cleanpass", "png", True), ("frames_finalpass", "png", True),
                             ("depths", "float3", True), ("poses", "float3", True), ("intrinsics", "float3", False)]:
        for cam in ["left", "right"] if cams else [None]:
            d = raw / dtype / "TRAIN" / "A" / "0000"
            d = d / cam if cam else d
            os.makedirs(d, exist_ok=True)
            for frame in (6, 7):
                (d / f"{frame:04d}.{ext}").write_bytes(rng.bytes(16))
    return raw


def raw_flyingthings3d(tmp_path, rng):
    """The raw FlyingThings3D layout of ``test_convert_flyingthings3d_end_to_end``
    (frames, disparities, a rig that moves and turns)."""
    raw = tmp_path / "raw"
    for cam in ("left", "right"):
        d = raw / "frames_cleanpass" / "TRAIN" / "A" / "0000" / cam
        os.makedirs(d, exist_ok=True)
        for frame in (6, 7, 8):
            (d / f"{frame:04d}.png").write_bytes(rng.bytes(16))
        d = raw / "disparity" / "TRAIN" / "A" / "0000" / cam
        for frame in (6, 7, 8):
            _write_pfm(str(d / f"{frame:04d}.pfm"), rng.rand(8, 12).astype(np.float32))
    cam_dir = raw / "camera_data" / "TRAIN" / "A" / "0000"
    os.makedirs(cam_dir, exist_ok=True)
    lines = []
    for i, frame in enumerate((6, 7, 8)):
        pose = np.eye(4)
        angle = 0.1 * i
        pose[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
        pose[:3, 3] = rng.randn(3)
        lines += [f"Frame {frame}", "L " + " ".join(str(v) for v in pose.reshape(-1)),
                  "R " + " ".join(str(v) for v in pose.reshape(-1)), ""]
    (cam_dir / "camera_data.txt").write_text("\n".join(lines) + "\n")
    return raw


def raw_scannet(tmp_path, rng):
    raw = tmp_path / "raw"
    os.makedirs(raw / "scans" / "scene0000_00")
    _synthesize_sens(str(raw / "scans" / "scene0000_00" / "scene0000_00.sens"), frames=2, rng=rng)
    return raw


def raw_dtu(tmp_path, rng):
    return _make_raw_dtu(tmp_path, rng, lights=tuple(range(7)))[0]


CONVERTERS = {
    "convert_dtu": (raw_dtu, []),
    "convert_dtu_mvsnet": (raw_dtu, []),
    "convert_staticthings3d": (raw_staticthings3d, []),
    "convert_flyingthings3d": (raw_flyingthings3d, []),
    "convert_scannet": (raw_scannet, ["--all_scenes"]),
}


def run_script(package, name, args, monkeypatch):
    """The script's ``__main__`` in this process, as ``python -m`` runs it."""
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [name, *args])
        runpy.run_module(f"{package}.data.scripts.{name}", run_name="__main__")


def tree(root):
    """{relative path: ("link", target) or ("file", bytes)} of every entry below ``root``."""
    out = {}
    for d, dirs, files in os.walk(root):
        for entry in dirs + files:
            path = os.path.join(d, entry)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            elif os.path.isfile(path):
                with open(path, "rb") as f:
                    out[rel] = ("file", f.read())
            else:
                out[rel] = ("dir", None)
    return out


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_writes_the_jax_scripts_tree(tmp_path, monkeypatch, name):
    make_raw, flags = CONVERTERS[name]
    raw = make_raw(tmp_path, np.random.RandomState(3))
    trees = {}
    for package in PACKAGES:
        out = tmp_path / package
        run_script(package, name, [str(raw), str(out), *flags], monkeypatch)
        trees[package] = tree(out)
    ours, ref = trees["robustmvd_tpu_torch"], trees["robustmvd_tpu"]
    assert sum(kind != "dir" for kind, _ in ref.values()) >= 4
    assert ours.keys() == ref.keys()
    for path, entry in ref.items():
        assert ours[path] == entry, path


def test_make_sample_data_writes_the_jax_scripts_tree(tmp_path):
    trees = {}
    for package in PACKAGES:
        main = runpy.run_module(f"{package}.data.scripts.make_sample_data")["main"]
        main(str(tmp_path / package), height=64, width=96)
        trees[package] = tree(tmp_path / package)
    assert len(trees["robustmvd_tpu"]) == 18  # key/, source/{1,2,3}/ with 3 files each, the GT depth
    assert trees["robustmvd_tpu_torch"] == trees["robustmvd_tpu"]


def run_conf(package, conf, out_base):
    cmd = ([sys.executable, "run_conf.py"] if package == "robustmvd_tpu"
           else [sys.executable, "-m", "robustmvd_tpu_torch.run_conf"])
    # unbuffered: the launcher's lines and its commands' output interleave in the order they happen
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, PYTHONUNBUFFERED="1")
    result = subprocess.run(cmd + [str(conf), "--output_base", str(out_base)], cwd=ROOT, env=env,
                            capture_output=True, text=True, timeout=120)
    run_id = re.search(r"\((\d{8}-\d{6})\)", result.stdout).group(1)
    normalised = result.stdout.replace(run_id, "RUNID").replace(str(out_base), "OUT")
    return result.returncode, normalised, result.stderr


CONFS = {
    # a failing run command ends the launcher with its code; later commands and runs do not run
    "run_fails": {"meta": {"run_name": "demo", "comment": "a comment"}, "runs": [
        {"pre_commands": ["echo pre %RUNID%"],
         "run_commands": ["echo log %LOGDIR% id %RUNID% note %COMMENT%", "exit 3", "echo never"]},
        {"run_commands": ["echo never either"]}]},
    # a failing pre-command raises (exit code 1)
    "pre_fails": {"meta": {"comment": "c"}, "runs": [{"pre_commands": ["false"], "run_commands": ["echo never"]}]},
    "all_pass": {"meta": {"run_name": "ok"}, "runs": [{"run_commands": ["echo one %COMMENT%"]},
                                                      {"run_commands": ["echo two", "true"]}]},
}


@pytest.mark.parametrize("case", list(CONFS))
def test_run_conf_matches_the_jax_launcher(tmp_path, case):
    conf = tmp_path / f"{case}.yaml"
    conf.write_text(yaml.safe_dump(CONFS[case]))
    results = {package: run_conf(package, conf, tmp_path / package) for package in PACKAGES}
    (code, out, err), (ref_code, ref_out, ref_err) = results["robustmvd_tpu_torch"], results["robustmvd_tpu"]
    assert code == ref_code == {"run_fails": 3, "pre_fails": 1, "all_pass": 0}[case], (err, ref_err)
    assert out == ref_out
    assert "never" not in out
    if case == "run_fails":
        assert "log OUT/demo/RUNID id RUNID note a comment" in out
        assert out.index("[pre] echo pre RUNID") < out.index("[run] echo log") < out.index("[run] exit 3")


def entry_point_args(command):
    """(module, arguments) of a ``python -m <module> ...`` command; through the
    launcher, the launched one's."""
    import robustmvd_tpu_torch.launch as launch

    tokens = shlex.split(command)
    assert tokens[:2] == ["python", "-m"], command
    module, args = tokens[2], tokens[3:]
    if module == "robustmvd_tpu_torch.launch":
        child = launch.parse_args(args).command
        assert child[0] == "-m", command
        module, args = child[1], child[2:]
    return module, args


@pytest.mark.parametrize("name", ["robust_mvd", "mvsnet"])
def test_port_run_confs_name_the_ports_entry_points(name):
    from robustmvd_tpu_torch.eval.cli import parse_args as eval_args
    from robustmvd_tpu_torch.train.cli import parse_args as train_args

    conf = yaml.safe_load((ROOT / "robustmvd_tpu_torch" / "run_confs" / f"{name}.yaml").read_text())
    assert conf["meta"]["run_name"] == name
    commands = [c for run in conf["runs"] for c in run.get("pre_commands", []) + run["run_commands"]]
    parsers = {"robustmvd_tpu_torch.train": train_args, "robustmvd_tpu_torch.eval": eval_args}
    modules = []
    for command in commands:
        module, args = entry_point_args(command.replace("%LOGDIR%", "/tmp/log"))
        parsed = parsers[module](args)
        modules.append(module)
        if module == "robustmvd_tpu_torch.train":
            assert parsed.training_type == "mvd" and parsed.seed == 42
        if parsed.weights is not None:
            assert parsed.weights.endswith(".pt")
    assert modules[0] == "robustmvd_tpu_torch.train"
    if name == "robust_mvd":
        parsed = train_args(entry_point_args(commands[0])[1])
        assert parsed.dataset == ["staticthings3d.robust_mvd.mvd", "blendedmvs.robust_mvd.mvd"]
        assert parsed.augmentations_per_dataset == ["robust_mvd_augmentations_staticthings3d",
                                                    "robust_mvd_augmentations_blendedmvs"]
        assert parsed.data_parallel and modules == ["robustmvd_tpu_torch.train", "robustmvd_tpu_torch.eval"]
