"""The port stands alone: no JAX, no flax, nothing of robustmvd_tpu.

- Importing ``robustmvd_tpu_torch`` and running each model on the CPU, in a
  fresh interpreter, loads none of them: each model at its defaults, then
  the family on the K4 and K5 paths (``ops/kernels/warp_volume.py``,
  ``ops/kernels/conv3d.py``, ``ops/conv3d.py``) and vis_mvsnet on cuDNN's
  convolutions, and robust_mvd at bf16; then a benchmark sample list and
  DTU's MVSNet training list (pickled with the JAX package's class paths),
  ``synthetic``, an evaluation of robust_mvd, the augmentation presets and
  a training run of robust_mvd at bf16 (the train CLI), and the seven
  wrapped models on stub repositories (``wrapper_stubs.py``); in a second
  interpreter, a training run of vis_mvsnet (the train CLI) and one step of
  mvsnet_train and cvp_mvsnet with their losses; in a third, the event
  writer (events.jsonl and TensorBoard), the profiler, the viewer's PNG
  export, the launcher's module and ``parallel/``, and a training run of
  robust_mvd through the train CLI with ``--data_parallel`` (a gloo group of
  one process, ``DistributedDataParallel``).
- No source file of the package, nor ``chip_smoke.py``, imports them or
  names them in a string (``importlib`` style).
- Entry points default to the card and raise, naming ``device='cpu'``,
  where there is none.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import robustmvd_tpu_torch
from robustmvd_tpu_torch.eval.cli import main as eval_main
from robustmvd_tpu_torch.eval.cli import parse_args as eval_parse_args
from robustmvd_tpu_torch.inference import parse_args
from robustmvd_tpu_torch.train.cli import main as train_main
from robustmvd_tpu_torch.train.cli import parse_args as train_parse_args

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "robustmvd_tpu")


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_running_the_port_loads_no_jax(tmp_path):
    code = """
import sys
import numpy as np
import robustmvd_tpu_torch as r
rng = np.random.RandomState(0)
images = [rng.rand(3, 64, 64).astype(np.float32) * 255 for _ in range(2)]
K = np.array([[50, 0, 32], [0, 50, 32], [0, 0, 1]], np.float32)
T = np.eye(4, dtype=np.float32); T[0, 3] = 0.1
runs = (("robust_mvd", {}, (1, 32, 32)), ("mvsnet_train", {}, (1, 16, 16)),
        ("cvp_mvsnet", {"nscale": 3}, (1, 64, 64)), ("vis_mvsnet", {}, (1, 32, 32)),
        # the family on K4's and K5's paths (plain versions here) and vis on cuDNN's convolutions
        ("mvsnet_train", {"conv3d_impl": "banded", "warp_impl": "xla"}, (1, 16, 16)),
        ("cvp_mvsnet", {"nscale": 3, "conv3d_impl": "banded"}, (1, 64, 64)),
        ("vis_mvsnet", {"conv3d_impl": "xla"}, (1, 32, 32)), ("robust_mvd", {"dtype": "bfloat16"}, (1, 32, 32)))
for name, kwargs, shape in runs:
    model = r.create_model(name, device="cpu", **kwargs)
    pred, _ = model.run(images=images, keyview_idx=0, poses=[np.eye(4, dtype=np.float32), T], intrinsics=[K, K])
    assert pred["depth"].shape == shape, (name, kwargs, pred["depth"].shape)
assert len(r.create_dataset("kitti.robustmvd.mvd", root="/nonexistent", verbose=False)) == 93
assert len(r.create_dataset("dtu.train_mvsnet.mvd", root="/nonexistent", verbose=False)) == 27097
dataset = r.create_dataset("synthetic.train.mvd", num_samples=2, num_views=3, height=64, width=64)
results = r.create_evaluation("mvd", inputs=["poses", "intrinsics"], verbose=False)(
    dataset=dataset, model=r.create_model("robust_mvd", device="cpu"), qualitatives=0)
assert results.shape[0] == 2 and np.isfinite(results["best"]["absrel"]).all()
for preset in r.list_augmentations():
    sample = r.create_dataset("synthetic.train.mvd", num_samples=1, num_views=2, height=40, width=60,
                              augmentations=preset)[0]
    assert np.isfinite(sample["images"][0]).all(), preset
from robustmvd_tpu_torch.train.cli import main as train_main
train_main(["--device", "cpu", "--dataset", "synthetic.train.mvd", "--model", "robust_mvd", "--dtype", "bfloat16", "--loss",
            "robust_mvd_loss", "--batch_augmentations", "robust_mvd_batch_augmentations", "--max_iterations", "1",
            "--batch_size", "1", "--num_workers", "0", "--output", sys.argv[1]])
sys.path.insert(0, "tests")
import robustmvd_tpu_torch.models.wrappers.wrappers as wrappers
from wrapper_stubs import WRAPPED, isolated_imports, stub_sample, write_stub_repos
wrappers.PATHS_FILE = write_stub_repos(sys.argv[1] + "/stubs")
for name in WRAPPED:
    with isolated_imports():
        pred, _ = r.create_model(name, device="cpu").run(**stub_sample(0))
        assert np.isfinite(pred["depth"]).all(), name
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("LOADED", bad)
""" % (FORBIDDEN,)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_training_the_family_loads_no_jax(tmp_path):
    """The family's training in a fresh interpreter loads no JAX. torch runs
    on 2 threads there (``torch_port_helpers.torch_threads``' reason: the
    suite runs one process per core)."""
    code = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
import robustmvd_tpu_torch as r
from robustmvd_tpu_torch.train.cli import main as train_main
train_main(["--device", "cpu", "--dataset", "synthetic.train.mvd", "--model", "vis_mvsnet", "--loss", "vismvsnet_loss",
            "--input_size", "64", "64", "--max_iterations", "1", "--batch_size", "1", "--num_workers", "0",
            "--output", sys.argv[1]])
sample = r.utils.numpy_collate([r.create_dataset("synthetic.train.mvd", num_views=3, height=64, width=64)[0]])
for name, loss, kwargs in (("mvsnet_train", "mvsnet_loss", {"num_sampling_steps": 8}),
                           ("cvp_mvsnet", "SL1Loss", {"nscale": 3})):
    model = r.create_model(name, device="cpu", train=True, **kwargs)
    inputs = {"images": torch.from_numpy(np.stack(sample["images"], 1)), "poses": torch.from_numpy(np.stack(sample["poses"], 1)),
              "intrinsics": torch.from_numpy(np.stack(sample["intrinsics"], 1)),
              "keyview_idx": torch.from_numpy(np.asarray(sample["keyview_idx"]).reshape(-1))}
    pred, aux = model(**inputs)
    total = r.create_loss(loss, model=model)(inputs, {"depth": torch.from_numpy(sample["depth"])}, pred, aux, iteration=0)[0]
    total.backward()
    assert torch.isfinite(total), name
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("LOADED", bad)
""" % (FORBIDDEN,)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_logging_the_viewer_and_data_parallel_load_no_jax(tmp_path):
    code = """
import json, sys
import torch
torch.set_num_threads(2)
import robustmvd_tpu_torch as r
import robustmvd_tpu_torch.launch, robustmvd_tpu_torch.parallel, robustmvd_tpu_torch.viewer
from robustmvd_tpu_torch.utils import profiler, writer
from robustmvd_tpu_torch.train.cli import main as train_main
out = sys.argv[1]
train_main(["--device", "cpu", "--data_parallel", "--dataset", "synthetic.train.mvd", "--input_size", "64", "64",
            "--model", "robust_mvd", "--loss", "robust_mvd_loss", "--max_iterations", "1", "--batch_size", "1",
            "--num_workers", "0", "--output", out + "/train"])
names = {json.loads(line)["name"] for line in open(out + "/train/events.jsonl")}
assert "03_params/encoder_norm" in names and "01_loss/total" in names, names
assert not torch.distributed.is_initialized()
import shutil
shutil.rmtree(out + "/train/checkpoints")  # robust_mvd's snapshots, ~650 MB
pages = r.run_viewer(r.create_dataset("synthetic.train.mvd", num_samples=1, height=32, width=48),
                     export_dir=out + "/pages")
x = torch.randn(32, 32)
with profiler.trace(out + "/trace", device="cpu"):
    x @ x
assert profiler.time_fn(lambda: x @ x, iters=2, burn_in=1) > 0 and len(pages) == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("LOADED", bad)
""" % (FORBIDDEN,)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
    assert list((tmp_path / "train").glob("events.out.tfevents.*"))
    assert list((tmp_path / "train" / "weights_only_checkpoints_dir").glob("snapshot-iter-*.pt"))


def _sources():
    pkg = Path(robustmvd_tpu_torch.__file__).parent
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "wrapper_stubs.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [node.value] if node.value.isidentifier() or "." in node.value and " " not in node.value else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} names {names}"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robustmvd_tpu_torch.create_model("robust_mvd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robustmvd_tpu_torch.create_model("robust_mvd", device="cuda")
    assert parse_args([]).device == "cuda"


def test_eval_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert eval_parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_main(["--eval_type", "mvd", "--dataset", "synthetic.train.mvd", "--model", "robust_mvd",
                   "--inputs", "poses", "intrinsics", "--output", str(tmp_path)])


def test_train_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--dataset", "synthetic.train.mvd", "--model", "robust_mvd", "--loss", "robust_mvd_loss",
                    "--max_iterations", "1", "--output", str(tmp_path)])


@pytest.mark.parametrize("name", ["mvsnet_train", "cvp_mvsnet", "vis_mvsnet"])
def test_family_entry_points_default_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robustmvd_tpu_torch.create_model(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robustmvd_tpu_torch.create_model(name, device="cuda")
    assert robustmvd_tpu_torch.create_model(name, device="cpu").device.type == "cpu"


def test_facade():
    assert robustmvd_tpu_torch.list_evaluations() == ["mvd", "robustmvd"]
    assert robustmvd_tpu_torch.has_dataset("kitti.robustmvd.mvd") and robustmvd_tpu_torch.has_dataset("eth3d.mvd")
    assert robustmvd_tpu_torch.list_base_datasets() == ["blendedmvs", "dtu", "eth3d", "flyingthings3d", "kitti",
                                                        "scannet", "staticthings3d", "synthetic", "tanks_and_temples"]
    assert robustmvd_tpu_torch.list_dataset_types() == ["mvd"]
    assert robustmvd_tpu_torch.list_splits(base_dataset="kitti") == ["eigen_dense_depth_test",
                                                                     "eigen_dense_depth_train", "robustmvd"]
    assert len(robustmvd_tpu_torch.list_datasets()) == 13
    assert callable(robustmvd_tpu_torch.create_dataloader) and callable(robustmvd_tpu_torch.create_evaluation)
    assert robustmvd_tpu_torch.list_models() == ["cvp_mvsnet", "cvp_mvsnet_wrapped", "midas_big_v2_1_wrapped",
                                                 "monodepth2_mono_stereo_1024x320_wrapped",
                                                 "monodepth2_mono_stereo_640x192_wrapped", "mvsnet_pl_wrapped",
                                                 "mvsnet_train", "patchmatchnet_wrapped", "robust_mvd",
                                                 "robust_mvd_5M", "vis_mvsnet", "vis_mvsnet_wrapped"]
    assert robustmvd_tpu_torch.has_model("robust_mvd")
    assert robustmvd_tpu_torch.list_models(trainable_only=True) == ["robust_mvd", "vis_mvsnet"]
    assert robustmvd_tpu_torch.create_model("robust_mvd", device="cpu", train=True).training
    assert not robustmvd_tpu_torch.create_model("robust_mvd", device="cpu").training
    for name in ("mvsnet_train", "cvp_mvsnet", "vis_mvsnet"):
        assert robustmvd_tpu_torch.create_model(name, device="cpu", train=True).training
    assert robustmvd_tpu_torch.list_losses() == ["SL1Loss", "VismvnsetMultiscaleMultiviewAggregate", "mvsnet_loss",
                                                 "robust_mvd_loss", "supervised_monodepth2_loss", "vismvsnet_loss"]
    assert robustmvd_tpu_torch.has_loss("robust_mvd_loss")
    assert robustmvd_tpu_torch.list_optimizers() == ["adam", "rmsprop"]
    assert robustmvd_tpu_torch.list_schedulers() == ["flownet_scheduler", "mvsnet_scheduler"]
    assert robustmvd_tpu_torch.list_trainings() == ["mvd"]
    assert robustmvd_tpu_torch.has_augmentation("robust_mvd_augmentations_staticthings3d")
    assert robustmvd_tpu_torch.has_batch_augmentation("robust_mvd_batch_augmentations")
    assert len(robustmvd_tpu_torch.list_augmentations()) == 6
    assert callable(robustmvd_tpu_torch.create_compound_dataset) and callable(robustmvd_tpu_torch.create_training)


def test_custom_model_gets_the_run_protocol():
    """prepare_custom_model attaches run() to a duck-typed model."""
    import numpy as np

    class Custom:
        def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
            return {"x": torch.from_numpy(np.stack(images, 1))}

        def __call__(self, x):
            return {"depth": x.mean(dim=(1, 2))}, {"n": x.shape[1]}

        def output_adapter(self, out):
            pred, aux = out
            return {k: v.numpy() for k, v in pred.items()}, aux

    model = robustmvd_tpu_torch.prepare_custom_model(Custom())
    assert model.name == "Custom"
    images = [np.full((3, 4, 5), float(i), np.float32) for i in range(3)]
    pred, aux = model.run(images=images, keyview_idx=0)
    assert pred["depth"].shape == (4, 5) and pred["depth"][0, 0] == 1.0
    assert aux == {"n": 3}
