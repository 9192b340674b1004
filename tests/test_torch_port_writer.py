"""The port's event writer (``utils/writer.py``) vs the JAX package's.

The same calls go through both writers, each into its own directory: the
``events.jsonl`` files are equal line for line (scalars given as Python and
numpy numbers and as one-element arrays: a torch tensor for the port, a
``jnp`` array for JAX; a non-scalar value written as null; ``put_time``'s
running average and ETA), and the TensorBoard files (JAX's through
``torch.utils.tensorboard``, the port's through its own record writer) hold
the same scalars, histograms (bucket limits, counts, min, max, sums) and
images (decoded pixels) by tag and step; writing them imports neither
TensorFlow nor JAX. A backend that is asked for and does not import is named
once through ``utils.logging`` and the JSONL log goes on.
"""

import io
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustmvd_tpu.utils import writer as jax_writer
from robustmvd_tpu_torch.utils import writer


def write_the_same(w, array, tmp, tensorboard):
    w.setup_writers(log_tensorboard=tensorboard, out_dir=str(tmp))
    w.put_scalar("00_overview/lr", 1e-4, step=0)
    w.put_scalar("01_loss/total", np.float32(2.5), step=0)
    w.put_scalar("01_loss/one_element", array([0.125]), step=0)
    w.put_scalar("01_loss/not_a_scalar", array([1.0, 2.0]), step=0)
    w.put_scalar_dict("metrics", {"absrel": 0.25, "inliers": np.float64(97.5)}, step=1)
    w.put_scalar_list("levels", [1.0, 2, np.int64(3)], step=1)
    for step, duration in enumerate((0.5, 0.25, 0.125)):
        w.put_time("00_overview/train_sec_iter", duration, step=step, avg_over_steps=True, update_eta=True,
                   max_iterations=10)
    w.put_tensor("00_inputs/key_image", np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3), step=2)
    w.put_histogram("03_params/encoder", np.linspace(-1, 1, 101, dtype=np.float32), step=2)
    with w.TimeWriter("00_overview/not_written", step=3, write=False):
        pass
    w.write_out_storage()
    w.put_scalar("01_loss/total", 1.5, step=3)
    w.write_out_storage()
    w.setup_writers(out_dir=None)


def tensorboard_events(out_dir):
    """(tag, step, value or kind) of every summary value in ``out_dir``."""
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto.event_pb2 import Event

    events = []
    for path in sorted(out_dir.glob("events.out.tfevents.*")):
        for record in RawEventFileLoader(str(path)).Load():
            event = Event.FromString(record)
            for value in event.summary.value:
                kind = value.WhichOneof("value")
                if kind == "simple_value":
                    events.append((value.tag, event.step, value.simple_value))
                elif kind == "histo":
                    h = value.histo
                    events.append((value.tag, event.step, ("histo", h.min, h.max, h.num, h.sum, h.sum_squares,
                                                           tuple(h.bucket_limit), tuple(h.bucket))))
                elif kind == "image":
                    pixels = np.array(Image.open(io.BytesIO(value.image.encoded_image_string)))
                    events.append((value.tag, event.step, ("image", value.image.colorspace, pixels.tobytes(),
                                                           pixels.shape)))
                else:
                    events.append((value.tag, event.step, kind))
    return events


@pytest.fixture(autouse=True)
def _fresh_writers(monkeypatch):
    """Each test starts both writers' module state afresh."""
    for w in (writer, jax_writer):
        monkeypatch.setattr(w, "_EVENT_STORAGE", [])
        monkeypatch.setattr(w, "_durations", type(w._durations)(w._durations.default_factory))


def test_events_jsonl_equals_jax_line_for_line(tmp_path):
    write_the_same(writer, lambda v: torch.tensor(v, dtype=torch.float32), tmp_path / "port", False)
    write_the_same(jax_writer, lambda v: jnp.asarray(v, jnp.float32), tmp_path / "jax", False)
    ours = (tmp_path / "port" / "events.jsonl").read_text().splitlines()
    ref = (tmp_path / "jax" / "events.jsonl").read_text().splitlines()
    assert ours == ref and len(ref) == 19
    lines = [json.loads(line) for line in ours]
    assert {"type": "scalar", "name": "01_loss/not_a_scalar", "value": None, "step": 0} in lines
    assert [e["value"] for e in lines if e["name"].endswith("_avg")] == [0.5, 0.375, 0.875 / 3]


def test_tensorboard_scalars_equal_jax(tmp_path):
    write_the_same(writer, lambda v: torch.tensor(v, dtype=torch.float32), tmp_path / "port", True)
    write_the_same(jax_writer, lambda v: jnp.asarray(v, jnp.float32), tmp_path / "jax", True)
    ours, ref = tensorboard_events(tmp_path / "port"), tensorboard_events(tmp_path / "jax")
    assert sorted(ours, key=repr) == sorted(ref, key=repr) and len(ours) == 20
    assert {e[0] for e in ours if isinstance(e[2], tuple)} == {"00_inputs/key_image", "03_params/encoder"}


def test_writing_tensorboard_imports_neither_tensorflow_nor_jax(tmp_path):
    code = """
import sys
from robustmvd_tpu_torch.utils import writer
writer.setup_writers(out_dir=sys.argv[1])
writer.put_scalar("a", 1.0, step=0)
writer.put_histogram("h", [1.0, -2.0], step=0)
writer.write_out_storage()
print(sorted(m for m in sys.modules if m.split(".")[0] in ("tensorflow", "keras", "jax", "robustmvd_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
    assert len(list(tmp_path.glob("events.out.tfevents.*"))) == 1


def test_a_missing_backend_is_named_and_the_run_goes_on(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)  # `import wandb` raises ImportError
    writer.setup_writers(log_tensorboard=False, log_wandb=True, out_dir=str(tmp_path))
    writer.put_scalar("a", 1.0, step=0)
    writer.write_out_storage()
    writer.setup_writers(out_dir=None)
    out = capsys.readouterr().out
    assert out.count("wandb is not written: ModuleNotFoundError") == 1
    assert json.loads((tmp_path / "events.jsonl").read_text()) == {"type": "scalar", "name": "a", "value": 1.0,
                                                                   "step": 0}


def test_without_out_dir_nothing_is_written(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    writer.setup_writers(out_dir=None)
    writer.put_scalar("a", 1.0, step=0)
    writer.write_out_storage()
    assert writer._EVENT_STORAGE == [] and list(tmp_path.iterdir()) == []


def test_cli_writer_flags(tmp_path):
    """The train CLI takes JAX's writer flags (``--exp_id``, ``--comment`` and
    ``--log_full_batch`` declared and unread, as in JAX); the eval CLI sets
    the writer up in ``--log_dir`` (``--output`` by default), TensorBoard on
    unless ``--no_tensorboard``."""
    from robustmvd_tpu_torch.eval.cli import main as eval_main
    from robustmvd_tpu_torch.eval.cli import parse_args as eval_parse_args
    from robustmvd_tpu_torch.train.cli import parse_args as train_parse_args

    args = train_parse_args(["--no_tensorboard", "--wandb", "--exp_id", "e1", "--comment", "c", "--log_full_batch"])
    assert (args.no_tensorboard, args.wandb, args.exp_id, args.comment, args.log_full_batch) == (True, True, "e1", "c",
                                                                                                 True)
    assert eval_parse_args([]).log_dir is None and not eval_parse_args([]).no_tensorboard
    eval_main(["--device", "cpu", "--eval_type", "mvd", "--dataset", "synthetic.train.mvd", "--model", "robust_mvd",
               "--inputs", "poses", "intrinsics", "--num_samples", "1", "--num_qualitatives", "0", "--output",
               str(tmp_path / "out"), "--log_dir", str(tmp_path / "logs"), "--exp_id", "e1"])
    assert len(list((tmp_path / "logs").glob("events.out.tfevents.*"))) == 1
    assert (tmp_path / "out" / "results.csv").is_file() and not list((tmp_path / "out").glob("events.out.*"))
