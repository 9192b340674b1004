"""The training engine's event writing (``train/multi_view_depth_training.py``
with ``utils/writer.py``) vs the JAX engine's, and data parallelism at one rank.

For robust_mvd (``robust_mvd_loss``) and vis_mvsnet ``train=True``
(``vismvsnet_loss``), 2 steps of batch 1 at 64x64 with 1+2 views over
``synthetic.train.mvd``, three runs of the engine from one seed:

- ``log_interval`` and ``log_loss_interval`` 1: every step writes the times,
  the losses, the learning rate, the images and the parameter histograms;
- no logging (both intervals beyond the run);
- no logging, with a mesh over a gloo group of one process: the model under
  ``DistributedDataParallel``.

All three end with bit-equal parameters, BatchNorm running statistics,
optimizer state and random generators: the logging forward leaves the train
state alone, and DDP at world size 1 is the engine without it. torch runs on
one thread: on two, robust_mvd's CPU backward sums in an order that varies
run to run (two runs without logging differ in 33 of its parameters).

The logged run's ``events.jsonl`` holds, at each step, the scalar names that
the JAX engine writes at that step: JAX's engine runs the same intervals
with JAX's loss (``create_loss`` of the JAX package) and the JAX parameter
tree of the same weights (through the bridges), its model's forward replaced
by the port's predictions on the batch (names do not depend on the values;
JAX's forward is what ``tests/test_torch_port_train_grad.py`` and
``test_torch_port_family_train.py`` compare).
"""

import json
import shutil
import socket
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import robustmvd_tpu
from robustmvd_tpu.models.weights import convert_torch_state_dict
from robustmvd_tpu.utils import writer as jax_writer
import robustmvd_tpu_torch as rmvd
from robustmvd_tpu_torch.models.weights import variables_from_state_dict
from robustmvd_tpu_torch.parallel import MeshSpec, init_distributed, make_mesh
from robustmvd_tpu_torch.utils import writer

from torch_port_helpers import torch_threads

CASES = {"robust_mvd": ("robust_mvd_loss", "flownet_scheduler", 1e-4),
         "vis_mvsnet": ("vismvsnet_loss", "mvsnet_scheduler", 1e-3)}
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def dataset(package):
    return package.create_dataset("synthetic.train.mvd", num_samples=4, num_views=3, height=64, width=64)


def port_run(name, out_dir, logged, mesh=None):
    loss_name, scheduler, lr = CASES[name]
    torch.manual_seed(0)
    np.random.seed(0)
    writer.setup_writers(out_dir=str(out_dir) if logged else None)  # TensorBoard: the logging forward runs
    model = rmvd.create_model(name, device="cpu", train=True, seed=0)
    optimizer = rmvd.create_optimizer("adam", model=model, lr=lr)
    interval = 1 if logged else 10 ** 6
    training = rmvd.create_training(
        "mvd", out_dir=str(out_dir), model=model, dataset=dataset(rmvd), optimizer=optimizer,
        scheduler=rmvd.create_scheduler(scheduler, optimizer=optimizer), loss=rmvd.create_loss(loss_name, model=model),
        batch_size=1, max_iterations=STEPS, num_workers=0, log_interval=interval, log_loss_interval=interval,
        mesh=mesh, verbose=False)
    training()
    writer.setup_writers(out_dir=None)
    for snapshots in ("checkpoints", "weights_only_checkpoints_dir"):  # robust_mvd's are ~680 MB a run
        shutil.rmtree(out_dir / snapshots)
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(), "torch_rng": torch.get_rng_state(),
            "numpy_rng": np.random.get_state()[1], "training": training}


def one_rank_mesh():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    return make_mesh(MeshSpec())


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    name = request.param
    out = tmp_path_factory.mktemp(name)
    result = {"name": name, "logged": port_run(name, out / "logged", logged=True),
              "plain": port_run(name, out / "plain", logged=False)}
    try:
        result["ddp1"] = port_run(name, out / "ddp1", logged=False, mesh=one_rank_mesh())
    finally:
        dist.destroy_process_group()
    result["events"] = [json.loads(line) for line in (out / "logged" / "events.jsonl").read_text().splitlines()]
    return result


def assert_bit_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("other", ["plain", "ddp1"])
def test_logging_and_one_rank_ddp_leave_the_train_state(runs, other):
    for key in ("model", "optimizer", "torch_rng", "numpy_rng"):
        assert_bit_equal(runs["logged"][key], runs[other][key], key)
    assert type(runs["ddp1"]["training"].train_model).__name__ == "DistributedDataParallel"
    if runs["name"] == "vis_mvsnet":  # the running statistics did move
        assert any("running_mean" in k for k in runs["logged"]["model"])
        first = rmvd.create_model("vis_mvsnet", device="cpu", train=True, seed=0).state_dict()
        assert not torch.equal(first["stage1.reg.unet.enc_1.block0.bn1.running_mean"],
                               runs["plain"]["model"]["stage1.reg.unet.enc_1.block0.bn1.running_mean"])


def to_jax(x, channels_last):
    if isinstance(x, dict):
        return {k: to_jax(v, channels_last) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_jax(v, channels_last) for v in x)
    if torch.is_tensor(x):
        x = x.detach().numpy()
        return jnp.asarray(np.moveaxis(x, 1, -1) if channels_last and x.ndim == 4 else x)
    return x


def jax_engine_events(name, state, out_dir):
    """The JAX engine's events over STEPS steps at intervals 1, its forward
    replaced by the port's predictions on the first batch."""
    loss_name, scheduler, lr = CASES[name]
    port_model = rmvd.create_model(name, device="cpu", train=True)
    port_model.load_state_dict(state)
    sample = rmvd.utils.numpy_collate([dataset(rmvd)[0]])
    inputs = {"images": torch.from_numpy(np.stack(sample["images"], 1)),
              "poses": torch.from_numpy(np.stack(sample["poses"], 1)),
              "intrinsics": torch.from_numpy(np.stack(sample["intrinsics"], 1)),
              "keyview_idx": torch.from_numpy(np.asarray(sample["keyview_idx"]).reshape(-1))}
    with torch.no_grad():
        pred, aux = port_model(**inputs)
    # robust_mvd's JAX loss reads channel-last maps; vis's reads the (B, 1, h, w) maps as the port has them
    pred, aux = to_jax(pred, True), to_jax(aux, name == "robust_mvd")
    if name == "robust_mvd":
        variables = {"params": convert_torch_state_dict({k: v.numpy() for k, v in state.items()})["params"]}
    else:
        variables = variables_from_state_dict(state)

    model = types.SimpleNamespace(variables=variables, name=name, num_parameters=lambda: 0,
                                  apply_fn=lambda variables, **_: (pred, aux))
    jax_writer.setup_writers(log_tensorboard=False, out_dir=str(out_dir))
    optimizer = robustmvd_tpu.create_optimizer("adam", model=model, lr=lr)
    training = robustmvd_tpu.create_training(
        "mvd", out_dir=str(out_dir), model=model, dataset=dataset(robustmvd_tpu), optimizer=optimizer,
        scheduler=robustmvd_tpu.create_scheduler(scheduler, optimizer=optimizer),
        loss=robustmvd_tpu.create_loss(loss_name, model=model), batch_size=1, max_iterations=STEPS,
        num_workers=0, log_interval=1, log_loss_interval=1, verbose=False)
    training()
    jax_writer.setup_writers(out_dir=None)
    events = [json.loads(line) for line in (out_dir / "events.jsonl").read_text().splitlines()]
    shutil.rmtree(out_dir / "checkpoints")  # JAX's snapshot of robust_mvd's state, ~500 MB
    return events


def test_logged_scalar_names_equal_jax_engine(runs, tmp_path):
    name = runs["name"]
    state = rmvd.create_model(name, device="cpu", train=True, seed=0).state_dict()
    ref = jax_engine_events(name, state, tmp_path)

    def names_by_step(events):
        return {step: sorted(e["name"] for e in events if e["step"] == step) for step in range(STEPS)}

    ours = names_by_step(runs["events"])
    assert ours == names_by_step(ref)
    assert all(e["type"] == "scalar" and e["step"] in range(STEPS) for e in runs["events"])
    assert "00_overview/train_sec_iter_eta_min" in ours[1] and "00_overview/lr" in ours[0]
    assert all(np.isfinite(e["value"]) for e in runs["events"])
