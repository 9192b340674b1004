"""The seven wrapped models against the JAX package's wrappers, on stub
repositories (``wrapper_stubs.py``: the real repositories' import layout,
their checkpoints' naming, seeded weights of a few channels).

- Each wrapped name built by the port with ``device="cpu"`` gives the JAX
  wrapper's ``pred`` within 1e-6, batched and unbatched, on the same stub
  (both packages' ``PATHS_FILE`` pointed at it).
- Without its repository each name raises ``FileNotFoundError`` with the
  JAX package's message, naming the port's paths file and scripts.
- The registries list the same 12 names.
- ``create_evaluation("mvd")`` with ``vis_mvsnet_wrapped`` gives the JAX
  engine's tables.
- The port loads a Lightning checkpoint that pickles objects
  (``wrappers.py::load_repo_checkpoint``).

The stubs of mvsnet_pl, PatchmatchNet and CVP-MVSNet all import a top-level
``models`` package, so each test removes what a build adds to ``sys.path``
and ``sys.modules`` (``wrapper_stubs.isolated_imports``).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import robustmvd_tpu
import robustmvd_tpu.models.wrappers.wrappers as jax_wrappers
import robustmvd_tpu_torch
import robustmvd_tpu_torch.models.wrappers.wrappers as wrappers
from wrapper_stubs import WRAPPED, isolated_imports, stub_sample, write_stub_repos

TIMING = ("runtime_model_in_sec", "runtime_model_in_msec", "runtime_model_and_io_in_sec",
          "runtime_model_and_io_in_msec", "device_mem_peak_in_mib")


@pytest.fixture(scope="module")
def stub_paths(tmp_path_factory):
    return write_stub_repos(str(tmp_path_factory.mktemp("stubs")), seed=0)


@pytest.fixture
def stubs(stub_paths, monkeypatch):
    """Both packages' wrappers resolve the stub repositories."""
    monkeypatch.setattr(jax_wrappers, "PATHS_FILE", stub_paths)
    monkeypatch.setattr(wrappers, "PATHS_FILE", stub_paths)
    with isolated_imports():
        yield stub_paths


@pytest.fixture
def no_native_resize(monkeypatch):
    """The JAX package's bilinear resize without its native library (the
    port's is the numpy arithmetic)."""
    import robustmvd_tpu.utils.native as native

    monkeypatch.setattr(native, "resize_bilinear_native", lambda img, size: None)


def _close(ours, ref, rtol=1e-6):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        assert np.isfinite(a).all(), key
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=key)


def test_registries_list_the_same_names():
    names = robustmvd_tpu_torch.list_models()
    assert names == robustmvd_tpu.list_models() and len(names) == 12
    assert robustmvd_tpu_torch.list_models(trainable_only=True) == robustmvd_tpu.list_models(trainable_only=True)
    assert all(name in names and not robustmvd_tpu_torch.has_model(name, trainable_only=True) for name in WRAPPED)


@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_wrapped_model_matches_jax(stubs, no_native_resize, name, batched):
    ours = robustmvd_tpu_torch.create_model(name, device="cpu")
    ref = robustmvd_tpu.create_model(name)
    assert ours.name == name and ours.device == torch.device("cpu")
    assert ours.num_parameters() == ref.num_parameters()
    # 1+2 views at 60x120: every wrapper that resizes to a multiple of 64 resizes
    sample = stub_sample(seed=1, height=60, width=120, batched=batched)
    pred, aux = ours.run(**sample)
    pred_ref, aux_ref = ref.run(**stub_sample(seed=1, height=60, width=120, batched=batched))
    _close(pred, pred_ref)
    assert aux == aux_ref == {}
    assert pred["depth"].ndim == (4 if batched else 3)


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_wrapped_model_without_its_repository_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(wrappers, "PATHS_FILE", str(tmp_path / "paths.toml"))
    (tmp_path / "paths.toml").write_text(f"[{WRAPPED[name]}]\nroot = '{tmp_path / 'absent'}'\n")
    with pytest.raises(FileNotFoundError, match=f"External repository for '{WRAPPED[name]}' not found") as error:
        robustmvd_tpu_torch.create_model(name, device="cpu")
    assert str(tmp_path / "paths.toml") in str(error.value)
    assert "robustmvd_tpu_torch/models/wrappers/scripts/" in str(error.value)


def test_wrapper_paths_and_weights_arguments():
    # the port's own paths file names every repository, as JAX's does
    get_path = robustmvd_tpu_torch.models.wrappers.get_wrapper_path
    for name in set(WRAPPED.values()):
        assert get_path(name, "root") == jax_wrappers.get_wrapper_path(name, "root") is not None
    assert get_path("nonexistent_repo", "root") is None
    with pytest.raises(ValueError, match="pretrained weights"):
        robustmvd_tpu_torch.create_model("vis_mvsnet_wrapped", device="cpu", weights="some.pt")


def test_lightning_checkpoint_with_objects_loads(tmp_path, monkeypatch):
    """mvsnet_pl's checkpoint pickles hyper-parameter objects, which torch's
    weights-only default refuses; the port unpickles the repository's files
    in full."""
    paths = write_stub_repos(str(tmp_path), seed=0, lightning_hparams=True)
    monkeypatch.setattr(wrappers, "PATHS_FILE", paths)
    with pytest.raises(Exception, match="Weights only load failed"):
        torch.load(tmp_path / "mvsnet_pl" / "_ckpt_epoch_14.ckpt", map_location="cpu", weights_only=True)
    with isolated_imports():
        model = robustmvd_tpu_torch.create_model("mvsnet_pl_wrapped", device="cpu")
        pred, _ = model.run(**stub_sample(seed=2))
    assert pred["depth"].shape == (1, 64, 128) and np.isfinite(pred["depth"]).all()


def test_evaluation_of_a_wrapped_model_matches_jax(stubs, no_native_resize):
    """Both engines, each with its package's vis_mvsnet_wrapped on the stub,
    over synthetic samples at a size the wrapper resizes."""
    config = dict(num_samples=2, num_views=3, height=60, width=120)
    kwargs = dict(inputs=["poses", "intrinsics"], view_ordering="quasi-optimal", eval_uncertainty=True,
                  verbose=False)
    ours = robustmvd_tpu_torch.create_evaluation("mvd", **kwargs)(
        dataset=robustmvd_tpu_torch.create_dataset("synthetic.train.mvd", **config),
        model=robustmvd_tpu_torch.create_model("vis_mvsnet_wrapped", device="cpu"), qualitatives=0)
    ref = robustmvd_tpu.create_evaluation("mvd", **kwargs)(
        dataset=robustmvd_tpu.create_dataset("synthetic.train.mvd", **config),
        model=robustmvd_tpu.create_model("vis_mvsnet_wrapped"), qualitatives=0)
    columns = [c for c in ref.columns if c[1] not in TIMING]
    assert [c for c in ours.columns if c[1] not in TIMING] == columns
    assert np.isfinite(ours["best"]["absrel"].to_numpy(np.float64)).all()
    pd.testing.assert_frame_equal(ours[columns].astype(np.float64), ref[columns].astype(np.float64),
                                  check_exact=False, rtol=1e-6)


def test_torch_helpers_match_jax():
    """The port's copies of the JAX package's torch helpers (``utils/torchutils.py``)."""
    from robustmvd_tpu.utils import torchutils as jax_torchutils
    from robustmvd_tpu_torch.utils import torchutils

    data = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.ones(2), (np.zeros(1), "s")],
            "c": np.array(["x", "y"]), "d": None, "e": 3}
    ours, ref = torchutils.to_torch(data), jax_torchutils.to_torch(data)
    assert torch.equal(ours["a"], ref["a"]) and ours["a"].device == torch.device("cpu")
    assert torch.equal(ours["b"][0], ref["b"][0]) and torch.equal(ours["b"][1][0], ref["b"][1][0])
    assert ours["b"][1][1] == "s" and ours["c"] is data["c"] and ours["d"] is None and ours["e"] == 3
    batch = [{"x": torch.ones(2), "y": 1}, {"x": torch.zeros(2), "y": 2}]
    collated, collated_ref = torchutils.torch_collate(batch), jax_torchutils.torch_collate(batch)
    assert torch.equal(collated["x"], collated_ref["x"]) and torch.equal(collated["y"], collated_ref["y"])
    assert torchutils.torch_collate(None) is None
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    net[1].weight.requires_grad_(False)
    assert torchutils.get_torch_model_device(net) == jax_torchutils.get_torch_model_device(net) == torch.device("cpu")
    assert torchutils.check_torch_model_cuda(net) is jax_torchutils.check_torch_model_cuda(net) is False
    assert torchutils.count_torch_model_parameters(net) == jax_torchutils.count_torch_model_parameters(net) == 116
    assert torchutils.to_cuda("text") == "text" and torchutils.string_classes == (str, bytes)
