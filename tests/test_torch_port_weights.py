"""The weight bridge between the port and the JAX package.

- The port's ``state_dict`` carries the rmvd names and layouts: the JAX
  package's ``convert_torch_state_dict`` turns it into exactly the key tree
  and shapes of the JAX module's ``init`` variables.
- ``state_dict_from_jax`` is its inverse: JAX -> port -> JAX is bit-exact.
- rmvd ``.pt`` checkpoints (``model_state_dict``, ``module.`` prefixes)
  load into the port.
- A Vis-MVSNet state dict in rmvd naming (the port's names renamed so that
  the JAX package's ``convert_vis_mvsnet_torch_state_dict`` takes them)
  loads into the port's vis_mvsnet and gives the port-named load's depth
  bit for bit; JAX's vis converter of it equals ``variables_from_state_dict``
  of the port's load.
"""

import re

import jax
import numpy as np
import pytest
import torch

from robustmvd_tpu.models.robust_mvd import RobustMVD as JaxRobustMVD
from robustmvd_tpu.models.weights import convert_torch_state_dict, convert_vis_mvsnet_torch_state_dict
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.weights import (
    RMVD_VIS_KEY,
    load_checkpoint,
    state_dict_from_jax,
    variables_from_state_dict,
    vis_state_dict_from_rmvd,
    vis_state_dict_to_rmvd,
)
from wrapper_stubs import stub_sample


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.RandomState(11)
    params = JaxRobustMVD(corr_impl="matmul", seed=5).variables["params"]
    # random biases too (init leaves them zero), so their mapping is tested
    return jax.tree_util.tree_map_with_path(
        lambda path, v: rng.randn(*v.shape).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(v),
        params,
    )


@pytest.fixture(scope="module")
def port_model():
    return create_model("robust_mvd", device="cpu")


def _numpy_state(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_port_state_dict_converts_to_the_jax_tree(jax_params, port_model):
    ours = _leaves(convert_torch_state_dict(_numpy_state(port_model))["params"])
    ref = _leaves(jax_params)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key


def test_bridge_round_trips_bit_exactly(jax_params, port_model):
    state = state_dict_from_jax({"params": jax_params})
    assert sorted(state) == sorted(port_model.state_dict())
    port_model.load_state_dict(state, strict=True)
    back = _leaves(convert_torch_state_dict(_numpy_state(port_model))["params"])
    for key, ref in _leaves(jax_params).items():
        np.testing.assert_array_equal(back[key], ref, err_msg=key)


def test_deconv_kernels_are_flipped(jax_params):
    """A ConvTranspose kernel is stored spatially flipped on the JAX side."""
    state = state_dict_from_jax(jax_params)
    jk = np.asarray(jax_params["decoder"]["deconv_1"]["conv"]["kernel"])  # (kh, kw, I, O)
    w = state["decoder.deconv_1.0.weight"].numpy()  # (I, O, kh, kw)
    assert w.shape == (1024, 512, 4, 4)
    np.testing.assert_array_equal(w[3, 7, 0, 1], jk[3, 2, 3, 7])


def test_load_rmvd_checkpoint(tmp_path, port_model):
    """``{"model_state_dict": ...}`` with DataParallel ``module.`` prefixes."""
    ref = create_model("robust_mvd", device="cpu", seed=3)
    path = tmp_path / "robust_mvd.pt"
    torch.save({"model_state_dict": {"module." + k: v for k, v in ref.state_dict().items()}}, path)
    state = load_checkpoint(path)
    assert sorted(state) == sorted(ref.state_dict())
    loaded = create_model("robust_mvd", device="cpu", weights=str(path))
    for (k, a), b in zip(loaded.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    assert not torch.equal(ref.state_dict()["encoder.conv1.0.weight"],
                           port_model.state_dict()["encoder.conv1.0.weight"])


@pytest.fixture(scope="module")
def vis_rmvd(tmp_path_factory):
    """A seeded vis_mvsnet with random BatchNorm statistics, saved in both
    namings: (model, port-named path, rmvd-named path, rmvd state)."""
    model = create_model("vis_mvsnet", device="cpu", seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.2 * torch.rand(buf.shape, generator=gen))
    state = model.state_dict()
    rmvd = vis_state_dict_to_rmvd(state)
    tmp = tmp_path_factory.mktemp("vis_rmvd")
    torch.save({"model_state_dict": state}, tmp / "port.pt")
    torch.save({"model_state_dict": {"module." + k: v for k, v in rmvd.items()}}, tmp / "rmvd.pt")
    return model, str(tmp / "port.pt"), str(tmp / "rmvd.pt"), rmvd


def test_vis_rmvd_names(vis_rmvd):
    model, _, _, rmvd = vis_rmvd
    state = model.state_dict()
    assert RMVD_VIS_KEY in rmvd and RMVD_VIS_KEY not in state
    # every rule of the JAX converter is exercised, and no name of the port's own is left
    for part in ("unet.enc_blocks.enc_0.0.", "unet.dec_blocks.dec_2.0.", "unet.dec_blocks.dec_2.1.",
                 "unet.dec_blocks.dec_3.2.0.", "downsample.0.", "downsample.1.", "feat_ext.init_conv.1.",
                 "uncert_net.conv1.0.", "uncert_net.conv1.1.", "uncert_net.head_convs.0."):
        assert any(part in key for key in rmvd), part
    port_only = re.compile(r"\.block\d|_deconv\.|_post\.|_res\.|downsample_|init_bn|uncert_net\.(conv\d_|head_\d)")
    assert not any(port_only.search(key) for key in rmvd)
    assert sum(port_only.search(key) is not None for key in state) > 300
    assert vis_state_dict_from_rmvd(rmvd).keys() == state.keys()
    assert vis_state_dict_from_rmvd(state).keys() == state.keys()


def test_vis_rmvd_checkpoint_loads_bit_for_bit(vis_rmvd):
    _, port_path, rmvd_path, _ = vis_rmvd
    by_port = create_model("vis_mvsnet", device="cpu", weights=port_path)
    by_rmvd = create_model("vis_mvsnet", device="cpu", weights=rmvd_path)
    for (key, a), b in zip(by_rmvd.state_dict().items(), by_port.state_dict().values()):
        assert torch.equal(a, b), key
    sample = stub_sample(seed=3, height=64, width=64)
    sample.pop("depth_range")
    pred_port, _ = by_port.run(**sample)
    pred_rmvd, _ = by_rmvd.run(**sample)
    for key in ("depth", "depth_uncertainty"):
        assert np.isfinite(pred_port[key]).all()
        np.testing.assert_array_equal(pred_rmvd[key], pred_port[key], err_msg=key)


def test_jax_vis_converter_equals_the_port_bridge(vis_rmvd):
    _, _, rmvd_path, rmvd = vis_rmvd
    ours = _leaves(variables_from_state_dict(create_model("vis_mvsnet", device="cpu", weights=rmvd_path).state_dict()))
    ref = _leaves(convert_vis_mvsnet_torch_state_dict({k: v.numpy() for k, v in rmvd.items()}))
    assert sorted(ours) == sorted(ref) and len(ref) > 300
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
