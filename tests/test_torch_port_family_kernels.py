"""The MVSNet family on the K4 / K5 paths, in the port vs the JAX package.

The JAX configurations whose lowerings K4 and K5 stand in for, with the
same randomised, bridged weights (``state_dict_from_jax``) and the same
numpy inputs, on the CPU (the port's wrappers run their plain versions):
- ``mvsnet_train(conv3d_impl="banded", warp_impl="xla")``: the materialised
  warp route (``homo_warp`` per source view, K4) and K5 in CostRegNet;
- ``cvp_mvsnet(conv3d_impl="banded")``;
- ``vis_mvsnet`` at its default, ``conv3d_impl="banded"`` in both packages.
Bounds are those of ``test_torch_port_{mvsnet,cvp,vis_mvsnet}.py``. Each
path's K5 call count per frame is the one ``chip_smoke.py`` requires of the
card's launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.models.vis_mvsnet import VisMvsnet as JaxVisMvsnet
from robustmvd_tpu.models.vis_mvsnet import VisMvsnetModule
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.mvsnet import MVSNet
from robustmvd_tpu_torch.models.weights import state_dict_from_jax
from robustmvd_tpu_torch.ops.conv3d import Conv3d
from robustmvd_tpu_torch.ops.kernels.sweep_warp import warp_variance

from torch_port_helpers import general_mvd_sample, randomized_variables, relative_errors


def _k5_calls(model):
    """Count the forwards of the model's K5 convolutions (on the CPU the
    wrapper runs its plain version, which is not a launch)."""
    calls = []
    for m in model.modules():
        if isinstance(m, Conv3d) and m.impl == "banded":
            m.register_forward_hook(lambda *_: calls.append(1))
    return calls


def _family_close(pred, ref_pred, shape):
    depth, ref_depth = pred["depth"], np.asarray(ref_pred["depth"])
    assert depth.shape == ref_depth.shape == shape
    assert np.isfinite(ref_depth).all() and ref_depth.std() > 1e-3 * np.abs(ref_depth).mean()  # not vacuous
    mean, mx = relative_errors(depth, ref_depth)
    assert mean <= 1e-5 and mx <= 1e-4, (mean, mx)
    unc, ref_unc = pred["depth_uncertainty"], np.asarray(ref_pred["depth_uncertainty"])
    close = np.abs(unc - ref_unc) <= 1e-4 * np.abs(ref_unc).mean()
    assert close.mean() >= 0.99, close.mean()


def test_mvsnet_xla_warp_and_banded_conv_match_jax():
    jax_model = jax_create_model("mvsnet_train", pretrained=False, num_sampling_steps=16, warp_impl="xla",
                                 conv3d_impl="banded")
    variables = randomized_variables(jax_model.variables, np.random.RandomState(3), prob_gain=20.0)
    jax_model.variables = variables
    sample = general_mvd_sample(np.random.RandomState(5), 64, 96, 3)
    ref_pred, _ = jax_model.run(**sample)
    port = create_model("mvsnet_train", device="cpu", num_sampling_steps=16, conv3d_impl="banded", warp_impl="xla")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    calls = _k5_calls(port)
    pred, _ = port.run(**sample)
    assert len(calls) == 4  # conv2, conv4, conv6 and prob
    _family_close(pred, ref_pred, (1, 1, 16, 24))


def test_mvsnet_warp_routes_agree():
    """The materialised route (K4 + running sums) and the fused one (K2)
    compute the same variance volume."""
    rng = np.random.RandomState(11)
    B, V, h, w, C, D = 1, 2, 12, 16, 8, 6
    ref = torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
    src = torch.from_numpy(rng.randn(B, V, h, w, C).astype(np.float32))
    K = np.array([[12.0, 0, 8], [0, 12.0, 6], [0, 0, 1]], np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (B, V + 1, 1, 1))
    for i in range(V + 1):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * i, 0.02 * i, 0.0]
        proj[:, i, :3, :4] = K @ pose[:3, :4]
    proj = torch.from_numpy(proj)
    key_inv = torch.linalg.inv(proj[:, 0])
    depth = torch.linspace(1.0, 8.0, D)[None]
    fused = warp_variance(ref, src, proj[:, 1:], key_inv, depth)
    materialised = MVSNet.warped_variance(ref, src, proj[:, 1:], key_inv, depth)
    np.testing.assert_allclose(materialised.numpy(), fused.numpy(), atol=1e-5, rtol=1e-5)


def test_mvsnet_rejects_unknown_warp_impl():
    with pytest.raises(ValueError, match="warp_impl"):
        create_model("mvsnet_train", device="cpu", num_sampling_steps=4, warp_impl="gather")
    with pytest.raises(ValueError, match="warp_impl"):
        MVSNet("cpu", num_sampling_steps=4, warp_impl="auto")  # a JAX name: create_model maps it


@pytest.mark.parametrize("name,route", [("fused", "fused"), ("auto", "fused"), ("pallas", "fused"),
                                        ("pallas_fused", "fused"), ("xla", "xla")])
def test_create_model_maps_jax_warp_impl_names(name, route):
    """The JAX package's four names are two routes here: K2 and K4."""
    assert create_model("mvsnet_train", device="cpu", num_sampling_steps=4, warp_impl=name).warp_impl == route


def test_cvp_banded_conv_matches_jax():
    jax_model = jax_create_model("cvp_mvsnet", pretrained=False, nscale=3, warp_impl="xla", conv3d_impl="banded")
    variables = randomized_variables(jax_model.variables, np.random.RandomState(4), prob_gain=20.0)
    jax_model.variables = variables
    sample = general_mvd_sample(np.random.RandomState(6), 64, 128, 3)
    ref_pred, ref_aux = jax_model.run(**sample)
    port = create_model("cvp_mvsnet", device="cpu", nscale=3, conv3d_impl="banded")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    calls = _k5_calls(port)
    pred, aux = port.run(**sample)
    assert len(calls) == 8 * 3  # seven stride-1 convs and prob0, once per level
    _family_close(pred, ref_pred, (1, 1, 64, 128))
    for ours, ref in zip(aux["depths_all"], ref_aux["depths_all"]):
        mean, mx = relative_errors(ours, np.asarray(ref))
        assert mean <= 1e-5 and mx <= 1e-4, (ours.shape, mean, mx)


def test_vis_default_banded_conv_matches_jax():
    """vis_mvsnet at its default in both packages (JAX: the XLA banded conv
    and its stride-2 packed form; the port: K5 and cuDNN's strided conv),
    JAX's group cost through its kernel in interpret mode (see
    ``test_torch_port_vis_mvsnet.py``); 64x64, 1+2 views, every stage's
    depth mean <= 1e-4 and max <= 1e-3, the uncertainty mean |diff| <= 1e-4
    and |diff| > 1e-3 on at most 1% of the pixels."""
    assert VisMvsnetModule.conv3d_impl == "banded"
    module = VisMvsnetModule(num_sampling_steps=192, warp_impl="pallas")
    dummy = {"images": jnp.zeros((1, 2, 64, 64, 3)), "poses": jnp.tile(jnp.eye(4), (1, 2, 1, 1)),
             "intrinsics": jnp.tile(jnp.eye(3) * 32, (1, 2, 1, 1)), "keyview_idx": jnp.zeros((1,), jnp.int32),
             "depth_range": (jnp.ones((1,)), jnp.full((1,), 10.0))}
    variables = randomized_variables(jax.jit(module.init)(jax.random.PRNGKey(0), **dummy),
                                     np.random.RandomState(3), prob_gain=20.0)
    sample = general_mvd_sample(np.random.RandomState(5), 64, 64, 3)
    port = create_model("vis_mvsnet", device="cpu")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    calls = _k5_calls(port)
    pred, aux = port.run(**sample)
    assert len(calls) == 30  # ten per stage: Reg 4, RegPair 1, RegFuse 5

    inputs = JaxVisMvsnet.input_adapter(None, **{k: sample[k] for k in ("images", "keyview_idx", "poses",
                                                                        "intrinsics", "depth_range")})
    ref_pred, ref_aux = jax.jit(module.apply)(variables, **inputs)
    ref_depth = np.asarray(ref_pred["depth"]).transpose(0, 3, 1, 2)
    assert pred["depth"].shape == ref_depth.shape == (1, 1, 32, 32)
    assert ref_depth.std() > 1e-3 * ref_depth.mean()
    for k, (ours, ref) in enumerate(zip(aux["outputs"], ref_aux["outputs"])):
        mean, mx = relative_errors(ours[0], np.asarray(ref[0]))
        assert mean <= 1e-4 and mx <= 1e-3, (k, mean, mx)
    mean, mx = relative_errors(pred["depth"], ref_depth)
    assert mean <= 1e-4 and mx <= 1e-3, (mean, mx)
    diff = np.abs(pred["depth_uncertainty"] - np.asarray(ref_pred["depth_uncertainty"]).transpose(0, 3, 1, 2))
    assert diff.mean() <= 1e-4 and (diff > 1e-3).mean() <= 0.01, (diff.mean(), (diff > 1e-3).mean())


@pytest.mark.parametrize("name,kwargs,per_frame", [
    ("mvsnet_train", {"num_sampling_steps": 8}, 0),  # "xla" (JAX's default "dz2d"): cuDNN
    ("cvp_mvsnet", {"nscale": 2}, 0),  # "xla"
    ("vis_mvsnet", {"conv3d_impl": "xla"}, 0),
    ("vis_mvsnet", {"conv3d_impl": "packed"}, 30),  # a JAX name for K5's lowering
])
def test_conv3d_impl_defaults_and_choices(name, kwargs, per_frame):
    """The JAX defaults pick cuDNN for mvsnet and cvp, K5 for vis; the
    choice changes no parameter name."""
    model = create_model(name, device="cpu", **kwargs)
    calls = _k5_calls(model)
    sample = general_mvd_sample(np.random.RandomState(1), 64, 64, 3)
    model.run(**sample)
    assert len(calls) == per_frame
    assert sorted(model.state_dict()) == sorted(create_model(name, device="cpu",
                                                             **{**kwargs, "conv3d_impl": "banded"}).state_dict())
