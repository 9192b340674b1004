"""mvsnet_train in the port vs the JAX package, from the ops up.

The same numpy inputs go through each JAX function and its port, on the
CPU; weights made by the JAX ``init`` (BatchNorm statistics and shifts
randomised, so that no BN is the identity) are bridged into the port with
``state_dict_from_jax``. Bounds:
- sampling, warps, reductions: float32 rounding of the same op order,
  atol/rtol 1e-6 (sampling) to 1e-5 (sums over the hypothesis axis);
- blocks: sums over up to 27 * 64 taps in another order, rtol 1e-4 with an
  atol of 1e-5 of the output's scale;
- the model: depth and uncertainty relative to their mean magnitude,
  mean <= 1e-5 and max <= 1e-4; the uncertainty's window index is a
  truncated float, so a pixel may pick another window where the index lies
  within rounding of an integer: at most 1% of the pixels may differ by more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.models.blocks import mvsnet as jax_blocks
from robustmvd_tpu.ops import reductions as jax_red
from robustmvd_tpu.ops.homography import homo_warp as jax_homo_warp
from robustmvd_tpu.ops.sampling import bilinear_sample as jax_bilinear_sample
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.blocks import mvsnet as blocks
from robustmvd_tpu_torch.models.mvsnet import unit_steps
from robustmvd_tpu_torch.models.weights import state_dict_from_jax, variables_from_state_dict
from robustmvd_tpu_torch.ops import reductions
from robustmvd_tpu_torch.ops.homography import homo_warp
from robustmvd_tpu_torch.ops.sampling import bilinear_sample

from torch_port_helpers import general_mvd_sample, randomized_variables, relative_errors, run_bridged_block, t


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bilinear_sample_matches_jax(rng, padding_mode):
    img = rng.randn(2, 7, 9, 5).astype(np.float32)
    x = rng.uniform(-2, 10, (2, 40)).astype(np.float32)
    y = rng.uniform(-2, 8, (2, 40)).astype(np.float32)
    x[0, :4] = [0.0, 8.0, -1.0, 8.5]  # exact edges and half-outside taps
    y[0, :4] = [0.0, 6.0, 3.0, -0.5]
    vals, mask = bilinear_sample(t(img), t(x), t(y), padding_mode)
    ref_vals, ref_mask = jax_bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), padding_mode)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    if padding_mode == "zeros":  # (border clamps every sample into the image)
        assert 0.1 < mask.numpy().mean() < 0.9


def test_bilinear_sample_sends_nonfinite_off_the_image(rng):
    img = rng.randn(1, 4, 5, 3).astype(np.float32)
    x = np.array([[np.nan, np.inf, -np.inf, 3e12, 1.5]], np.float32)
    y = np.array([[1.0, 1.0, 1.0, 1.0, np.nan]], np.float32)
    vals, mask = bilinear_sample(t(img), t(x), t(y))
    assert np.array_equal(vals.numpy(), np.zeros((1, 5, 3), np.float32))
    assert not mask.numpy().any()


def test_homo_warp_matches_jax(rng):
    B, h, w, C, D = 2, 12, 16, 4, 5
    src = rng.randn(B, h, w, C).astype(np.float32)
    K = np.array([[10.0, 0, 8], [0, 10.0, 6], [0, 0, 1]], np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    for b in range(B):
        for i in range(2):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = rng.randn(3) * 0.1 * i
            proj[b, i, :3, :4] = K @ pose[:3, :4]
    rpi = np.linalg.inv(proj[:, 0]).astype(np.float32)
    depths = np.stack([np.linspace(1, 8, D, dtype=np.float32)] * B)
    ours = homo_warp(t(src), t(proj[:, 1]), t(rpi), t(depths)).numpy()
    ref = np.asarray(jax_homo_warp(jnp.asarray(src), jnp.asarray(proj[:, 1]), jnp.asarray(rpi), jnp.asarray(depths)))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_reductions_match_jax(rng):
    vol = rng.randn(2, 12, 5, 6).astype(np.float32) * 3
    prob, idx, mass = reductions.soft_argmin(t(vol), axis=1, window=2)
    rprob, ridx, rmass = jax_red.soft_argmin(jnp.asarray(vol), axis=1, window=2)
    for a, b in ((prob, rprob), (idx, ridx), (mass, rmass)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(reductions.entropy(prob, 1).numpy(), np.asarray(jax_red.entropy(rprob, 1)),
                               atol=1e-5, rtol=1e-5)
    v2 = rng.randn(2, 5, 6, 16).astype(np.float32)
    v3 = rng.randn(2, 5, 6, 16).astype(np.float32)
    np.testing.assert_allclose(reductions.groupwise_correlation(t(v2), t(v3), 4, -1).numpy(),
                               np.asarray(jax_red.groupwise_correlation(jnp.asarray(v2), jnp.asarray(v3), 4, -1)),
                               atol=1e-5, rtol=1e-5)
    depths = rng.rand(2, 12).astype(np.float32)
    np.testing.assert_allclose(reductions.depth_regression(prob, t(depths), axis=1).numpy(),
                               np.asarray(jax_red.depth_regression(rprob, jnp.asarray(depths), axis=1)),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("num", [2, 48, 192, 256])
def test_depth_steps_are_jax_linspace(num):
    np.testing.assert_array_equal(unit_steps(num, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32)))


def test_deconv_layout_one_layer(rng):
    """The transposed 3D conv (flipped DHWIO in JAX) through the bridge, as
    CostRegNet's ``conv7``."""
    x = rng.randn(1, 3, 4, 5, 6).astype(np.float32)
    out, ref = run_bridged_block(jax_blocks.DeconvBnReLU3D(4), blocks.DeconvBnReLU3D(6, 4), x, rng, name="conv7")
    assert out.shape == (1, 4, 6, 8, 10) and ref.shape == (1, 6, 8, 10, 4)
    np.testing.assert_allclose(out.transpose(0, 2, 3, 4, 1), ref, atol=1e-5, rtol=1e-4)
    assert (ref > 0).mean() > 0.2


def test_feature_net_matches_jax(rng):
    x = rng.randn(2, 32, 40, 3).astype(np.float32)
    out, ref = run_bridged_block(jax_blocks.FeatureNet(), blocks.FeatureNet(), x, rng)
    np.testing.assert_allclose(out.transpose(0, 2, 3, 1), ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)


def test_cost_reg_net_matches_jax(rng):
    x = np.abs(rng.randn(1, 16, 8, 16, 32)).astype(np.float32)
    out, ref = run_bridged_block(jax_blocks.CostRegNet(), blocks.CostRegNet(), x, rng)
    np.testing.assert_allclose(out.transpose(0, 2, 3, 4, 1), ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)


@pytest.fixture(scope="module")
def jax_model():
    model = jax_create_model("mvsnet_train", pretrained=False, num_sampling_steps=16, warp_impl="xla")
    model.variables = randomized_variables(model.variables, np.random.RandomState(3), prob_gain=20.0)
    return model


def test_weights_round_trip(jax_model):
    port = create_model("mvsnet_train", device="cpu", num_sampling_steps=16)
    state = state_dict_from_jax(jax_model.variables)
    assert sorted(state) == sorted(port.state_dict())
    port.load_state_dict(state, strict=True)
    back, ref = _leaves(variables_from_state_dict(port.state_dict())), _leaves(jax_model.variables)
    assert sorted(back) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)


@pytest.mark.parametrize("depth_range", [None, (1.0, 10.0)])
def test_mvsnet_matches_jax(jax_model, depth_range):
    sample = general_mvd_sample(np.random.RandomState(5), 64, 96, 3)
    if depth_range is not None:
        sample["depth_range"] = tuple(np.array([v], np.float32) for v in depth_range)
    ref_pred, ref_aux = jax_model.run(**sample)
    port = create_model("mvsnet_train", device="cpu", num_sampling_steps=16)
    port.load_state_dict(state_dict_from_jax(jax_model.variables), strict=True)
    pred, aux = port.run(**sample)
    depth, ref_depth = pred["depth"], np.asarray(ref_pred["depth"])
    assert depth.shape == ref_depth.shape == (1, 1, 16, 24)
    mean, mx = relative_errors(depth, ref_depth)
    assert mean <= 1e-5 and mx <= 1e-4, (mean, mx)
    assert ref_depth.std() > 0.01 * ref_depth.mean()  # not vacuous: depth varies over the image
    unc, ref_unc = pred["depth_uncertainty"], np.asarray(ref_pred["depth_uncertainty"])
    close = np.abs(unc - ref_unc) <= 1e-4 * np.abs(ref_unc).mean()
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(aux["sampling_invdepths"], np.asarray(ref_aux["sampling_invdepths"]), rtol=1e-6)
