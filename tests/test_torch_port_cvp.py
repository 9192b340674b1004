"""cvp_mvsnet in the port vs the JAX package, from the geometry up.

The same numpy inputs go through each JAX function and its port on the CPU;
weights come from the JAX ``init``, randomised (BatchNorm statistics,
shifts, biases) and bridged. Bounds:
- bicubic x2 (``jax.image.resize``): rtol 1e-6, atol 1e-6 of the input's
  scale (the same weights, contracted in another order);
- the hypothesis interval: rtol 1e-5 (a mean over pixels of a float32
  Cramer solve, products in another order); NaN where JAX gives NaN;
- the coarse hypotheses: bit-equal;
- blocks: rtol 1e-4 with an atol of 1e-5 of the output's scale;
- the model (nscale 3): depth and uncertainty relative to their mean
  magnitude, mean <= 1e-5 and max <= 1e-4, with at most 1% of the
  uncertainty pixels off (another 4-tap window where the truncated index
  lies within rounding of an integer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.models.blocks import cvp_mvsnet as jax_blocks
from robustmvd_tpu.models.cvp_mvsnet import _resize_bicubic_x2 as jax_bicubic_x2
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.blocks import cvp_mvsnet as blocks
from robustmvd_tpu_torch.models.weights import state_dict_from_jax, variables_from_state_dict
from robustmvd_tpu_torch.ops.interpolate import resize_bicubic_x2

from torch_port_helpers import (
    general_mvd_sample,
    random_pose,
    randomized_variables,
    relative_errors,
    run_bridged_block,
    t,
)


@pytest.mark.parametrize("shape", [(1, 3, 5), (2, 24, 80), (1, 1, 2), (1, 12, 40)])
def test_bicubic_x2_matches_jax_image_resize(rng, shape):
    x = (rng.rand(*shape) * 10).astype(np.float32)
    ours = resize_bicubic_x2(t(x)).numpy()
    ref = np.asarray(jax_bicubic_x2(jnp.asarray(x)))
    assert ours.shape == ref.shape == (shape[0], 2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * 10)


def test_bicubic_x2_is_not_torch_bicubic(rng):
    """The JAX reference's choice (a = -0.5, edge taps renormalised) differs
    from F.interpolate's (a = -0.75, edge taps clamped)."""
    x = (rng.rand(1, 6, 7) * 10).astype(np.float32)
    torch_bicubic = torch.nn.functional.interpolate(t(x)[:, None], scale_factor=2, mode="bicubic",
                                                    align_corners=False)[:, 0]
    assert np.abs(resize_bicubic_x2(t(x)).numpy() - torch_bicubic.numpy()).max() > 1e-2


def _cameras(rng, B, rotate=True):
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]], np.float32), (B, 1, 1))
    ref_ex = np.stack([random_pose(rng, scale=0.1) for _ in range(B)]).astype(np.float32)
    src_ex = np.stack([random_pose(rng, scale=0.2) if rotate else np.eye(4, dtype=np.float32)
                       for _ in range(B)]).astype(np.float32)
    if not rotate:
        src_ex[:, 0, 3] = 0.2
    return K, K * 1.05, ref_ex, src_ex


def test_depth_hypo_interval_matches_jax(rng):
    B, H, W = 2, 24, 32
    depths = (1.0 + rng.rand(B, H, W) * 5).astype(np.float32)
    K_ref, K_src, ref_ex, src_ex = _cameras(rng, B)
    ours = blocks.cal_depth_hypo_interval(t(depths), t(K_ref), t(K_src), t(ref_ex), t(src_ex)).numpy()
    ref = np.asarray(jax_blocks.cal_depth_hypo_interval(*(jnp.asarray(a) for a in
                                                          (depths, K_ref, K_src, ref_ex, src_ex))))
    assert np.isfinite(ref).all() and (ref > 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    hypos = blocks.cal_depth_hypos(t(depths), t(K_ref), t(K_src), t(ref_ex), t(src_ex)).numpy()
    ref_h = np.asarray(jax_blocks.cal_depth_hypos(*(jnp.asarray(a) for a in (depths, K_ref, K_src, ref_ex, src_ex))))
    assert hypos.shape == (B, 8, H, W)
    np.testing.assert_allclose(hypos, ref_h, rtol=1e-5, atol=1e-5)


def test_depth_hypo_interval_degenerate_case(rng):
    """Identical cameras: the points of depths d and d+1 project to the same
    pixel, arctan(0/0) is NaN, and so is the interval, in JAX and the port."""
    B, H, W = 1, 6, 8
    depths = (1.0 + rng.rand(B, H, W)).astype(np.float32)
    K = np.tile(np.array([[10.0, 0, 4], [0, 10.0, 3], [0, 0, 1]], np.float32), (B, 1, 1))
    ex = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ours = blocks.cal_depth_hypo_interval(t(depths), t(K), t(K), t(ex), t(ex)).numpy()
    ref = np.asarray(jax_blocks.cal_depth_hypo_interval(*(jnp.asarray(a) for a in (depths, K, K, ex, ex))))
    assert np.isnan(ref).all() and np.isnan(ours).all()
    # a pure sideways shift without rotation makes the 2x2 system singular
    src_ex = _cameras(rng, B, rotate=False)[3]
    ours = blocks.cal_depth_hypo_interval(t(depths), t(K), t(K), t(ex), t(src_ex)).numpy()
    ref = np.asarray(jax_blocks.cal_depth_hypo_interval(*(jnp.asarray(a) for a in (depths, K, K, ex, src_ex))))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))


def test_coarse_hypotheses_and_intrinsics_match_jax(rng):
    lo = np.array([0.5, 2.0], np.float32)
    hi = np.array([37.0, 9.0], np.float32)
    ours = blocks.cal_sweeping_depth_hypos(t(lo), t(hi), 48).numpy()
    ref = np.asarray(jax_blocks.cal_sweeping_depth_hypos(jnp.asarray(lo), jnp.asarray(hi), 48))
    np.testing.assert_array_equal(ours, ref)  # the first sample's range for the batch
    K = (rng.rand(2, 3, 3) * 100).astype(np.float32)
    shapes = [(96, 128), (48, 64), (24, 32)]
    np.testing.assert_array_equal(blocks.condition_intrinsics(t(K), (96, 128), shapes).numpy(),
                                  np.asarray(jax_blocks.condition_intrinsics(jnp.asarray(K), (96, 128), shapes)))


def test_cost_reg_net_matches_jax(rng):
    """cvp's CostRegNet, with its stride-1 and stride-2 transposed convs."""
    x = np.abs(rng.randn(1, 8, 8, 12, 16)).astype(np.float32)
    out, ref = run_bridged_block(jax_blocks.CostRegNet(), blocks.CostRegNet(), x, rng)
    assert out.shape == ref.shape == (1, 8, 8, 12)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)


def test_feature_pyramid_matches_jax(rng):
    x = rng.rand(2, 32, 48, 3).astype(np.float32)
    jax_fp, fp = jax_blocks.FeaturePyramid(), blocks.FeaturePyramid()
    variables = jax_fp.init(jax.random.PRNGKey(2), jnp.asarray(x), 3)
    variables = randomized_variables(variables, rng)
    fp.load_state_dict(state_dict_from_jax({**variables, "batch_stats": {}}), strict=True)
    refs = jax_fp.apply(variables, jnp.asarray(x), 3)
    with torch.no_grad():
        outs = fp(t(x).permute(0, 3, 1, 2), 3)
    assert len(outs) == len(refs) == 3
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)


@pytest.fixture(scope="module")
def jax_model():
    model = jax_create_model("cvp_mvsnet", pretrained=False, nscale=3, warp_impl="xla")
    model.variables = randomized_variables(model.variables, np.random.RandomState(4), prob_gain=20.0)
    return model


@pytest.fixture(scope="module")
def port_model(jax_model):
    port = create_model("cvp_mvsnet", device="cpu", nscale=3)
    port.load_state_dict(state_dict_from_jax(jax_model.variables), strict=True)
    return port


def test_weights_round_trip(jax_model, port_model):
    back = variables_from_state_dict(port_model.state_dict())
    leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(back)}
    ref = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(jax_model.variables)}
    assert sorted(leaves) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(leaves[key], ref[key], err_msg=key)


def test_cvp_mvsnet_matches_jax(jax_model, port_model):
    sample = general_mvd_sample(np.random.RandomState(6), 64, 128, 3)
    ref_pred, ref_aux = jax_model.run(**sample)
    pred, aux = port_model.run(**sample)
    depth, ref_depth = pred["depth"], np.asarray(ref_pred["depth"])
    assert depth.shape == ref_depth.shape == (1, 1, 64, 128)
    assert np.isfinite(ref_depth).all() and ref_depth.std() > 1e-3 * np.abs(ref_depth).mean()
    mean, mx = relative_errors(depth, ref_depth)
    assert mean <= 1e-5 and mx <= 1e-4, (mean, mx)
    for ours, ref in zip(aux["depths_all"], ref_aux["depths_all"]):
        mean, mx = relative_errors(ours, np.asarray(ref))
        assert mean <= 1e-5 and mx <= 1e-4, (ours.shape, mean, mx)
    unc, ref_unc = pred["depth_uncertainty"], np.asarray(ref_pred["depth_uncertainty"])
    close = np.abs(unc - ref_unc) <= 1e-4 * np.abs(ref_unc).mean()
    assert close.mean() >= 0.99, close.mean()
