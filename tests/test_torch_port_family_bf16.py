"""The MVSNet family at bf16: the port's mixed precision vs the JAX package's.

``dtype="bfloat16"`` in both packages: parameters, BatchNorm statistics,
the score heads, the softmax and the depth regression float32; the
convolutions and the cost volumes bf16; the variance summed in float32. The
same numpy inputs and weights (JAX ``init``, randomised and bridged with
``state_dict_from_jax``) go through both packages on the CPU, where K5's
bf16 form runs its plain version (operands rounded to bf16, float32 sums,
one rounding), and JAX's K5 runs in interpret mode.

Tolerances:
- K5: both round one float32 sum per output to bf16, summed in another
  order, so a value may land one bf16 step apart: max |d| <= 2^-7 max |ref|
  (one step at the largest magnitude: 2^-8 for the rounding, 2^-8 for a sum
  on the other side of a rounding boundary), on at most 2% of the values;
- a block: mean |d| <= 1e-2 of mean |ref|, max |d| <= 5e-2 of max |ref|
  (``tests/test_torch_port_bf16.py``'s bounds: one-step flips carried through
  the layers; flax also adds a bf16 convolution's bias after rounding, a
  second rounding the port does not make);
- a model: depth scored as the benchmark scores it, JAX's bf16 depth as the
  ground truth: absrel < 1 point and 1.03-inliers > 97%, the bounds JAX
  holds its bf16 depth to against fp32 (``tests/test_family_bf16.py:93-94``);
  the uncertainty mean |d| <= 1e-2 (measured <= 1.5e-3), a probability mass
  that a one-hypothesis shift of a peaked softmax moves by up to 1.
  Measured: 0.067 / 0.24 / 0.13 points, 100 / 99.3 / 100% inliers for
  mvsnet / cvp / vis, where JAX's own bf16 is 0.067 / 0.26 / 0.14 points
  from its fp32. The random weights are conditioned as the float32 tests
  condition them (``test_torch_port_{mvsnet,cvp}.py``: score heads x 20, cvp
  on that test's sample), but vis's heads x 4: at x 20 its softmaxes are so
  peaked that JAX's own bf16 lies 2.1 points (86% inliers) from its fp32
  (the port's: 1.9 points, 85%). cvp's hypothesis spacing is a mean of
  one-pixel intervals over near-singular solves: on other random samples
  its depth leaves the depth range and JAX's own bf16 strays as far.

Maps are 64 x 80 or smaller, where every bf16 pixel grid of the JAX routes
is exact (up to 127.5: ``test_torch_port_family_warp_xla.py`` shows where it
stops being so).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.models.blocks import cvp_mvsnet as jax_cvp
from robustmvd_tpu.models.blocks import mvsnet as jax_mvs
from robustmvd_tpu.models.blocks import vis_mvsnet as jax_vis
from robustmvd_tpu.models.factory import cli_model_kwargs as jax_cli_model_kwargs
from robustmvd_tpu.ops.conv3d import conv3d_packed
from robustmvd_tpu.ops.pallas.conv3d import conv3d_banded_pallas
from robustmvd_tpu.ops.pallas.sweep_warp import homography_group_cost as jax_group_cost
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.blocks import cvp_mvsnet as port_cvp
from robustmvd_tpu_torch.models.blocks import mvsnet as port_mvs
from robustmvd_tpu_torch.models.blocks import vis_mvsnet as port_vis
from robustmvd_tpu_torch.models.factory import cli_model_kwargs
from robustmvd_tpu_torch.models.weights import state_dict_from_jax
from robustmvd_tpu_torch.ops.conv3d import Conv3d
from robustmvd_tpu_torch.ops import conv3d as port_conv3d
from robustmvd_tpu_torch.ops.kernels import sweep_group_cost as k2g
from robustmvd_tpu_torch.ops.kernels.conv3d import conv3d_banded

from test_torch_port_cuda import FAMILY_BF16_BOUNDS, FAMILY_HEAD_GAINS, _family_sample, conditioned_heads
from test_torch_port_group_cost import _cams, _depth_start, _kernel_args
from torch_port_helpers import (
    assert_depth_within_benchmark_bounds,
    family_sample,
    jax_family,
    randomized_variables,
    run_jax_family,
    t,
)

BF16 = torch.bfloat16
K5_LIMIT = 2.0**-7  # of max |ref|
K5_FLIP_SHARE = 0.02
BLOCK_BOUNDS = (1e-2, 5e-2)  # mean |d| / mean |ref|, max |d| / max |ref|
FAMILY = ("mvsnet_train", "cvp_mvsnet", "vis_mvsnet")


def _k5_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert ours.shape == ref.shape
    diff = np.abs(ours - ref)
    assert diff.max() <= K5_LIMIT * np.abs(ref).max(), (diff.max(), np.abs(ref).max())
    assert (diff > 0).mean() <= K5_FLIP_SHARE, (diff > 0).mean()


@pytest.mark.parametrize("cout", [8, 16])
def test_k5_plain_bf16_matches_jax_kernel_and_packed_dot(rng, cout):
    """K5's plain version at bf16 against the JAX kernel in interpret mode
    and the lane-packed XLA dot, both at bf16 with a float32 kernel cast as
    the TPU kernel casts it."""
    cin = 16 if cout == 8 else 8
    x = jnp.asarray(rng.randn(1, 6, 5, 20, cin), jnp.bfloat16)
    k = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    ours = conv3d_banded(t(np.asarray(x, np.float32)).to(BF16), t(k))
    assert ours.dtype == BF16
    ours = ours.float().numpy()
    pallas = conv3d_banded_pallas(x, jnp.asarray(k), interpret=True)
    packed = conv3d_packed(x, jnp.asarray(k).astype(jnp.bfloat16))
    assert pallas.dtype == packed.dtype == jnp.bfloat16
    _k5_close(ours, pallas)
    _k5_close(ours, packed)
    # channels first, as the U-Nets call it, is the same function
    cf = conv3d_banded(t(np.asarray(x, np.float32)).to(BF16).movedim(-1, 1), t(k), channels_first=True)
    np.testing.assert_array_equal(cf.movedim(1, -1).float().numpy(), ours)


def test_k5_score_head_stays_float32(rng):
    """A score head (Cout <= 4) is float32 in the JAX family; K5 refuses it
    at bf16 on either device and matches the JAX kernel at float32."""
    x = rng.randn(1, 5, 4, 12, 8).astype(np.float32)
    k = (rng.randn(3, 3, 3, 8, 1) / np.sqrt(27 * 8)).astype(np.float32)
    with pytest.raises(TypeError, match="score head"):
        conv3d_banded(t(x).to(BF16), t(k))
    ref = conv3d_banded_pallas(jnp.asarray(x), jnp.asarray(k), interpret=True)
    np.testing.assert_allclose(conv3d_banded(t(x), t(k)).numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# --- K2 group's bf16 form ---

def _k2_group_bf16_close_to_jax(rng, B, C, D, h, w, out_dtype, groups=8, per_pixel=True):
    """K2 group's plain version on bf16 features against JAX's
    ``homography_group_cost`` in interpret mode on the same features, within
    the bounds :func:`test_k2_group_plain_bf16_matches_jax_kernel` states;
    the features widened to float32 first miss them."""
    key, src = _cams(rng, B, h, w)
    A, Bm, wd = _kernel_args(key, src, _depth_start(rng, B, h, w, per_pixel), 0.25, D, h, w)
    ref, src_feat = (t(rng.randn(B, h, w, C).astype(np.float32)).to(BF16) for _ in range(2))
    jax_bf16 = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (ref, src_feat)]
    jax_out = np.asarray(jax_group_cost(*jax_bf16, *(jnp.asarray(a) for a in (A, Bm, wd)), groups=groups,
                                        interpret=True,
                                        out_dtype=jnp.bfloat16 if out_dtype == BF16 else jnp.float32), np.float32)
    tol = 5e-5 + 1e-4 * np.abs(jax_out) + (2.0**-8 * np.abs(jax_out) if out_dtype == BF16 else 0)
    ours = k2g.homography_group_cost(ref, src_feat, t(A), t(Bm), t(wd), groups=groups, out_dtype=out_dtype)
    assert ours.dtype == out_dtype and ours.shape == (B, D, h, w, groups)
    diff = np.abs(ours.float().numpy() - jax_out)
    assert (diff > tol).mean() <= 0.01, (diff > tol).mean()
    flip = (C // groups) * 2.0**-7 * float(ref.float().abs().max() * src_feat.float().abs().max())
    assert diff.max() <= flip + 2.0**-8 * np.abs(jax_out).max()
    assert (jax_out != 0).any(-1).mean() > 0.5
    widened = k2g.homography_group_cost(ref.float(), src_feat.float(), t(A), t(Bm), t(wd), groups=groups,
                                        out_dtype=out_dtype)
    assert (np.abs(widened.float().numpy() - jax_out) > tol).mean() > 0.1


@pytest.mark.parametrize("B,C,D,w,out_dtype", [(1, 16, 6, 20, torch.float32), (2, 32, 20, 20, BF16),
                                               (1, 32, 8, 160, torch.float32), (1, 32, 8, 160, BF16)])
def test_k2_group_plain_bf16_matches_jax_kernel(rng, B, C, D, w, out_dtype):
    """K2 group on bf16 features vs JAX's ``homography_group_cost`` on the
    same bf16 features in interpret mode (its bf16 ``samp_dtype``: x-tents
    rounded to bf16, rows and sums float32), as vis_mvsnet's bf16 fused
    route calls both. The two form the coordinates in the same order but not
    bit for bit: where a coordinate one float32 ulp apart moves an x-tent
    across a bf16 rounding boundary, that tent moves by one bf16 step. So at
    most 1% of the values lie beyond the float32 tolerance (plus one bf16
    step of the value for a bf16 output; measured <= 0.15%), each within
    the flip bound (C/G) 2^-7 max|ref| max|src|. Widening the features to
    float32 before sampling puts 24-85% of the values beyond it."""
    _k2_group_bf16_close_to_jax(rng, B, C, D, 12 if w < 100 else 24, w, out_dtype)


@pytest.mark.parametrize("h,w,D,G,per_pixel", [
    (6, 20, 8, 8, False),  # vis stage 1's aspect (48x160 / 8), its w one value per plane expanded to every pixel
    (6, 20, 8, 8, True),
    (12, 40, 4, 8, True),  # stage 2's (96x320 / 8), per-pixel w
    (24, 80, 2, 8, True),  # stage 3's (192x640 / 8)
    (12, 40, 4, 4, True),  # G 4 and 16 at C 32: the lane route's other groupings on the card
    (12, 40, 4, 16, True),
])
def test_k2_group_plain_bf16_at_vis_stage_aspects_matches_jax_kernel(rng, h, w, D, G, per_pixel):
    """The bounds of :func:`test_k2_group_plain_bf16_matches_jax_kernel` at
    vis_mvsnet's three stage aspects cut to an eighth (hypotheses too), bf16
    out as the bf16 model asks: w per plane as stage 1 passes it and per
    pixel as stages 2-3 pass it, and G 4 and 16."""
    _k2_group_bf16_close_to_jax(rng, 1, 32, D, h, w, BF16, groups=G, per_pixel=per_pixel)


def test_k2_group_rejects_mixed_feature_dtypes(rng):
    ref = t(rng.randn(1, 4, 5, 16).astype(np.float32))
    A, Bm = t(np.tile(np.eye(3, dtype=np.float32), (1, 1, 1))), t(np.zeros((1, 3, 3), np.float32))
    wd = t(np.ones((1, 2, 4, 5), np.float32))
    with pytest.raises(TypeError, match="features must both be"):
        k2g.homography_group_cost(ref, ref.to(BF16), A, Bm, wd)
    with pytest.raises(TypeError, match="Amat must be float32"):
        k2g.homography_group_cost(ref.to(BF16), ref.to(BF16), A.to(BF16), Bm, wd)


def _block_close(ours, ref, what):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert ours.shape == ref.shape, what
    diff = np.abs(ours - ref)
    mean, mx = diff.mean() / (np.abs(ref).mean() + 1e-12), diff.max() / (np.abs(ref).max() + 1e-12)
    assert mean <= BLOCK_BOUNDS[0] and mx <= BLOCK_BOUNDS[1], f"{what}: mean {mean:.3g}, max {mx:.3g}"


def _run_bf16_block(jax_module, port_module, x, rng, x_dtype=jnp.float32, **kwargs):
    """Init the flax block on channel-last ``x``, randomise and bridge its
    variables, run both on ``x`` in ``x_dtype``: lists of (port output
    channel-last, JAX output)."""
    variables = randomized_variables(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs), rng)
    variables = {"params": {}, "batch_stats": {}, **variables}
    port_module.load_state_dict(state_dict_from_jax(variables), strict=True)
    port_module.eval()
    ref = jax_module.apply(variables, jnp.asarray(x, x_dtype), **kwargs)
    with torch.no_grad():
        out = port_module(t(x).to(BF16 if x_dtype == jnp.bfloat16 else torch.float32).movedim(-1, 1), **kwargs)
    listed = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]  # noqa: E731
    return [o.movedim(1, -1) for o in listed(out)], listed(ref)


def _check_outputs(outs, refs, dtype, what):
    assert len(outs) == len(refs), what
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == dtype and r.dtype == (jnp.bfloat16 if dtype == BF16 else jnp.float32), (what, i)
        _block_close(o.float().numpy(), r, f"{what}[{i}]")


def test_mvsnet_blocks_at_bf16(rng):
    x = rng.randn(2, 32, 40, 3).astype(np.float32)
    _check_outputs(*_run_bf16_block(jax_mvs.FeatureNet(dtype=jnp.bfloat16), port_mvs.FeatureNet(BF16), x, rng),
                   BF16, "FeatureNet")
    v = np.abs(rng.randn(1, 16, 8, 16, 32)).astype(np.float32)
    for impl in ("banded", "xla"):
        outs, refs = _run_bf16_block(jax_mvs.CostRegNet(dtype=jnp.bfloat16, conv3d_impl=impl),
                                     port_mvs.CostRegNet(conv3d_impl=impl, dtype=BF16), v, rng,
                                     x_dtype=jnp.bfloat16)
        _check_outputs(outs, refs, torch.float32, f"CostRegNet {impl}")  # the prob head is float32


def test_cvp_blocks_at_bf16(rng):
    img = rng.rand(2, 32, 48, 3).astype(np.float32)
    _check_outputs(*_run_bf16_block(jax_cvp.FeaturePyramid(dtype=jnp.bfloat16), port_cvp.FeaturePyramid(BF16), img,
                                    rng, scales=3), BF16, "FeaturePyramid")
    v = np.abs(rng.randn(1, 8, 8, 12, 16)).astype(np.float32)
    outs, refs = _run_bf16_block(jax_cvp.CostRegNet(dtype=jnp.bfloat16, conv3d_impl="banded"),
                                 port_cvp.CostRegNet(conv3d_impl="banded", dtype=BF16), v, rng)
    _check_outputs([o.movedim(-1, 1) for o in outs], refs, torch.float32, "CostRegNet")  # (B, D, h, w) logits


def test_vis_blocks_at_bf16(rng):
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    _check_outputs(*_run_bf16_block(jax_vis.FeatExt(dtype=jnp.bfloat16), port_vis.FeatExt(BF16), x, rng),
                   BF16, "FeatExt")
    cost = rng.randn(2, 8, 12, 16, 8).astype(np.float32)  # the "xla" route's float32 pair volumes
    _check_outputs(*_run_bf16_block(jax_vis.Reg(dtype=jnp.bfloat16, conv3d_impl="banded"),
                                    port_vis.Reg("banded", BF16), cost, rng), BF16, "Reg")
    # the fused volume is float32, the fused regulariser bf16, its head float32
    _check_outputs(*_run_bf16_block(jax_vis.RegFuse(dtype=jnp.bfloat16, conv3d_impl="banded"),
                                    port_vis.RegFuse("banded", BF16), cost, rng), torch.float32, "RegFuse")
    # the pair head takes the bf16 regulariser output in float32
    _check_outputs(*_run_bf16_block(jax_vis.RegPair(conv3d_impl="banded"), port_vis.RegPair("banded"), cost, rng,
                                    x_dtype=jnp.bfloat16), torch.float32, "RegPair")


# --- the three models ---

def bf16_k5_calls(model):
    """Count the forwards of the model's K5 convolutions at bf16 (on the CPU
    the wrapper runs its plain version, which is not a launch)."""
    calls = []
    for m in model.modules():
        if isinstance(m, Conv3d) and m.impl == "banded" and m.compute_dtype == BF16:
            m.register_forward_hook(lambda *_: calls.append(1))
    return calls


@pytest.mark.parametrize("name", FAMILY)
def test_family_model_at_bf16_matches_jax(name):
    """Each model at its defaults (the port's fused routes; JAX's fused
    kernels in interpret mode for vis, whose stage-1 maps are narrower than
    the XLA route's clamp leaves alone, and JAX's XLA routes for mvsnet and
    cvp, which compute the fused kernel's function): the port's bf16 depth
    within the benchmark's bounds of JAX's bf16 depth; vis's default runs
    K5 at bf16 24 times a frame (its 6 score heads in float32)."""
    module, variables, adapter, kwargs = jax_family(name, "pallas" if name == "vis_mvsnet" else "xla", "bfloat16")
    sample = family_sample(name)
    ref_pred, _ = run_jax_family(module, variables, adapter, sample)
    port = create_model(name, device="cpu", dtype="bfloat16", **kwargs)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    calls = bf16_k5_calls(port)
    pred, _ = port.run(**sample)
    assert len(calls) == (24 if name == "vis_mvsnet" else 0)
    assert_depth_within_benchmark_bounds(pred["depth"], ref_pred["depth"], ref_pred["depth_uncertainty"],
                                         pred["depth_uncertainty"])
    # not vacuous: the bf16 forward is not the float32 one
    fp32 = create_model(name, device="cpu", **kwargs)
    fp32.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert not np.array_equal(fp32.run(**sample)[0]["depth"], pred["depth"])


@pytest.mark.parametrize("name", FAMILY)
def test_bf16_state_dict_is_the_float32_one(name):
    """dtype changes no parameter: the same names, float32 values and
    buffers, equal to the float32 model's from the same seed."""
    kwargs = {"num_sampling_steps": 8} if name == "mvsnet_train" else {}
    m32 = create_model(name, device="cpu", seed=1, **kwargs).state_dict()
    m16 = create_model(name, device="cpu", seed=1, dtype="bfloat16", **kwargs).state_dict()
    assert list(m16) == list(m32)
    for key, value in m16.items():
        assert value.dtype == m32[key].dtype and torch.equal(value, m32[key]), key
    assert {v.dtype for v in m16.values() if v.is_floating_point()} == {torch.float32}


@pytest.mark.parametrize("name", FAMILY)
def test_family_takes_dtype_through_create_model(name):
    model = create_model(name, device="cpu", dtype="bf16")
    assert model.compute_dtype == BF16 and all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        create_model(name, device="cpu", dtype="float16")


@pytest.mark.parametrize("name", FAMILY)
def test_family_dtype_flag_is_refused_as_jax_refuses_it(name):
    """The CLIs' ``--dtype`` stays robust_mvd's only: both packages' gates
    refuse it for the family, and neither passes anything without it."""
    for gate in (jax_cli_model_kwargs, cli_model_kwargs):
        with pytest.raises(SystemExit, match=f"only supported by the robust_mvd family, not {name}"):
            gate(name, "bfloat16")
        assert gate(name, None) == {}


# --- the bound of the card's bf16 family tests ---

def _card_test_depth(name, dtype="bfloat16", **kwargs):
    """Depth of the conditioned random model on the card test's sample, on
    the CPU."""
    model = conditioned_heads(create_model(name, device="cpu", seed=0, dtype=dtype, **kwargs), name)
    return model.run(**_family_sample(6, 128, 192))[0]["depth"]


def _card_scores(depth, ref):
    from robustmvd_tpu_torch.eval.metrics import m_rel_ae, thresh_inliers

    ones = np.ones_like(ref)
    return (m_rel_ae(gt=ref, pred=depth, mask=ones, output_scaling_factor=100.0),
            thresh_inliers(gt=ref, pred=depth, thresh=1.03, mask=ones, output_scaling_factor=100.0))


@pytest.mark.parametrize("name", FAMILY)
def test_card_bound_sits_above_the_conditioned_bf16_noise(name):
    """With its heads scaled by FAMILY_HEAD_GAINS, each random model's bf16
    depth lies under 0.3 points of absrel and above 99.5% 1.03-inliers from
    its fp32 depth (measured 0.24 / 0.12 / 0.21 points, 100%), well inside
    the card test's bounds, and its depth varies (std over mean > 5%): the
    card's and the CPU's bf16 convolutions round apart by less than that."""
    bf16, fp32 = _card_test_depth(name), _card_test_depth(name, "float32")
    absrel, inliers = _card_scores(bf16, fp32)
    assert absrel < 0.3 and inliers > 99.5, (absrel, inliers)
    assert absrel < FAMILY_BF16_BOUNDS["absrel"] and inliers > FAMILY_BF16_BOUNDS["inliers"]
    assert fp32.std() > 5e-2 * np.abs(fp32).mean()


def _k5_drop_corner(conv):
    def faulty(x, k, bias=None, **kwargs):
        if x.dtype == BF16:
            k = k.clone()
            k[0, 0, 0] = 0
        return conv(x, k, bias, **kwargs)
    return faulty


def _k2_group_drop_channel(cost):
    def faulty(ref, src, *args, **kwargs):
        ref = ref.clone()
        ref[..., -1] = 0
        return cost(ref, src, *args, **kwargs)
    return faulty


@pytest.mark.parametrize("name,kwargs,fault", [
    ("vis_mvsnet", {}, "k5_drop_corner"),
    ("vis_mvsnet", {}, "k2_group_drop_channel"),
    ("mvsnet_train", {"conv3d_impl": "banded", "warp_impl": "xla"}, "k5_drop_corner"),
])
def test_card_bound_rejects_planted_faults(monkeypatch, name, kwargs, fault):
    """A kernel fault of the bf16 path, planted in the plain version the
    CPU runs, moves the conditioned model's bf16 depth beyond the card
    test's bounds: K5 bf16 without its corner tap (measured 6.6 points and
    30% inliers on vis, 0.74 points on mvsnet's three K5 convolutions), K2
    group with the key's last channel zeroed (2.9 points)."""
    from robustmvd_tpu_torch.models.blocks import vis_mvsnet as vis_blocks

    good = _card_test_depth(name, **kwargs)
    if fault == "k5_drop_corner":
        monkeypatch.setattr(port_conv3d, "conv3d_banded", _k5_drop_corner(port_conv3d.conv3d_banded))
    else:
        monkeypatch.setattr(vis_blocks, "homography_group_cost", _k2_group_drop_channel(k2g.homography_group_cost))
    absrel, inliers = _card_scores(_card_test_depth(name, **kwargs), good)
    assert not (absrel < FAMILY_BF16_BOUNDS["absrel"] and inliers > FAMILY_BF16_BOUNDS["inliers"]), (absrel, inliers)


def test_chip_smoke_holds_the_card_tests_gains_and_bounds():
    """``chip_smoke.py``'s ``parity_family_bf16`` conditions the models and
    bounds the card's depth exactly as the card tests do (two copies: the
    script imports nothing of the tests)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FAMILY_HEAD_GAINS == FAMILY_HEAD_GAINS
    assert smoke.FAMILY_BF16_BOUNDS == FAMILY_BF16_BOUNDS
