"""The MVSNet family's training pieces below the models: the port vs JAX.

- The four losses (``SL1Loss``, ``mvsnet_loss``, ``vismvsnet_loss`` and its
  class-name entry ``VismvnsetMultiscaleMultiviewAggregate``) on random
  predictions and ground truth with holes and values outside the hypothesis
  range: the loss within rtol 1e-6 and its gradient with respect to every
  prediction within rtol 1e-5 of ``jax.grad`` (atol 1e-6 of the gradient's
  largest |value|, for the entries that sums in another order leave near 0).
- The family's BatchNorm (``ops/layers.py``) in training against flax's
  ``nn.BatchNorm(momentum=0.9, use_running_average=False)``, 2D and 3D,
  float32 and bf16 input: output, new running mean and new running variance
  within rtol 1e-6; a bf16 output is one rounding of float32 values that
  agree to 1e-6, so it may differ by one bf16 step (2^-8 relative) where they
  straddle a rounding edge, on at most 0.1% of the values. torch's own
  BatchNorm misses the variance at a 4x5 map.
- K3's closed-form backward (``soft_argmin_backward``, what the card's
  autograd Function runs) against ``jax.grad`` of JAX's ``soft_argmin`` +
  ``entropy`` and against autograd through the port's plain version: rtol
  1e-5 (atol 1e-6 of the largest |value|), D 16/32/64, window 2.

The port's maps are NCHW, the JAX losses' channel-last.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.loss import create_loss as jax_create_loss
from robustmvd_tpu.ops.reductions import entropy as jax_entropy
from robustmvd_tpu.ops.reductions import soft_argmin as jax_soft_argmin
from robustmvd_tpu_torch import create_loss
from robustmvd_tpu_torch.ops import layers
from robustmvd_tpu_torch.ops.kernels.soft_argmin import fused_soft_argmin_reference, soft_argmin_backward

from torch_port_helpers import t, torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def _assert_close(ours, ref, rtol, name):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=1e-6 * (np.abs(ref).max() + 1e-30), err_msg=name)


def _depth_gt(rng, B, H, W, lo, hi):
    """Depth in [lo, hi], with holes (0) and values outside the range."""
    gt = rng.uniform(lo, hi, size=(B, 1, H, W)).astype(np.float32)
    gt[:, :, ::5, ::3] = 0.0
    gt[:, :, 1::7, ::4] = hi * 3.0
    gt[:, :, 2::9, 1::5] = lo * 0.3
    return gt


# ---- the losses ---------------------------------------------------------


def _sl1_case(rng, with_masks):
    B, H, W, h, w = 2, 32, 40, 16, 20
    gt = _depth_gt(rng, B, H, W, 1.0, 10.0)
    preds = {"depth": rng.uniform(0.5, 11.0, size=(B, 1, h, w)).astype(np.float32)}
    masks = (rng.rand(B, H, W) > 0.3).astype(np.float32) if with_masks else None

    def port(p):
        inputs = {} if masks is None else {"masks": t(masks)}
        return create_loss("SL1Loss")(inputs, {"depth": t(gt)}, {"depth": p["depth"]}, {}, iteration=0)[0]

    def jax_fn(p):
        inputs = {} if masks is None else {"masks": jnp.asarray(masks)}
        return jax_create_loss("SL1Loss")(inputs, {"depth": _nhwc(gt)}, {"depth": p["depth"]}, {}, iteration=0)[0]

    return preds, port, jax_fn, {"depth": (0, 2, 3, 1)}


def _mvsnet_case(rng):
    B, H, W, h, w, S = 2, 32, 40, 8, 10, 16
    gt = _depth_gt(rng, B, H, W, 1.0, 10.0)
    lo = np.array([1.0, 2.0], np.float32)[:, None]
    depth_samples = lo + np.linspace(0, 1, S, dtype=np.float32)[None] * np.array([9.0, 6.0], np.float32)[:, None]
    invdepths = (1.0 / depth_samples[:, ::-1]).astype(np.float32)
    preds = {"depth": rng.uniform(0.5, 11.0, size=(B, 1, h, w)).astype(np.float32)}

    def port(p):
        return create_loss("mvsnet_loss")({}, {"depth": t(gt)}, {}, {"depth": p["depth"], "sampling_invdepths": t(invdepths)},
                                          iteration=0)[0]

    def jax_fn(p):
        aux = {"depth": p["depth"], "sampling_invdepths": jnp.asarray(invdepths)}
        return jax_create_loss("mvsnet_loss")({}, {"depth": _nhwc(gt)}, {}, aux, iteration=0, params=None)[0]

    return preds, port, jax_fn, {"depth": (0, 2, 3, 1)}


def _vis_case(rng, name):
    B, H, W = 2, 64, 80
    start, interval = np.array([1.0, 2.0], np.float32), np.array([0.05, 0.04], np.float32)
    ref_cam = np.zeros((B, 2, 4, 4), np.float32)
    ref_cam[:, 1, 3, 0], ref_cam[:, 1, 3, 1] = start, interval
    gt = _depth_gt(rng, B, H, W, 1.2, 10.0)  # depth_end = start + 190 interval: 10.5 and 9.6
    preds = {}
    for k, (s, pair_s) in enumerate((((8, 10), (8, 10)), ((16, 20), (16, 20)), ((32, 40), (32, 40)))):
        preds[f"est{k}"] = rng.uniform(1.0, 11.0, size=(B, 1, *s)).astype(np.float32)
        for p in range(2):
            preds[f"pair{k}_{p}"] = rng.uniform(1.0, 11.0, size=(B, 1, *pair_s)).astype(np.float32)
            for u in range(2):
                preds[f"unc{k}_{p}_{u}"] = rng.randn(B, 1, *pair_s).astype(np.float32)

    def outputs(p):
        return [[p[f"est{k}"], [[p[f"pair{k}_{q}"], [p[f"unc{k}_{q}_{u}"] for u in range(2)]] for q in range(2)]]
                for k in range(3)]

    def port(p):
        return create_loss(name)({}, {"depth": t(gt)}, {}, {"outputs": outputs(p), "ref_cam": t(ref_cam)},
                                 iteration=0)[0]

    def jax_fn(p):
        aux = {"outputs": outputs(p), "ref_cam": jnp.asarray(ref_cam)}
        return jax_create_loss(name)({}, {"depth": _nhwc(gt)}, {}, aux, iteration=0, params=None)[0]

    return preds, port, jax_fn, {}


CASES = {
    "SL1Loss": lambda rng: _sl1_case(rng, with_masks=False),
    "SL1Loss_masks": lambda rng: _sl1_case(rng, with_masks=True),
    "mvsnet_loss": _mvsnet_case,
    "vismvsnet_loss": lambda rng: _vis_case(rng, "vismvsnet_loss"),
    "VismvnsetMultiscaleMultiviewAggregate": lambda rng: _vis_case(rng, "VismvnsetMultiscaleMultiviewAggregate"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradient_match_jax(rng, case):
    preds, port, jax_fn, channel_last = CASES[case](rng)
    leaves = {k: t(v).requires_grad_() for k, v in preds.items()}
    total = port(leaves)
    total.backward()
    jax_preds = {k: jnp.transpose(jnp.asarray(v), channel_last[k]) if k in channel_last else jnp.asarray(v)
                 for k, v in preds.items()}
    j_total, j_grads = jax.value_and_grad(jax_fn)(jax_preds)
    assert np.isfinite(float(j_total)) and float(j_total) > 0
    _assert_close(float(total.detach()), float(j_total), 1e-6, "loss")
    for k, leaf in leaves.items():
        j = np.asarray(j_grads[k])
        if k in channel_last:
            j = np.moveaxis(j, -1, 1)
        if k.startswith("unc") and k.endswith("_1"):  # the second uncertainty head feeds no loss
            assert leaf.grad is None and not np.any(j), k
            continue
        assert np.abs(j).max() > 0, k
        _assert_close(leaf.grad.numpy(), j, 1e-5, f"d loss / d {k}")


def test_vis_loss_ignores_out_of_range_ground_truth(rng):
    """Pixels whose ground truth leaves [start, start + 190 interval] take
    no gradient: the masks are not vacuous."""
    preds, port, _, _ = _vis_case(rng, "vismvsnet_loss")
    leaves = {k: t(v).requires_grad_() for k, v in preds.items()}
    port(leaves).backward()
    grad = leaves["est2"].grad.numpy()
    assert (grad == 0).mean() > 0.1 and (grad != 0).mean() > 0.5


# ---- BatchNorm in training ------------------------------------------------


def _flax_bn_step(x_cl, dtype, params, stats):
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=dtype)
    y, mutated = bn.apply({"params": params, "batch_stats": stats}, x_cl, mutable=["batch_stats"])
    return np.asarray(y.astype(jnp.float32)), mutated["batch_stats"]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_matches_flax(rng, dim, dtype):
    C = 8
    shape = (2, C, 6, 7, 9)[: dim + 2]
    x = (rng.randn(*shape) * 2.0 + rng.randn(1, C, *(1,) * dim)).astype(np.float32)
    scale, bias = (0.8 + 0.4 * rng.rand(C)).astype(np.float32), (rng.randn(C) * 0.1).astype(np.float32)
    mean, var = (rng.randn(C) * 0.1).astype(np.float32), (0.5 + rng.rand(C)).astype(np.float32)

    bn = (layers.BatchNorm2d if dim == 2 else layers.BatchNorm3d)(C, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(t(scale)), bn.bias.copy_(t(bias))
        bn.running_mean.copy_(t(mean)), bn.running_var.copy_(t(var))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    y = bn.train()(t(x).to(tdt))
    assert y.dtype == tdt

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    y_ref, stats = _flax_bn_step(jnp.asarray(np.moveaxis(x, 1, -1)).astype(jdt), jdt,
                                 {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                 {"mean": jnp.asarray(mean), "var": jnp.asarray(var)})
    y_ref = np.moveaxis(y_ref, -1, 1)
    if dtype == "float32":
        _assert_close(y.detach().numpy(), y_ref, 1e-6, "output")
    else:
        diff = np.abs(y.float().detach().numpy() - y_ref)
        assert (diff <= 2.0 ** -8 * np.abs(y_ref)).all() and (diff > 0).mean() <= 1e-3, diff.max()
    _assert_close(bn.running_mean.numpy(), stats["mean"], 1e-6, "running mean")
    _assert_close(bn.running_var.numpy(), stats["var"], 1e-6, "running var")

    # eval: the running statistics, as torch's own BatchNorm
    stock = (torch.nn.BatchNorm2d if dim == 2 else torch.nn.BatchNorm3d)(C, eps=1e-5)
    stock.load_state_dict(bn.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(bn.eval()(t(x)), stock.eval()(t(x)), rtol=0, atol=0)


def test_stock_batchnorm_misses_the_variance_at_a_small_map(rng):
    """At a 4x5 map (n = 40 per channel) torch's BatchNorm moves its running
    variance towards n / (n - 1) of the batch variance: 2.5% off flax."""
    x = rng.randn(2, 8, 4, 5).astype(np.float32)
    ours = layers.BatchNorm2d(8, eps=1e-5).train()
    stock = torch.nn.BatchNorm2d(8, eps=1e-5).train()
    ours(t(x)), stock(t(x))
    _, stats = _flax_bn_step(jnp.asarray(np.moveaxis(x, 1, -1)), jnp.float32,
                             {"scale": jnp.ones(8), "bias": jnp.zeros(8)}, {"mean": jnp.zeros(8), "var": jnp.ones(8)})
    _assert_close(ours.running_var.numpy(), stats["var"], 1e-6, "running var")
    off = np.abs(stock.running_var.numpy() - np.asarray(stats["var"])) / np.asarray(stats["var"])
    assert off.min() > 1e-3, off


def test_frozen_batchnorm_stays_in_eval(rng):
    model = torch.nn.Sequential(layers.BatchNorm2d(4), torch.nn.Sequential(layers.BatchNorm3d(4)))
    layers.freeze_batchnorm(model).train()
    assert model.training and not any(m.training for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
                                      or isinstance(m, torch.nn.BatchNorm3d))
    before = model[0].running_mean.clone()
    model[0](t(rng.randn(2, 4, 3, 3).astype(np.float32)))
    assert torch.equal(model[0].running_mean, before)


# ---- K3's backward --------------------------------------------------------


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("with_prob_grad", [False, True])
def test_k3_backward_matches_jax_and_autograd(rng, D, with_prob_grad):
    B, H, W = 2, 5, 7
    vol = (rng.randn(B, D, H, W) * 3).astype(np.float32)
    vol[0, :, 0, 0] = -50.0
    vol[0, 3, 0, 0] = 50.0  # a one-hot column: p = 1 and p below 1e-9
    gs = [rng.randn(B, D, H, W).astype(np.float32)] + [rng.randn(B, 1, H, W).astype(np.float32) for _ in range(3)]
    if not with_prob_grad:
        gs[0] = None

    prob, expectation, _, _ = fused_soft_argmin_reference(t(vol), window=2)
    ours = soft_argmin_backward(prob, expectation, 2.0, *(None if g is None else t(g) for g in gs)).numpy()

    leaf = t(vol).requires_grad_()
    outs = fused_soft_argmin_reference(leaf, window=2)
    torch.autograd.backward([o for o, g in zip(outs, gs) if g is not None], [t(g) for g in gs if g is not None])
    _assert_close(ours, leaf.grad.numpy(), 1e-5, "vs autograd through the plain version")

    def f(s):
        p, e, m = jax_soft_argmin(s, axis=1, keepdims=True, window=2)
        total = jnp.sum(e * gs[1]) + jnp.sum(jax_entropy(p, axis=1, keepdims=True) * gs[2]) + jnp.sum(m * gs[3])
        return total if gs[0] is None else total + jnp.sum(p * gs[0])

    _assert_close(ours, np.asarray(jax.grad(f)(jnp.asarray(vol))), 1e-5, "vs jax.grad")
