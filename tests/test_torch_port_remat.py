"""robust_mvd's rematerialised training in the port, against the JAX package's.

One recipe-loss step (``robust_mvd_loss`` with its L2 term at iteration 0)
of full-width robust_mvd at S = 32, B = 1, key + 2 source views, 64x64,
weights from the JAX ``init`` bridged into the port; torch on one thread
(on two the CPU backward sums in an order that varies run to run).

- The port with ``remat=True`` (the encoder, the cost-volume encoder and the
  decoder recomputed in the backward) and with ``remat=False``: the loss and
  every gradient bit for bit.
- The port with remat against JAX's ``RobustMVDModule(remat=True,
  corr_impl="matmul")`` under ``jax.value_and_grad``, at
  ``tests/test_gradient_parity.py``'s bounds (loss rtol 1e-4; gradients rtol
  2e-3, atol max(2e-3 x the leaf's max, 1e-4 x the largest max)).
- Forward pre-hooks count the recompute: each of the three blocks runs
  twice a step with remat, once without, and once under ``torch.no_grad``.
- The correlation is not recomputed: K1's wrapper and K1b's are called once
  per source view a step either way, and the correlation saves no score
  matrix for the backward (``torch.autograd.graph.saved_tensors_hooks``):
  the tensors it saves beyond views of its input features are K1's taps and
  the mask, the same with remat and without.
- ``remat=None`` follows ``train``, as in JAX.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustmvd_tpu_torch.ops.corr as corr_module
from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.loss.multi_scale_uni_laplace import robust_mvd_loss as jax_robust_mvd_loss
from robustmvd_tpu.models.robust_mvd import RobustMVDModule
from robustmvd_tpu.models.weights import convert_torch_state_dict
from robustmvd_tpu_torch import create_loss, create_model
from test_gradient_parity import _assert_grad_trees_match, _make_inputs

from torch_port_helpers import load_bridged, t, torch_threads

S = 32
B, V, H, W = 1, 3, 64, 64
BLOCKS = ("encoder", "fusion_enc_block", "decoder")
# the modules (their packages export a function under the same name)
k1_module = importlib.import_module("robustmvd_tpu_torch.ops.kernels.planesweep_sample")
robust_mvd_module = importlib.import_module("robustmvd_tpu_torch.models.robust_mvd")


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs(np.random.RandomState(42), B=B, V=V, H=H, W=W)


@pytest.fixture(scope="module")
def jax_variables():
    return jax_create_model("robust_mvd", pretrained=False, corr_impl="matmul", num_sampling_points=S).variables


@pytest.fixture(scope="module")
def jax_remat_step(inputs, jax_variables):
    images, poses, intrinsics, invdepth = inputs
    module = RobustMVDModule(corr_impl="matmul", remat=True, num_sampling_points=S)
    loss = jax_robust_mvd_loss(verbose=False)
    gt = {"invdepth": jnp.asarray(invdepth.transpose(0, 2, 3, 1))}
    args = (jnp.asarray(images.transpose(0, 1, 3, 4, 2)), jnp.asarray(poses), jnp.asarray(intrinsics),
            jnp.zeros((B,), jnp.int32))

    def loss_fn(p):
        pred, aux = module.apply({"params": p}, *args)
        return loss({}, gt, pred, aux, iteration=0, params=p)[0]

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(jax_variables["params"])
    return float(total), jax.tree.map(np.asarray, grads)


def _correlation_saves(saved):
    """planesweep_correlation wrapped so that every tensor autograd saves
    inside it lands in ``saved`` (the storage's address and bytes, the shape)."""
    correlation = corr_module.planesweep_correlation

    def pack(tensor):
        storage = tensor.untyped_storage()
        saved.append((storage.data_ptr(), storage.nbytes(), tuple(tensor.shape)))
        return tensor

    def wrapped(*args, **kwargs):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
            return correlation(*args, **kwargs)

    return wrapped


@pytest.fixture(scope="module")
def port_steps(inputs, jax_variables):
    """Per remat setting: loss, gradients, the blocks' calls, K1's and K1b's
    calls, the correlation's saved tensors and its input features' storages."""
    images, poses, intrinsics, invdepth = inputs
    sample = {"images": t(images), "poses": t(poses), "intrinsics": t(intrinsics),
              "keyview_idx": torch.zeros(B, dtype=torch.int64)}
    out = {}
    k1, k1b = corr_module.planesweep_sample_with_grad, k1_module.planesweep_sample_backward
    correlation = robust_mvd_module.planesweep_correlation
    with torch_threads(1):
        for remat in (False, True):
            model = load_bridged(create_model("robust_mvd", device="cpu", train=True, num_sampling_points=S,
                                              remat=remat), jax_variables).train()
            calls = {name: 0 for name in BLOCKS + ("k1", "k1b")}
            for name in BLOCKS:
                getattr(model, name).register_forward_pre_hook(
                    lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
            saved, features = [], []

            def counted_k1(*args):
                calls["k1"] += 1
                return k1(*args)

            def counted_k1b(*args, **kwargs):
                calls["k1b"] += 1
                return k1b(*args, **kwargs)

            def noted_correlation(feat_key, feat_sources, *args, **kwargs):
                features.extend(f.untyped_storage().data_ptr() for f in (feat_key, feat_sources))
                return _correlation_saves(saved)(feat_key, feat_sources, *args, **kwargs)

            corr_module.planesweep_sample_with_grad = counted_k1
            k1_module.planesweep_sample_backward = counted_k1b
            robust_mvd_module.planesweep_correlation = noted_correlation
            try:
                pred, aux = model(**sample)
                total, _, _ = create_loss("robust_mvd_loss", model=model)(sample, {"invdepth": t(invdepth)}, pred,
                                                                          aux, iteration=0)
                total.backward()
                step_calls = dict(calls)
                with torch.no_grad():
                    model(**sample)
            finally:
                corr_module.planesweep_sample_with_grad = k1
                k1_module.planesweep_sample_backward = k1b
                robust_mvd_module.planesweep_correlation = correlation
            out[remat] = {"loss": total.detach(), "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                          "calls": step_calls, "no_grad_calls": {n: calls[n] - step_calls[n] for n in calls},
                          "saved": saved, "features": set(features)}
    return out


def test_remat_step_equals_the_plain_step_bit_for_bit(port_steps):
    plain, remat = port_steps[False], port_steps[True]
    assert torch.equal(plain["loss"], remat["loss"])
    assert plain["grads"].keys() == remat["grads"].keys()
    differ = [n for n in plain["grads"] if not torch.equal(plain["grads"][n], remat["grads"][n])]
    assert not differ, differ
    assert any(float(g.abs().max()) > 0 for g in remat["grads"].values())


def test_remat_step_matches_jax_remat(port_steps, jax_remat_step):
    j_total, j_grads = jax_remat_step
    np.testing.assert_allclose(float(port_steps[True]["loss"]), j_total, rtol=1e-4)
    grads = {n: g.numpy() for n, g in port_steps[True]["grads"].items()}
    _assert_grad_trees_match(j_grads, convert_torch_state_dict(grads)["params"])


def test_the_blocks_run_twice_a_step_with_remat(port_steps):
    for remat, runs in ((False, 1), (True, 2)):
        calls = port_steps[remat]
        assert {n: calls["calls"][n] for n in BLOCKS} == dict.fromkeys(BLOCKS, runs), remat
        assert {n: calls["no_grad_calls"][n] for n in BLOCKS} == dict.fromkeys(BLOCKS, 1), remat


def test_the_correlation_is_not_recomputed(port_steps):
    """K1 and K1b once per source view a step, remat or not."""
    for remat in (False, True):
        assert port_steps[remat]["calls"]["k1"] == port_steps[remat]["calls"]["k1b"] == V - 1, remat


def test_the_correlation_saves_no_score_matrix(port_steps):
    """Beyond views of its input features (the score product's operands),
    the correlation saves per source view K1's four taps (B HW, S) and the
    mask (B, HW, S), 4 bytes an element each: every tensor of its own ends in
    the S hypotheses, none is a (B, HW, HsWs) score matrix."""
    hw = (H // 8) * (W // 8)
    for remat in (False, True):
        steps = port_steps[remat]
        own = [(ptr, nbytes, shape) for ptr, nbytes, shape in steps["saved"] if ptr not in steps["features"]]
        assert all(shape[-1] == S for _, _, shape in own), (remat, own)
        assert sum(dict((ptr, nbytes) for ptr, nbytes, _ in own).values()) == (V - 1) * 5 * B * hw * S * 4, remat
    assert sorted(s[2] for s in port_steps[False]["saved"]) == sorted(s[2] for s in port_steps[True]["saved"])


def test_remat_follows_train_by_default():
    assert create_model("robust_mvd", device="cpu", train=True, num_sampling_points=S).remat is True
    assert create_model("robust_mvd", device="cpu", num_sampling_points=S).remat is False
    assert create_model("robust_mvd", device="cpu", train=True, remat=False, num_sampling_points=S).remat is False
    assert create_model("robust_mvd_5M", device="cpu", remat=True, num_sampling_points=S).remat is True
