"""The slice as a whole: one robust_mvd recipe step in the port vs the JAX package.

Full architecture (DispNet widths 64 ... 1024, S = 256 hypotheses), weights
from the JAX ``init`` bridged into the port, B = 1, key + 2 source views,
64x128, inverse depth ground truth with holes. The port runs its training
path on the CPU (the score matmul, K1's plain version forward, K1b's plain
``scatter_add_`` version backward); JAX runs ``RobustMVDModule(corr_impl=
"matmul")``, the same route, under ``jax.value_and_grad``. Both take the
recipe's ``robust_mvd_loss`` with the L2 term, at iteration 0 (MAE) and
2000 (Laplacian NLL).

Bounds (those of ``tests/test_gradient_parity.py``, which holds the JAX
package to the torch reference): loss rtol 1e-4; every parameter's gradient,
mapped onto the JAX tree by the JAX package's ``convert_torch_state_dict``,
within rtol 2e-3 and atol max(2e-3 x the leaf's max |grad|, 1e-4 x the
largest max |grad| of all leaves): fp32 sums in another order through ~40
convolutions and their transposes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.loss.multi_scale_uni_laplace import robust_mvd_loss as jax_robust_mvd_loss
from robustmvd_tpu.models.robust_mvd import RobustMVDModule
from robustmvd_tpu.models.weights import convert_torch_state_dict
from robustmvd_tpu_torch import create_loss, create_model
from test_gradient_parity import _assert_grad_trees_match, _make_inputs

from torch_port_helpers import load_bridged, t

ITERATIONS = (0, 2000)


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs(np.random.RandomState(42), B=1, V=3, H=64, W=128)


@pytest.fixture(scope="module")
def jax_variables():
    return jax_create_model("robust_mvd", pretrained=False, corr_impl="matmul").variables


@pytest.fixture(scope="module")
def jax_results(inputs, jax_variables):
    images, poses, intrinsics, invdepth = inputs
    module = RobustMVDModule(corr_impl="matmul")
    loss = jax_robust_mvd_loss(verbose=False)
    gt = {"invdepth": jnp.asarray(invdepth.transpose(0, 2, 3, 1))}
    args = (jnp.asarray(images.transpose(0, 1, 3, 4, 2)), jnp.asarray(poses), jnp.asarray(intrinsics),
            jnp.zeros((images.shape[0],), jnp.int32))

    @jax.jit
    def value_and_grad(params, iteration):
        def loss_fn(p):
            pred, aux = module.apply({"params": p}, *args)
            return loss({}, gt, pred, aux, iteration=iteration, params=p)[0]

        return jax.value_and_grad(loss_fn)(params)

    out = {}
    for iteration in ITERATIONS:
        total, grads = value_and_grad(jax_variables["params"], iteration)
        out[iteration] = (float(total), jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def port_results(inputs, jax_variables):
    images, poses, intrinsics, invdepth = inputs
    model = load_bridged(create_model("robust_mvd", device="cpu", train=True), jax_variables).train()
    loss = create_loss("robust_mvd_loss", model=model)
    sample = {"images": t(images), "poses": t(poses), "intrinsics": t(intrinsics),
              "keyview_idx": torch.zeros(images.shape[0], dtype=torch.int64)}
    out = {}
    for iteration in ITERATIONS:
        model.zero_grad(set_to_none=True)
        pred, aux = model(**sample)
        total, _, _ = loss(sample, {"invdepth": t(invdepth)}, pred, aux, iteration=iteration)
        total.backward()
        grads = {name: p.grad.numpy().copy() for name, p in model.named_parameters()}
        out[iteration] = (float(total.detach()), grads)
    return out


@pytest.mark.parametrize("iteration", ITERATIONS, ids=["mae", "laplace_nll"])
def test_recipe_step_matches_jax(jax_results, port_results, iteration):
    j_total, j_grads = jax_results[iteration]
    p_total, p_grads = port_results[iteration]
    np.testing.assert_allclose(p_total, j_total, rtol=1e-4)
    _assert_grad_trees_match(j_grads, convert_torch_state_dict(p_grads)["params"])


def test_the_loss_phases_differ(jax_results, port_results):
    """Iteration 2000 takes the NLL branch: the totals differ from the MAE's
    (the check above would pass vacuously if both took one branch)."""
    assert port_results[0][0] != pytest.approx(port_results[2000][0], rel=1e-3)
    assert jax_results[0][0] != pytest.approx(jax_results[2000][0], rel=1e-3)
