"""The weight bridge between the port and the JAX package.

- The port's ``state_dict`` carries the rmvd names and layouts: the JAX
  package's ``convert_torch_state_dict`` turns it into exactly the key tree
  and shapes of the JAX module's ``init`` variables.
- ``state_dict_from_jax`` is its inverse: JAX -> port -> JAX is bit-exact.
- rmvd ``.pt`` checkpoints (``model_state_dict``, ``module.`` prefixes)
  load into the port.
"""

import jax
import numpy as np
import pytest
import torch

from robustmvd_tpu.models.robust_mvd import RobustMVD as JaxRobustMVD
from robustmvd_tpu.models.weights import convert_torch_state_dict
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.weights import load_checkpoint, state_dict_from_jax


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
