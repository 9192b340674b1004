"""Data parallelism in the port (``parallel/``, the engine's ``mesh=``) vs the
JAX package's unsharded step.

Two gloo ranks (``python -m robustmvd_tpu_torch.launch --local 2`` running
``tests/torch_port_ranks.py``) each take one sample of a global batch of 2
through the training engine's ``train_step`` under ``DistributedDataParallel``;
JAX takes the whole batch in one step (JAX's sharded step equals its
unsharded step, ``tests/test_parallel.py:140, 238``). The same weights go to
both (the port's seeded init, carried to JAX by the bridges). The ground
truth leaves the two samples different numbers of valid pixels, so that a
mean of the ranks' own masked means would differ from the global one:

- robust_mvd at 64x64, 1+2 views, ``robust_mvd_loss`` at iteration 0, vs
  ``RobustMVDModule(corr_impl="matmul")`` under ``jax.value_and_grad``: the
  loss averaged over the ranks within rtol 1e-5, the gradients at
  ``tests/test_gradient_parity.py``'s bounds through
  ``convert_torch_state_dict``;
- vis_mvsnet ``train=True`` at 64x64, 1+2 views, ``vismvsnet_loss``, vs JAX's
  ``apply_fn_mutable`` step compiled at XLA:CPU level 0, as
  ``tests/test_torch_port_family_train.py`` holds it (loss rtol 1e-4, the
  gradients as above): the BatchNorm statistics are taken over both ranks'
  samples. The new running statistics: each within 1e-5 of JAX's plus twice
  the distance of the port's own step on the whole batch in one process
  (computed by rank 0) from JAX's. That step is up to 1.2e-5-3.5e-5 off JAX
  in the variances of the later stages' regulariser BatchNorms on this
  batch (float32 noise in the activations upstream of them, run to run), so
  JAX's rtol 1e-5 alone holds the port's unsharded step no better.

vis is also held to the port's step on the whole batch in one process: the
loss to rtol 1e-5, the gradients to rtol 2e-5 (a sum over the two ranks'
halves is a sum in another order), the running statistics as
``assert_stats_match`` holds them (rtol 1e-5; measured 1.3e-6). The ranks run
while JAX computes its step.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.loss.multi_scale_uni_laplace import robust_mvd_loss as jax_robust_mvd_loss
from robustmvd_tpu.models.robust_mvd import RobustMVDModule
from robustmvd_tpu.models.weights import convert_torch_state_dict
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.weights import state_dict_from_jax, variables_from_state_dict
from robustmvd_tpu_torch.parallel import MeshSpec, data_group, make_mesh, use_mesh
from test_gradient_parity import _assert_grad_trees_match, _make_inputs
from test_torch_port_family_train import assert_grads_match, assert_stats_match, family_batch, jax_vis_step

from torch_port_helpers import randomized_variables, torch_threads

ROOT = Path(__file__).resolve().parents[1]
VIS_HEAD_GAIN = 4.0  # as tests/test_torch_port_family_train.py conditions vis's score heads


def robust_mvd_case():
    images, poses, intrinsics, invdepth = _make_inputs(np.random.RandomState(42), B=2, V=3, H=64, W=64)
    invdepth[0, :, :24] = 0.0  # sample 0 (rank 0) has fewer valid pixels than sample 1
    with torch_threads(2):
        state = create_model("robust_mvd", device="cpu", train=True, seed=3).state_dict()
    inputs = {"images": images, "poses": poses, "intrinsics": intrinsics, "keyview_idx": np.zeros(2, np.int64)}
    return {"state": state, "kwargs": {}, "loss": "robust_mvd_loss", "iteration": 0, "inputs": inputs,
            "gt": {"invdepth": invdepth}}


def vis_case():
    batch = family_batch(0, 64, 64, 1.0, 10.0, B=2)
    batch["depth"][0, :, :24] = 100.0  # beyond the depth range: out of the loss's mask on rank 0 only
    with torch_threads(2):
        state = create_model("vis_mvsnet", device="cpu", train=True, seed=3).state_dict()
    variables = randomized_variables(variables_from_state_dict(state), np.random.RandomState(3),
                                     prob_gain=VIS_HEAD_GAIN)
    inputs = {k: batch[k] for k in ("images", "poses", "intrinsics", "keyview_idx")}
    inputs["depth_range"] = (batch["lo"], batch["hi"])
    case = {"state": state_dict_from_jax(variables), "kwargs": {}, "loss": "vismvsnet_loss", "iteration": 0,
            "inputs": inputs, "gt": {"depth": batch["depth"]}, "single": True}
    return case, variables, batch


def jax_robust_mvd_step(case):
    inputs = case["inputs"]
    params = convert_torch_state_dict({k: v.numpy() for k, v in case["state"].items()})["params"]
    module = RobustMVDModule(corr_impl="matmul")
    loss = jax_robust_mvd_loss(verbose=False)
    gt = {"invdepth": jnp.asarray(case["gt"]["invdepth"].transpose(0, 2, 3, 1))}
    args = (jnp.asarray(inputs["images"].transpose(0, 1, 3, 4, 2)), jnp.asarray(inputs["poses"]),
            jnp.asarray(inputs["intrinsics"]), jnp.zeros((2,), jnp.int32))

    def loss_fn(p):
        pred, aux = module.apply({"params": p}, *args)
        return loss({}, gt, pred, aux, iteration=0, params=p)[0]

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(total), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def data_parallel_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    vis, vis_variables, vis_batch = vis_case()
    cases = {"robust_mvd": robust_mvd_case(), "vis_mvsnet": vis}
    torch.save(cases, out / "payload.pt")
    ranks = subprocess.Popen(
        [sys.executable, "-m", "robustmvd_tpu_torch.launch", "--local", "2", "--timeout", "280", "--",
         str(ROOT / "tests" / "torch_port_ranks.py"), str(out / "payload.pt"), str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        jax_steps = {"robust_mvd": jax_robust_mvd_step(cases["robust_mvd"]),
                     "vis_mvsnet": jax_vis_step(vis_variables, vis_batch)}
    finally:
        log, _ = ranks.communicate(timeout=300)
    assert ranks.returncode == 0, log[-5000:]
    results = torch.load(out / "rank0.pt", weights_only=False)
    for path in ("payload.pt", "rank0.pt"):  # ~830 MB of state dicts and gradients
        (out / path).unlink()
    return cases, jax_steps, results


def test_ranks_have_different_valid_pixel_counts():
    """The masked-mean fault would show: the two samples' masks differ."""
    invdepth = robust_mvd_case()["gt"]["invdepth"]
    assert (invdepth[0] > 0).sum() < 0.7 * (invdepth[1] > 0).sum()
    depth = vis_case()[2]["depth"]
    assert (depth[0] <= 10.0).sum() < 0.7 * (depth[1] <= 10.0).sum()


def test_data_parallel_loaders_take_strided_shares(data_parallel_steps):
    _, _, ranks = data_parallel_steps
    for name, result in ranks.items():
        assert result["indices"] == [[0, 2, 4], [1, 3, 5]], name
        assert result["ddp"] == "DistributedDataParallel"


def test_data_parallel_robust_mvd_step_matches_jax_unsharded(data_parallel_steps):
    _, jax_steps, ranks = data_parallel_steps
    j_total, j_grads = jax_steps["robust_mvd"]
    result = ranks["robust_mvd"]
    np.testing.assert_allclose(result["loss"], j_total, rtol=1e-5)
    assert result["local_loss"] != pytest.approx(j_total, rel=1e-3)  # rank 0's share alone is not the loss
    grads = {n: g.numpy() for n, g in result["grads"].items()}
    _assert_grad_trees_match(j_grads, convert_torch_state_dict(grads)["params"])


def test_data_parallel_vis_step_matches_jax_unsharded(data_parallel_steps):
    cases, jax_steps, ranks = data_parallel_steps
    j_total, j_grads, j_stats = jax_steps["vis_mvsnet"]
    result = ranks["vis_mvsnet"]
    np.testing.assert_allclose(result["loss"], j_total, rtol=1e-4)
    state = cases["vis_mvsnet"]["state"]
    grads = {n: result["grads"].get(n, torch.zeros_like(p)) for n, p in state.items() if "running" not in n
             and "num_batches" not in n}
    assert_grads_match(j_grads, grads)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    ours, single = (flat(variables_from_state_dict(state)["batch_stats"])
                    for state in (result["state"], result["single"]["state"]))
    ref = flat(j_stats)
    assert ours.keys() == ref.keys() and len(ref) > 20
    for name, r in ref.items():
        bound = 1e-5 * np.abs(r) + 2 * np.abs(single[name] - r)
        assert (np.abs(ours[name] - r) <= bound).all(), (name, ours[name], r, single[name])


def test_data_parallel_vis_step_is_the_unsharded_port_step(data_parallel_steps):
    result = data_parallel_steps[2]["vis_mvsnet"]
    single = result["single"]
    np.testing.assert_allclose(result["loss"], single["loss"], rtol=1e-5)
    assert result["grads"].keys() == single["grads"].keys()
    scale = max(float(g.abs().max()) for g in single["grads"].values())
    for n, g in single["grads"].items():
        np.testing.assert_allclose(result["grads"][n], g, rtol=2e-5, atol=1e-6 * scale, err_msg=n)
    assert_stats_match(variables_from_state_dict(result["state"])["batch_stats"],
                       variables_from_state_dict(single["state"])["batch_stats"])


def test_mesh_is_data_only_and_data_group_is_none_for_one_rank(monkeypatch):
    assert MeshSpec().resolve(4) == (4, 1, 1) and MeshSpec(data=2, view=2).resolve(4) == (2, 2, 1)
    with pytest.raises(AssertionError):
        MeshSpec(data=3).resolve(4)

    class FakeMesh:  # a one-rank data axis: the losses and BatchNorm keep their local sums
        mesh_dim_names = ("data", "view", "hyp")

        def size(self, dim):
            return 1

    assert data_group() is None
    with use_mesh(FakeMesh()):
        assert data_group() is None
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 4)
    with pytest.raises(NotImplementedError, match="view and hyp"):
        make_mesh(MeshSpec(data=2, view=2))
