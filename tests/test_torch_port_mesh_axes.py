"""The view and hyp mesh axes of the port's robust_mvd (``parallel/``,
``models/robust_mvd.py``, ``models/blocks/dispnet.py::LearnedFusion``, the
engine's ``mesh=``) vs JAX's unsharded forward and step.

One launch of 4 gloo ranks (``python -m robustmvd_tpu_torch.launch --local
4`` running ``tests/torch_port_mesh_ranks.py``) computes every sharded case;
the cases below read the files it writes. JAX computes its unsharded step
meanwhile. The same weights go to both (the port's seeded init, carried to
JAX by ``convert_torch_state_dict``); JAX runs ``RobustMVDModule(corr_impl=
"matmul")``; the biases are drawn off zero. The batch: 2 samples at 64x64, 1+3 views, 256 hypotheses, the
key view 0 in sample 0 and 2 in sample 1.

- The collectives: the sum-all-reduce, and the all-gather with uneven shares
  and with an empty one, forward and backward, against one process's
  autograd of the gathered function (every rank's loss summed), within 1e-6.
- The sharded forward under meshes (1, 2, 2), (1, 1, 4) and (1, 4, 1): 3
  source views over 2 ranks (an uneven share) and over 4 (one rank empty),
  256 hypotheses over 2 and 4 ranks. invdepth within rtol 1e-4 / atol 1e-5
  of JAX's unsharded forward (``tests/test_parallel.py:66``'s bound) and
  within 1e-5 of the port's unsharded forward; each rank calls K1's wrapper
  once per source view of its share with its slab of hypotheses (none on
  the empty share). Every rank ends a step with the same gradients and
  parameters.
- The sharded train step under (1, 2, 2) through the engine's
  ``train_step`` (``DistributedDataParallel`` over the mesh): the loss within
  1e-3 relative and every gradient within ``tests/test_parallel.py:
  190-196``'s bounds of JAX's unsharded ``value_and_grad``; the port's
  unsharded step within rtol 1e-5. The same step under (1, 4, 1) with
  ``remat=True`` within rtol 1e-5 of the port's unsharded step without.
- The engine under (2, 2, 1) for one iteration: the parameters after it
  equal the unsharded port step's on the global batch, the ranks of one
  view group trained on the same batch, and only the global rank 0 wrote
  files.
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
from robustmvd_tpu_torch.parallel import MeshSpec, make_mesh, shares
from robustmvd_tpu_torch.ops.corr import planesweep_correlation
from test_gradient_parity import _make_inputs

from torch_port_helpers import torch_threads

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = ((1, 2, 2), (1, 1, 4), (1, 4, 1))
NUM_HYPOTHESES = 256
ENGINE_LR = 1e-2


def mesh_batch():
    rng = np.random.RandomState(7)
    images, poses, intrinsics, invdepth = _make_inputs(rng, B=2, V=4, H=64, W=64)
    poses[1] = poses[1, [2, 1, 0, 3]]  # sample 1's key view is view 2: its pose the identity
    inputs = {"images": images, "poses": poses, "intrinsics": intrinsics, "keyview_idx": np.array([0, 2])}
    return inputs, {"invdepth": invdepth}


def collective_cases():
    """Seeded inputs per rank and each rank's loss weights."""
    rng = np.random.RandomState(5)

    def case(op, per_rank_shape, out_shape, **kw):
        return {"op": op, "x": [rng.randn(*per_rank_shape(r)).astype(np.float32) for r in range(WORLD)],
                "weight": [rng.randn(*out_shape).astype(np.float32) for _ in range(WORLD)], **kw}

    uneven, empty = shares(6, WORLD), shares(3, WORLD)
    return {
        "all_reduce_sum": case("all_reduce_sum", lambda r: (3, 5), (3, 5)),
        "all_gather_uneven": case("all_gather", lambda r: (3, uneven[r][1] - uneven[r][0], 2), (3, 6, 2), dim=1,
                                  total=6),
        "all_gather_empty_share": case("all_gather", lambda r: (empty[r][1] - empty[r][0], 4), (3, 4), dim=0,
                                       total=3),
    }


def jax_step(state, inputs, gt):
    """JAX's unsharded loss, gradients and invdepth."""
    params = convert_torch_state_dict({k: v.numpy() for k, v in state.items()})["params"]
    module = RobustMVDModule(corr_impl="matmul")
    loss = jax_robust_mvd_loss(verbose=False)
    j_gt = {"invdepth": jnp.asarray(gt["invdepth"].transpose(0, 2, 3, 1))}
    args = (jnp.asarray(inputs["images"].transpose(0, 1, 3, 4, 2)), jnp.asarray(inputs["poses"]),
            jnp.asarray(inputs["intrinsics"]), jnp.asarray(inputs["keyview_idx"], jnp.int32))

    def loss_fn(p):
        pred, aux = module.apply({"params": p}, *args)
        return loss({}, j_gt, pred, aux, iteration=0, params=p)[0], aux["invdepth"]

    (total, invdepth), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(total), jax.tree.map(np.asarray, grads), np.asarray(invdepth).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    inputs, gt = mesh_batch()
    with torch_threads(2):
        state = create_model("robust_mvd", device="cpu", train=True, seed=3).state_dict()
    rng = np.random.RandomState(3)  # biases off zero, so that a bias added on every rank of a sum would show
    state = {k: v + torch.from_numpy(0.05 * rng.randn(*v.shape).astype(np.float32)) if k.endswith(".bias") else v
             for k, v in state.items()}
    payload = {"state": state, "inputs": inputs, "gt": gt, "meshes": MESHES, "collectives": collective_cases(),
               "lr": ENGINE_LR}
    torch.save(payload, out / "payload.pt")
    ranks = subprocess.Popen(
        [sys.executable, "-m", "robustmvd_tpu_torch.launch", "--local", str(WORLD), "--timeout", "280", "--",
         str(ROOT / "tests" / "torch_port_mesh_ranks.py"), str(out / "payload.pt"), str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        jax_result = jax_step(state, inputs, gt)
    finally:
        log, _ = ranks.communicate(timeout=300)
    assert ranks.returncode == 0, log[-5000:]
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for path in ["payload.pt"] + [f"rank{r}.pt" for r in range(WORLD)]:
        (out / path).unlink()
    return payload, jax_result, results


def test_make_mesh_builds_view_and_hyp_axes(monkeypatch):
    """``MeshSpec(view=2, hyp=2)`` over 8 processes: a (2, 2, 2) mesh."""
    import torch.distributed.device_mesh as device_mesh

    calls = []
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 8)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(device_mesh, "init_device_mesh", lambda *a, **kw: calls.append((a, kw)) or "mesh")
    assert make_mesh(MeshSpec(view=2, hyp=2)) == "mesh"
    assert calls == [(("cpu", (2, 2, 2)), {"mesh_dim_names": ("data", "view", "hyp")})]
    assert shares(20, 3) == [(0, 7), (7, 14), (14, 20)] and shares(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]


def test_no_source_view_launches_no_k1():
    """An empty view share: empty volumes, and K1's wrapper is never called."""
    import robustmvd_tpu_torch.ops.corr as corr_module

    def refuse(*args):
        raise AssertionError("K1 called for an empty share")

    saved, corr_module.planesweep_sample_with_grad = corr_module.planesweep_sample_with_grad, refuse
    try:
        corrs, masks, _ = planesweep_correlation(
            torch.randn(2, 8, 8, 16), torch.randn(2, 0, 8, 8, 16), torch.eye(3).expand(2, 3, 3),
            torch.zeros(2, 0, 3, 3), torch.zeros(2, 0, 4, 4), invdepths=torch.rand(2, 64))
    finally:
        corr_module.planesweep_sample_with_grad = saved
    assert corrs.shape == masks.shape == (2, 0, 8, 8, 64)


@pytest.mark.parametrize("name", list(collective_cases()))
def test_collectives_are_exact_adjoints(mesh_runs, name):
    _, _, results = mesh_runs
    case = collective_cases()[name]
    xs = [torch.from_numpy(x).requires_grad_(True) for x in case["x"]]
    y = sum(xs) if case["op"] == "all_reduce_sum" else torch.cat(xs, case["dim"])
    sum((torch.from_numpy(w) * y * y).sum() for w in case["weight"]).backward()
    for r in range(WORLD):
        got = results[r]["collectives"][name]
        np.testing.assert_allclose(got["y"], y.detach(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["grad"], xs[r].grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_forward_matches_jax_unsharded(mesh_runs, mesh):
    _, (_, _, j_invdepth), results = mesh_runs
    for r in range(WORLD):
        np.testing.assert_allclose(results[r]["forward"][mesh]["invdepth"], j_invdepth, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_forward_matches_the_port_unsharded(mesh_runs, mesh):
    _, _, results = mesh_runs
    single = results[1]["single"]
    assert single["k1_calls"] == [NUM_HYPOTHESES] * 3
    for r in range(WORLD):
        np.testing.assert_allclose(results[r]["forward"][mesh]["invdepth"], single["invdepth"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_k1_calls_are_the_view_share_times_one_slab(mesh_runs, mesh):
    _, _, results = mesh_runs
    _, view, hyp = mesh
    for r in range(WORLD):
        v, h = divmod(r, hyp)
        lo, hi = shares(3, view)[v]
        s_lo, s_hi = shares(NUM_HYPOTHESES, hyp)[h]
        assert results[r]["forward"][mesh]["k1_calls"] == [s_hi - s_lo] * (hi - lo), (r, mesh)
    if view == WORLD:
        assert results[WORLD - 1]["forward"][mesh]["k1_calls"] == []  # the empty share


def test_every_rank_holds_the_same_gradients_and_parameters(mesh_runs):
    _, _, results = mesh_runs
    for key, values in (("step", "grads"), ("step_remat", "grads"), ("engine", "params")):
        ref = results[0][key]
        flat = torch.cat([t.reshape(-1).double() for _, t in sorted(ref[values].items())])
        np.testing.assert_allclose(ref["digest"], (float(flat.sum()), float(flat.square().sum())), rtol=1e-12)
        for r in range(1, WORLD):
            np.testing.assert_allclose(results[r][key]["digest"], ref["digest"], rtol=1e-12, err_msg=(key, r))


def assert_jax_grads_match(j_grads, grads):
    """``tests/test_parallel.py:190-196``'s bounds, through the weight bridge."""
    r_flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(j_grads)}
    s_tree = convert_torch_state_dict({n: g.numpy() for n, g in grads.items()})["params"]
    s_flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(s_tree)}
    assert r_flat.keys() == s_flat.keys()
    global_scale = max(float(np.max(np.abs(v))) for v in r_flat.values()) + 1e-12
    for name, ref in r_flat.items():
        atol = max(2e-3 * (float(np.max(np.abs(ref))) + 1e-12), 1e-4 * global_scale)
        np.testing.assert_allclose(s_flat[name], ref, rtol=2e-3, atol=atol, err_msg=name)


def test_sharded_train_step_matches_jax_unsharded(mesh_runs):
    _, (j_total, j_grads, _), results = mesh_runs
    for r in range(WORLD):
        assert abs(results[r]["step"]["loss"] - j_total) < 1e-3 * abs(j_total)
    assert_jax_grads_match(j_grads, results[0]["step"]["grads"])


def assert_close(ours, ref, rtol, atol):
    """Every entry of two dicts of tensors within ``atol + rtol |ref|``, in one pass."""
    assert ours.keys() == ref.keys()
    names = sorted(ref)
    a, b = (torch.cat([d[n].reshape(-1).double() for n in names]) for d in (ours, ref))
    excess = (a - b).abs() - (atol + rtol * b.abs())
    if excess.max() > 0:
        sizes = [ref[n].numel() for n in names]
        worst = [float(e.max()) for e in excess.split(sizes)]
        raise AssertionError(f"beyond rtol {rtol}, atol {atol}: {[n for n, w in zip(names, worst) if w > 0][:8]}")


def test_sharded_train_step_matches_the_port_unsharded(mesh_runs):
    _, _, results = mesh_runs
    single = results[2]["single"]
    for r in range(WORLD):
        np.testing.assert_allclose(results[r]["step"]["loss"], single["loss"], rtol=1e-5)
    scale = max(float(g.abs().max()) for g in single["grads"].values())
    assert_close(results[0]["step"]["grads"], single["grads"], rtol=1e-5, atol=1e-6 * scale)


def test_remat_sharded_train_step_matches_the_port_unsharded(mesh_runs):
    """The engine's step under (1, 4, 1) with remat: the encoder recomputed
    on each rank's share of the 3 source views (the last share empty: the
    key view alone), the replicated cost-volume encoder and decoder
    recomputed on every rank, no collective run twice."""
    _, _, results = mesh_runs
    single = results[2]["single"]
    for r in range(WORLD):
        np.testing.assert_allclose(results[r]["step_remat"]["loss"], single["loss"], rtol=1e-5)
    scale = max(float(g.abs().max()) for g in single["grads"].values())
    assert_close(results[0]["step_remat"]["grads"], single["grads"], rtol=1e-5, atol=1e-6 * scale)


def test_engine_under_data_and_view_axes_is_the_unsharded_step(mesh_runs):
    payload, _, results = mesh_runs
    batches = results[0]["engine"]["batches"]
    for a, b in ((0, 1), (2, 3)):  # one view group, one batch
        for k in batches[a]:
            np.testing.assert_array_equal(batches[a][k], batches[b][k])
    assert not np.array_equal(batches[0]["images"], batches[2]["images"])
    single = results[3]["single"]["params"]
    state = {n: payload["state"][n] for n in single}
    updates = {n: single[n] - p for n, p in state.items()}
    moved = max(float(u.abs().max()) for u in updates.values())
    assert moved > 1e-5  # the step moved the parameters
    ours = {n: p - state[n] for n, p in results[0]["engine"]["params"].items()}
    assert_close(ours, updates, rtol=1e-5, atol=1e-6 * moved)


def test_engine_writes_only_on_global_rank_0(mesh_runs):
    _, _, results = mesh_runs
    files = results[0]["engine"]["files"]
    assert "log.txt" in files and any(f.startswith("checkpoints/snapshot-iter-") for f in files)
    assert any(f.startswith("weights_only_checkpoints_dir/snapshot-iter-") for f in files)
    for r in range(1, WORLD):
        assert results[r]["engine"]["files"] == [], r
