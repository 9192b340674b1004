"""The MVSNet family over the view and hyp mesh axes in the port
(``parallel/collectives.py::fetch_window``, ``ops/sharded3d.py``, the 3D
layers and ``BatchNorm3d`` of ``ops/layers.py``, ``models/{mvsnet,
cvp_mvsnet}.py``, ``models/blocks/vis_mvsnet.py``, the engine's ``mesh=``)
vs JAX's unsharded forward and step and the port's unsharded runs.

One launch of 4 gloo ranks (``python -m robustmvd_tpu_torch.launch --local
4`` running ``tests/torch_port_mesh_family_ranks.py``) computes every sharded
case; the cases below read the files it writes. JAX computes its unsharded
forwards and step meanwhile, from the same weights (the JAX ``init``,
randomised and conditioned as ``torch_port_helpers.jax_family`` conditions
them, bridged with ``state_dict_from_jax``). The inputs are
``tests/test_parallel.py``'s: B = 2, 1+2 views (mvsnet also 1+3), 64x64.

- The window fetch and the D-sharded 3D layers on mesh (1, 1, 4), forward
  and backward, against one process's layer and autograd (each rank's loss
  the sum over its share, so the ranks' losses sum to the unsharded one),
  within 1e-6: the stride-1 convolution (cuDNN's and K5's plain version,
  and a biased score head), the stride-2 and the 1x1 stride-2 convolution
  and the transposed convolutions at stride 2 and 1; D = 10 (shares 3, 3,
  2, 2; stride-2 outputs 2, 1, 1, 1) and D = 3 (an empty rank); the
  bound is 1e-6 of the output's (or gradient's) largest |value|. BatchNorm
  in training: the D-sharded ``BatchNorm3d`` sums its statistics over hyp,
  a replicated ``BatchNorm2d`` does not need to; both equal the unsharded
  statistics, outputs and gradients.
- The sharded forwards: mvsnet_train (``view_parallel=True``, 16
  hypotheses, K5's path) under (1, 2, 2) with 1+2 and 1+3 views (an uneven
  view share), vis_mvsnet under (1, 1, 4) and (2, 1, 2), cvp_mvsnet
  (``nscale=3``) under (1, 1, 4): the depth within rtol / atol 1e-4 of
  JAX's unsharded forward (``tests/test_parallel.py:96, 137, 235``) and
  within 1e-5 of the port's unsharded forward; each rank calls each kernel
  wrapper on its slab only (K2, K2 group, K4 and K5 see the slab's planes,
  K5 with its halo; K3 the gathered D), as many times as the unsharded
  model, or its view share's times for K4.
- ``view_parallel`` off a mesh: the port's depth within 1e-5 of its default
  route and within 1e-4 of JAX's ``view_parallel=True`` (JAX's :98-108).
- vis_mvsnet's training step through the engine's ``train_step`` under
  (2, 1, 2): the global loss (the mean of the data ranks' losses) within
  1e-3 relative and every gradient within ``tests/test_parallel.py:
  294-298``'s bounds of JAX's unsharded ``value_and_grad`` of
  ``vismvsnet_loss``, from JAX's init as that test trains it; the loss,
  the gradients and the BatchNorm running statistics within rtol 1e-5 of
  the port's unsharded step; every rank ends the step with the same
  parameters and statistics.
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

from robustmvd_tpu.loss import create_loss as jax_create_loss
from robustmvd_tpu.models.cvp_mvsnet import CVPMVSNetModule
from robustmvd_tpu.models.mvsnet import MVSNetModule
from robustmvd_tpu.models.vis_mvsnet import VisMvsnet as JaxVisMvsnet
from robustmvd_tpu.models.vis_mvsnet import VisMvsnetModule
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.weights import state_dict_from_jax, variables_from_state_dict
from robustmvd_tpu_torch.ops import conv3d as conv3d_module
from robustmvd_tpu_torch.ops import layers
from robustmvd_tpu_torch.parallel import shares
from robustmvd_tpu_torch.parallel.context import AxisGroup
from test_gradient_parity import _assert_grad_trees_match
from test_torch_port_mesh_axes import assert_close

from torch_port_helpers import _dummy, _jax_variables, torch_threads

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MVSNET_D = 16
VIS_D = (64, 32, 16)
CVP_D = (48, 8, 8)
SGD_LR = 1e-2
LAYER_CASES = {f"{kind}_D{D}": (kind, D) for D in (10, 3)
               for kind in ("same_xla", "same_banded", "head_banded", "stride2", "down1x1", "deconv_s2", "deconv_s1")}


def mesh_sample(seed, V, B=2, H=64, W=64):
    """``tests/test_parallel.py::_sample``'s inputs (images in [-0.4, 0.6),
    source views translated along x, relative intrinsics made absolute) as
    numpy, the images (B, V, H, W, 3)."""
    rng = np.random.RandomState(seed)
    images = rng.rand(B, V, H, W, 3).astype(np.float32) - 0.4
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    for i in range(1, V):
        poses[:, i, 0, 3] = 0.1 * i
        poses[:, i, 1, 3] = 0.05
    intrinsics = np.tile(np.array([[0.8, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32), (B, V, 1, 1))
    intrinsics *= np.array([[W, 1, W], [1, H, H], [1, 1, 1]], np.float32)
    return images, poses, intrinsics, np.zeros(B, np.int32)


def cvp_poses(seed, B, V):
    """Rotated source cameras (CVP-MVSNet's hypothesis interval is singular
    for a pure translation), as ``tests/test_parallel.py:207-211``."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    for i in range(1, V):
        poses[:, i, :3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.1).as_matrix()
        poses[:, i, :3, 3] = rng.randn(3) * 0.2 + [0.1 * i, 0.0, 0.0]
    return poses


def port_inputs(images, poses, intrinsics, keyview_idx, **extra):
    inputs = {"images": torch.from_numpy(np.ascontiguousarray(images.transpose(0, 1, 4, 2, 3))),
              "poses": torch.from_numpy(poses), "intrinsics": torch.from_numpy(intrinsics),
              "keyview_idx": torch.from_numpy(keyview_idx.astype(np.int64))}
    return {**inputs, **{k: tuple(map(torch.from_numpy, v)) if isinstance(v, tuple) else torch.from_numpy(v)
                         for k, v in extra.items()}}


def jax_inputs(images, poses, intrinsics, keyview_idx):
    return tuple(jnp.asarray(a) for a in (images, poses, intrinsics, keyview_idx))


def reference_step(fn, *args):
    """``fn(*args)`` jitted with XLA:CPU's backend optimisation off, as
    ``tests/test_torch_port_family_train.py::reference_step`` compiles JAX's
    vis step (XLA:CPU miscompiles its gradient at the default level)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_cpu_multi_thread_eigen": False})(*args)


def layer_payload():
    """Seeded layer, fetch and BatchNorm cases (torch's generator)."""
    import robustmvd_tpu_torch.models.blocks.mvsnet as blocks  # noqa: F401  (init_weights)
    from torch_port_mesh_family_ranks import LAYER_KINDS

    gen = torch.Generator().manual_seed(11)
    cases = {}
    for name, (kind, D) in LAYER_CASES.items():
        layer = LAYER_KINDS[kind]()
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() == 1 else 0.2))
        x = torch.randn((2, layer.in_channels, D, 6, 5), generator=gen)
        y_shape = layer(x).shape  # no mesh: the unsharded layer
        cases[name] = {"kind": kind, "state": layer.state_dict(), "x": x, "weight": torch.randn(y_shape, generator=gen)}
    fetch = {}
    for total, windows in ((10, [(0, 4), (2, 7), (5, 10), (9, 10)]), (10, [(6, 10), (0, 3), (3, 3), (0, 10)]),
                           (3, [(0, 2), (0, 3), (1, 3), (3, 3)])):
        x = torch.randn((2, 3, total, 4, 3), generator=gen)
        fetch[f"D{total}_" + "_".join(f"{a}-{b}" for a, b in windows)] = {
            "x": x, "total": total, "windows": windows, "weight": torch.randn(x.shape, generator=gen)}
    bn = {}
    for name, shape in (("bn3d_D10", (2, 8, 10, 6, 5)), ("bn3d_D3", (2, 8, 3, 6, 5)), ("bn2d", (2, 8, 6, 5))):
        module = (layers.BatchNorm3d if len(shape) == 5 else layers.BatchNorm2d)(8)
        with torch.no_grad():
            module.weight.copy_(1 + 0.1 * torch.randn(8, generator=gen))
            module.bias.copy_(0.1 * torch.randn(8, generator=gen))
            module.running_mean.copy_(0.1 * torch.randn(8, generator=gen))
        bn[name] = {"state": module.state_dict(), "x": 2 + 3 * torch.randn(shape, generator=gen),
                    "weight": torch.randn(shape, generator=gen)}
    return fetch, cases, bn


def family_payload():
    """The forward cases and the train step, with JAX's variables; returns
    (payload entries, JAX work to run while the ranks run)."""
    models, jax_work = {}, {}
    depth_range = (np.full(2, 2.0, np.float32), np.full(2, 20.0, np.float32))

    mvs_module = MVSNetModule(num_sampling_steps=MVSNET_D, view_parallel=True)
    mvs_vars = _jax_variables(mvs_module, _dummy(2), 3)
    mvs_state = state_dict_from_jax(mvs_vars)
    for V in (3, 4):
        sample = mesh_sample(0, V)
        models[f"mvsnet_{V}"] = {
            "name": "mvsnet_train", "mesh": (1, 2, 2), "state": mvs_state, "inputs": port_inputs(*sample, depth_range=depth_range),
            "kwargs": {"num_sampling_steps": MVSNET_D, "view_parallel": True, "conv3d_impl": "banded"}}
        jax_work[f"mvsnet_{V}"] = (mvs_module, mvs_vars, (*jax_inputs(*sample), tuple(map(jnp.asarray, depth_range))))

    vis_module = VisMvsnetModule(num_sampling_steps=192)
    vis_vars = _jax_variables(vis_module, _dummy(2), 3, prob_gain=4.0)
    sample = mesh_sample(1, 3)
    for mesh in ((1, 1, 4), (2, 1, 2)):
        models["vis_" + "".join(map(str, mesh))] = {
            "name": "vis_mvsnet", "mesh": mesh, "state": state_dict_from_jax(vis_vars), "kwargs": {},
            "inputs": port_inputs(*sample, depth_range=depth_range)}
    jax_work["vis"] = (vis_module, vis_vars, (*jax_inputs(*sample), tuple(map(jnp.asarray, depth_range))))

    cvp_module = CVPMVSNetModule(nscale=3)
    cvp_vars = _jax_variables(cvp_module, _dummy(3, with_range=False), 4)
    images, _, intrinsics, kv = mesh_sample(2, 3)
    poses = cvp_poses(2, 2, 3)
    lo, hi = np.full(2, 2.0, np.float32), np.full(2, 10.0, np.float32)
    models["cvp_114"] = {"name": "cvp_mvsnet", "mesh": (1, 1, 4), "state": state_dict_from_jax(cvp_vars),
                         "kwargs": {"nscale": 3},
                         "inputs": port_inputs(images, poses, intrinsics, kv, min_depth=lo, max_depth=hi)}
    jax_work["cvp"] = (cvp_module, cvp_vars, (*jax_inputs(images, poses, intrinsics, kv), jnp.asarray(lo),
                                              jnp.asarray(hi)))

    # JAX's own init, as tests/test_parallel.py:238-298 trains it: the family tests' randomised BatchNorm
    # shifts make flax's float32 E[x^2] - E[x]^2 cancel (see test_vis_sharded_train_step_matches_the_port_unsharded)
    train_module = VisMvsnetModule(num_sampling_steps=192, warp_impl="xla")
    train_vars = jax.tree.map(np.asarray, jax.jit(train_module.init)(jax.random.PRNGKey(0), **_dummy(2)))
    sample = mesh_sample(3, 3)
    train_range = (np.full(2, 2.0, np.float32), np.full(2, 10.0, np.float32))
    gt = (2.0 + 7.0 * np.random.RandomState(4).rand(2, 1, 64, 64)).astype(np.float32)
    train = {"name": "vis_mvsnet", "mesh": (2, 1, 2), "state": state_dict_from_jax(train_vars),
             "kwargs": {"train": True}, "inputs": port_inputs(*sample, depth_range=train_range),
             "gt": {"depth": torch.from_numpy(gt)}, "lr": SGD_LR}
    jax_work["train"] = (train_vars, (*jax_inputs(*sample), tuple(map(jnp.asarray, train_range))),
                         jnp.asarray(gt.transpose(0, 2, 3, 1)))
    return models, train, jax_work


def jax_results(work):
    """JAX's unsharded depths and vis step."""
    out = {}
    for name in ("mvsnet_3", "mvsnet_4", "vis", "cvp"):
        module, variables, args = work[name]
        pred, _ = reference_step(module.apply, variables, *args)
        out[name] = np.asarray(pred["depth"])[..., 0]

    variables, args, gt = work["train"]
    import types

    wrapper = types.SimpleNamespace(module=VisMvsnetModule(num_sampling_steps=192, train_bn=True, warp_impl="xla"))
    loss = jax_create_loss("vismvsnet_loss")

    def step(params):
        def loss_fn(p):
            (pred, aux), stats = JaxVisMvsnet.apply_fn_mutable(
                wrapper, {"params": p, "batch_stats": variables["batch_stats"]}, *args)
            return loss({}, {"depth": gt}, pred, aux, iteration=0, params=p)[0], stats

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, _), grads = reference_step(step, variables["params"])
    out["train"] = (float(total), jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_family")
    with torch_threads(2):
        fetch, layer_cases, bn = layer_payload()
        models, train, jax_work = family_payload()
    payload = {"fetch": fetch, "layers": layer_cases, "bn": bn, "models": models, "train": train}
    torch.save(payload, out / "payload.pt")
    ranks = subprocess.Popen(
        [sys.executable, "-m", "robustmvd_tpu_torch.launch", "--local", str(WORLD), "--timeout", "280", "--",
         str(ROOT / "tests" / "torch_port_mesh_family_ranks.py"), str(out / "payload.pt"), str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}", OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        reference = jax_results(jax_work)
    finally:
        log, _ = ranks.communicate(timeout=300)
    assert ranks.returncode == 0, log[-5000:]
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for path in ["payload.pt"] + [f"rank{r}.pt" for r in range(WORLD)]:
        (out / path).unlink()
    return payload, reference, results


def gathered(results, key, name, field, total_of, dim=2):
    """A field's shares from every rank, concatenated in rank order."""
    parts = [results[r][key][name][field] for r in range(WORLD)]
    for r, part in enumerate(parts):
        lo, hi = shares(total_of, WORLD)[r]
        assert part.shape[dim] == hi - lo, (name, field, r, part.shape)
    return torch.cat(parts, dim)


@pytest.mark.parametrize("name", ["D10_0-4_2-7_5-10_9-10", "D10_6-10_0-3_3-3_0-10", "D3_0-2_0-3_1-3_3-3"])
def test_fetch_window_and_its_adjoint(mesh_runs, name):
    payload, _, results = mesh_runs
    case = payload["fetch"][name]
    x = case["x"].clone().requires_grad_(True)
    loss = 0
    for r, (a, b) in enumerate(case["windows"]):
        window = x[:, :, a:b]
        np.testing.assert_allclose(results[r]["fetch"][name]["y"], window.detach(), rtol=0, atol=0)
        loss = loss + (case["weight"][:, :, a:b] * window * window).sum()
    loss.backward()
    grad = gathered(results, "fetch", name, "grad", case["total"])
    np.testing.assert_allclose(grad, x.grad, rtol=1e-6, atol=1e-6)


def assert_within(ours, ref, bound=1e-6):
    """max |ours - ref| within ``bound`` of max |ref| (float32 sums of up to
    27 x 16 products in another order; a wrong halo plane is off by O(1))."""
    ref = ref.detach()
    assert ours.shape == ref.shape
    err = float((ours - ref).abs().max()) / float(ref.abs().max())
    assert err <= bound, err


def _unsharded_layer(case):
    from torch_port_mesh_family_ranks import LAYER_KINDS

    layer = LAYER_KINDS[case["kind"]]()
    layer.load_state_dict(case["state"])
    return layer


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_sharded_3d_layer_matches_the_unsharded_layer(mesh_runs, name):
    payload, _, results = mesh_runs
    case = payload["layers"][name]
    layer = _unsharded_layer(case)
    x = case["x"].clone().requires_grad_(True)
    y = layer(x)
    (case["weight"] * y * y).sum().backward()
    D = x.shape[2]
    assert_within(gathered(results, "layers", name, "y", y.shape[2]), y)
    assert_within(gathered(results, "layers", name, "grad", D), x.grad)
    for n, p in layer.named_parameters():
        assert_within(sum(results[r]["layers"][name]["param_grads"][n] for r in range(WORLD)), p.grad)
    if "D3" in name and y.shape[2] == 3:
        assert results[3]["layers"][name]["y"].shape[2] == 0  # the empty rank


@pytest.mark.parametrize("name", ["bn3d_D10", "bn3d_D3", "bn2d"])
def test_batchnorm_statistics_over_hyp(mesh_runs, name):
    """The D-sharded BatchNorm3d's statistics are the whole volume's (summed
    over hyp); the replicated BatchNorm2d's are its input's on every rank."""
    payload, _, results = mesh_runs
    case = payload["bn"][name]
    module = (layers.BatchNorm3d if case["x"].dim() == 5 else layers.BatchNorm2d)(8).train()
    module.load_state_dict(case["state"])
    x = case["x"].clone().requires_grad_(True)
    y = module(x)
    (case["weight"] * y * y).sum().backward()
    for r in range(WORLD):
        for k, v in results[r]["bn"][name]["running"].items():
            np.testing.assert_allclose(v, module.state_dict()[k], rtol=1e-6, atol=1e-7, err_msg=(k, r))
    if x.dim() == 5:
        D = x.shape[2]
        np.testing.assert_allclose(gathered(results, "bn", name, "y", D), y.detach(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gathered(results, "bn", name, "grad", D), x.grad, rtol=1e-5, atol=1e-5)
        for n, p in module.named_parameters():
            summed = sum(results[r]["bn"][name]["param_grads"][n] for r in range(WORLD))
            np.testing.assert_allclose(summed, p.grad, rtol=1e-5, atol=1e-5 * float(p.grad.abs().max()))
    else:
        for r in range(WORLD):
            got = results[r]["bn"][name]
            np.testing.assert_allclose(got["y"], y.detach(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["grad"], x.grad, rtol=1e-5, atol=1e-5)
            for n, p in module.named_parameters():
                np.testing.assert_allclose(got["param_grads"][n], p.grad, rtol=1e-5, atol=1e-5)


def test_hyp_batch_stats_axes_and_layers_refuse_a_missing_depth(monkeypatch):
    """Without a mesh every layer is the unsharded one; under a hyp axis a
    3D layer without its input's global D, or a model with fewer hypotheses
    than the axis' ranks, raises instead of computing something else."""
    import robustmvd_tpu_torch.ops.sharded3d as sharded3d
    import robustmvd_tpu_torch.parallel.context as context

    axis = AxisGroup(None, 4, 1)
    monkeypatch.setattr(context, "_axis", lambda name: axis if name == "hyp" else None)
    assert context.batch_stats_axes() == [] and context.batch_stats_axes(hyp_sharded=True) == [axis]
    monkeypatch.setattr(sharded3d, "hyp_group", lambda: axis)
    for layer in (conv3d_module.Conv3d(8, 8), layers.Conv3d(8, 8, 3, stride=2, padding=1)):
        monkeypatch.setattr(conv3d_module, "hyp_group", lambda: axis)
        monkeypatch.setattr(layers, "hyp_group", lambda: axis)
        with pytest.raises(ValueError, match="global D"):
            layer(torch.zeros(1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="global D"):
        sharded3d.global_depth(torch.zeros(1, 8, 2, 4, 4), None)
    with pytest.raises(ValueError, match="hyp axis"):
        sharded3d.hypothesis_slab(3)
    assert sharded3d.hypothesis_slab(10) == (3, 6)


def mvsnet_extents(D, hyp_rank, hyp):
    """K5's D extents for CostRegNet with "banded" (conv2, conv4, conv6 at
    D/2, D/4, D/8, then prob at D): the slab with its halo, clipped."""
    out = []
    for level in (D // 2, D // 4, D // 8, D):
        lo, hi = shares(level, hyp)[hyp_rank]
        out.append(min(hi + 1, level) - max(lo - 1, 0))
    return out


@pytest.mark.parametrize("name", ["mvsnet_3", "mvsnet_4", "vis_114", "vis_212", "cvp_114"])
def test_sharded_forward_matches_jax_and_the_port_unsharded(mesh_runs, name):
    payload, reference, results = mesh_runs
    single = results[1 if name.startswith("mvsnet") else 2]["single"][name.replace("212", "114")]
    ref = reference[name.split("_")[0] if not name.startswith("mvsnet") else name]
    for r in range(WORLD):
        depth = results[r]["models"][name]["depth"][:, 0].numpy()
        np.testing.assert_allclose(depth, ref, rtol=1e-4, atol=1e-4, err_msg=r)
        np.testing.assert_allclose(depth, single["depth"][:, 0], rtol=1e-5, atol=1e-5, err_msg=r)
        np.testing.assert_allclose(results[r]["models"][name]["depth_uncertainty"], single["depth_uncertainty"],
                                   rtol=1e-5, atol=1e-5, err_msg=r)


@pytest.mark.parametrize("name", ["mvsnet_3", "mvsnet_4", "vis_114", "vis_212", "cvp_114"])
def test_each_rank_runs_the_kernels_on_its_slab(mesh_runs, name):
    """Wrapper calls by D extent: every cost-volume kernel sees the rank's
    slab, K5 the slab and its halo, K3 the gathered D; the counts are the
    unsharded model's (K4: once per view of the rank's view share)."""
    payload, _, results = mesh_runs
    case = payload["models"][name]
    _, view, hyp = case["mesh"]
    single = results[1 if name.startswith("mvsnet") else 2]["single"][name.replace("212", "114")]["calls"]
    for r in range(WORLD):
        calls = results[r]["models"][name]["calls"]
        v, h = (r // hyp) % view, r % hyp

        def slab(D):
            lo, hi = shares(D, hyp)[h]
            return hi - lo

        if name.startswith("mvsnet"):
            V = case["inputs"]["images"].shape[1]
            lo, hi = shares(V - 1, view)[v]
            assert single["warp_volume"] == [MVSNET_D] * (V - 1)
            assert calls["warp_volume"] == [slab(MVSNET_D)] * (hi - lo), (r, calls)
            assert calls["conv3d_banded"] == mvsnet_extents(MVSNET_D, h, hyp), (r, calls)
            assert max(calls["conv3d_banded"]) < MVSNET_D
        elif name.startswith("vis"):
            assert single["sweep_group_cost"] == [D for D in VIS_D for _ in range(2)]
            assert calls["sweep_group_cost"] == [slab(D) for D in VIS_D for _ in range(2)], (r, calls)
            assert calls["soft_argmin"] == single["soft_argmin"] == [D for D in VIS_D for _ in range(2)]
            assert len(calls["conv3d_banded"]) == len(single["conv3d_banded"]) == 30
            for got, whole in zip(calls["conv3d_banded"], single["conv3d_banded"]):
                lo, hi = shares(whole, hyp)[h]
                assert got == min(hi + 1, whole) - max(lo - 1, 0), (r, calls)
        else:
            assert single["sweep_warp"] == list(CVP_D)
            assert calls["sweep_warp"] == [slab(D) for D in CVP_D], (r, calls)
            assert calls["conv3d_banded"] == []  # cvp's default conv3d_impl is cuDNN's
        for kernel in ("sweep_warp", "sweep_group_cost", "warp_volume"):
            assert all(d < max(single[kernel], default=1) for d in calls[kernel]) or not calls[kernel], kernel


@pytest.mark.parametrize("kernel", ["k2", "k2_dense", "k2_group", "k4"])
def test_kernel_wrappers_take_a_hypothesis_slab(kernel):
    """Each cost-volume wrapper takes a strided slice of the hypotheses
    (planes 3..6 of 8) and gives those planes of the whole volume (here its
    plain version; on the card ``test_torch_port_cuda.py::
    test_kernels_take_a_hypothesis_slab`` counts the launches)."""
    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import homography_group_cost
    from robustmvd_tpu_torch.ops.kernels.sweep_warp import sweep_variance
    from robustmvd_tpu_torch.ops.kernels.warp_volume import homo_warp_volume
    from test_torch_port_cuda import _group_inputs, _sweep_inputs, _warp_inputs

    if kernel == "k2_group":
        ref, src, A, Bm, w = _group_inputs(5)
        whole, slab = (homography_group_cost(ref, src, A, Bm, x, groups=8) for x in (w, w[:, 3:7]))
    elif kernel == "k4":
        src, proj, inv, depth = _warp_inputs(5)
        whole, slab = (homo_warp_volume(src, proj, inv, d) for d in (depth, depth[:, 3:7]))
    else:
        ref, src, rot, trans, depth, valid = _sweep_inputs(5, dense=kernel == "k2_dense")
        whole, slab = (sweep_variance(ref, src, rot, trans, d, valid) for d in (depth, depth[:, 3:7]))
    assert slab.shape[1] == 4
    np.testing.assert_allclose(slab, whole[:, 3:7], rtol=1e-6, atol=1e-6)


def test_view_parallel_off_a_mesh_is_the_default_route_and_jax():
    """``create_model("mvsnet_train", view_parallel=True)`` builds; off a
    mesh its depth is the default route's within 1e-5 and JAX's
    ``view_parallel=True`` forward within 1e-4."""
    module = MVSNetModule(num_sampling_steps=MVSNET_D, view_parallel=True)
    variables = _jax_variables(module, _dummy(2), 3)
    sample = mesh_sample(0, 3)
    depth_range = (np.full(2, 2.0, np.float32), np.full(2, 20.0, np.float32))
    jax_depth = np.asarray(reference_step(module.apply, variables, *jax_inputs(*sample),
                                          tuple(map(jnp.asarray, depth_range)))[0]["depth"])[..., 0]
    depths = {}
    with torch_threads(2):
        for label, kwargs in (("view_parallel", {"view_parallel": True}), ("default", {}),
                              ("xla", {"warp_impl": "xla"})):
            model = create_model("mvsnet_train", device="cpu", num_sampling_steps=MVSNET_D, **kwargs)
            model.load_state_dict(state_dict_from_jax(variables), strict=True)
            with torch.no_grad():
                depths[label] = model(**port_inputs(*sample, depth_range=depth_range))[0]["depth"][:, 0].numpy()
    assert model.view_parallel is False and create_model("mvsnet_train", device="cpu", view_parallel=True).view_parallel
    for label in ("default", "xla"):
        np.testing.assert_allclose(depths["view_parallel"], depths[label], rtol=1e-5, atol=1e-5, err_msg=label)
    np.testing.assert_allclose(depths["view_parallel"], jax_depth, rtol=1e-4, atol=1e-4)


def global_loss(results):
    """The global batch's loss: each data rank's loss is its own sample's,
    the same on the ranks of its hyp axis; the global one is their mean
    (as the engine logs it), whose gradient DDP's mean forms."""
    data, _, hyp = results[0]["train_mesh"]
    losses = np.array([results[r]["train"]["loss"] for r in range(WORLD)]).reshape(data, hyp)
    np.testing.assert_array_equal(losses, losses[:, :1].repeat(hyp, 1))
    return float(losses[:, 0].mean())


def test_vis_sharded_train_step_matches_jax_unsharded(mesh_runs):
    _, reference, results = mesh_runs
    j_total, j_grads = reference["train"]
    assert abs(global_loss(results) - j_total) < 1e-3 * abs(j_total)
    # tests/test_parallel.py:294-298's bounds, through the family's weight bridge
    _assert_grad_trees_match(j_grads, variables_from_state_dict(results[0]["train"]["grads"])["params"])


def test_vis_sharded_train_step_matches_the_port_unsharded(mesh_runs):
    """The loss, the gradients and the BatchNorm running statistics within
    rtol 1e-5 of the unsharded step. At JAX's init the data axis' BatchNorm
    statistics (float64 sums over the ranks) and the unsharded ones (flax's
    float32 E[x^2] - E[x]^2) agree to 6e-6 of a gradient; with the family
    tests' randomised BatchNorm shifts the float32 formula cancels and they
    part by 1.9e-3 (ROADMAP.md queue 3)."""
    _, _, results = mesh_runs
    single = results[3]["single"]["train"]
    np.testing.assert_allclose(global_loss(results), single["loss"], rtol=1e-5)
    for r in range(WORLD):
        assert_close(results[r]["train"]["running"], single["running"], rtol=1e-5,
                     atol=1e-7 * max(float(v.abs().max()) for v in single["running"].values()))
    scale = max(float(g.abs().max()) for g in single["grads"].values())
    assert_close(results[0]["train"]["grads"], single["grads"], rtol=1e-5, atol=1e-6 * scale)


def test_vis_sharded_train_step_leaves_every_rank_with_the_same_parameters(mesh_runs):
    _, _, results = mesh_runs
    ref = results[0]["train"]
    np.testing.assert_allclose(ref["digest"], [float(sum(p.double().sum() for p in ref["params"].values())),
                                               float(sum(p.double().square().sum() for p in ref["params"].values()))],
                               rtol=1e-12)
    for r in range(1, WORLD):
        np.testing.assert_allclose(results[r]["train"]["digest"], ref["digest"], rtol=1e-12, err_msg=r)
        for k, v in results[r]["train"]["running"].items():
            np.testing.assert_array_equal(v, ref["running"][k], err_msg=(k, r))
