"""The MVSNet family's training in the port vs the JAX package: one step of
each model, the registries, the forward-only guards and the train CLI.

One step = forward, loss, backward, on the same numpy batch and the same
weights (the JAX ``init``, randomised and bridged with
``state_dict_from_jax``; the score heads conditioned as
``torch_port_helpers.jax_family`` conditions them), fed to the model as the
training engines feed it (no input adapter), at B 1 with 1+2 views:

- vis_mvsnet at 64x64, ``vismvsnet_loss``, against JAX's ``VisMvsnetModule
  (train_bn=True)`` through the JAX wrapper's ``apply_fn_mutable`` under
  ``jax.value_and_grad``: the loss within rtol 1e-4, the gradients at
  ``tests/test_torch_port_train_grad.py``'s bounds (rtol 2e-3, atol max(2e-3
  x the leaf's max |grad|, 1e-4 x the largest), through
  ``variables_from_state_dict``), the new BatchNorm running statistics within
  rtol 1e-5 (atol 1e-6 of the largest |value| of each); ``bn_mode="frozen"``
  leaves them as they were;
- mvsnet_train (16 hypotheses, 64x64, ``mvsnet_loss``) and cvp_mvsnet
  (nscale 3, 64x128, ``SL1Loss``, a DTU-like depth range) with
  ``train=True``: the loss within rtol 1e-4 and the gradients as above;
  cvp's train-mode hypotheses against JAX's to 1e-6.

The JAX steps are compiled with XLA:CPU's backend optimisation off
(:func:`reference_step`): at its default level XLA:CPU miscompiles the
gradient of JAX's Vis-MVSNet stage, 2.8% off the eager JAX gradient in a
patch of a source view's feature gradient and in the regulariser's first
block, where JAX run eagerly, JAX at ``xla_backend_optimization_level`` 0
and the port agree to 1e-5 (and finite differences side with them).

vis_mvsnet at bf16 is ``tests/test_torch_port_family_train_bf16.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustmvd_tpu
from robustmvd_tpu.loss import create_loss as jax_create_loss
from robustmvd_tpu.models.blocks.cvp_mvsnet import cal_depth_hypos as jax_cal_depth_hypos
from robustmvd_tpu.models.cvp_mvsnet import CVPMVSNetModule
from robustmvd_tpu.models.mvsnet import MVSNetModule
from robustmvd_tpu.models.vis_mvsnet import VisMvsnet as JaxVisMvsnet
from robustmvd_tpu.models.vis_mvsnet import VisMvsnetModule
from robustmvd_tpu_torch import create_loss, create_model
import robustmvd_tpu_torch
from robustmvd_tpu_torch.models.blocks.cvp_mvsnet import cal_depth_hypos
from robustmvd_tpu_torch.models.weights import state_dict_from_jax, variables_from_state_dict
from robustmvd_tpu_torch.ops.homography import get_homography_coeffs, matmul_sums
from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import homography_group_cost
from robustmvd_tpu_torch.ops.kernels.build import refuse_gradient
from robustmvd_tpu_torch.ops.kernels.sweep_warp import sweep_variance
from robustmvd_tpu_torch.ops.kernels.warp_volume import homo_warp_volume
from test_gradient_parity import _assert_grad_trees_match

from torch_port_helpers import _dummy, _jax_variables, general_mvd_sample, t, torch_threads

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


VIS_HEAD_GAIN = 4.0  # as torch_port_helpers.jax_family conditions vis's score heads


def reference_step(fn, *args):
    """``fn(*args)`` jitted, with XLA:CPU's backend optimisation off (see
    the module's docstring)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0, "xla_cpu_multi_thread_eigen": False})(*args)


def family_batch(seed, H, W, lo, hi, B=1, V=3, baseline=1.0):
    """A training batch as the engine gives it: images (B, V, 3, H, W) in
    [-0.45, 0.55], absolute intrinsics, key -> source poses with rotations
    (``general_mvd_sample``; translations x ``baseline``), depth (B, 1, H, W)
    in [lo, 1.2 hi] with holes, and the depth range (lo, hi)."""
    rng = np.random.RandomState(seed)
    sample = general_mvd_sample(rng, H, W, V, B)
    poses = np.stack(sample["poses"], 1)
    poses[..., :3, 3] *= baseline
    depth = rng.uniform(lo, 1.2 * hi, size=(B, 1, H, W)).astype(np.float32)
    depth[:, :, ::6, ::5] = 0.0
    return {"images": (np.stack(sample["images"], 1) / 255.0 - 0.45).astype(np.float32), "poses": poses,
            "intrinsics": np.stack(sample["intrinsics"], 1), "keyview_idx": np.zeros(B, np.int64),
            "lo": np.full(B, lo, np.float32), "hi": np.full(B, hi, np.float32), "depth": depth}


def jax_args(batch):
    return (jnp.asarray(np.moveaxis(batch["images"], 2, -1)), jnp.asarray(batch["poses"]),
            jnp.asarray(batch["intrinsics"]), jnp.asarray(batch["keyview_idx"], jnp.int32))


def jax_gt(batch):
    return {"depth": jnp.asarray(np.moveaxis(batch["depth"], 1, -1))}


def port_step(model, loss_name, inputs, batch):
    """forward, loss, backward: (loss, {name: grad}), zeros for unused."""
    loss = create_loss(loss_name, model=model)
    pred, aux = model(**inputs)
    total = loss(inputs, {"depth": t(batch["depth"])}, pred, aux, iteration=0)[0]
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone() for n, p in model.named_parameters()}
    return float(total.detach()), grads


def port_model(name, variables, **kwargs):
    model = create_model(name, device="cpu", train=True, **kwargs)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def assert_grads_match(j_grads, p_grads):
    _assert_grad_trees_match(jax.tree.map(np.asarray, j_grads), variables_from_state_dict(p_grads)["params"])


def assert_stats_match(ours, ref):
    """Running means within rtol 1e-5 and atol 1e-6 of the channel's running
    standard deviation (a mean near 0 is a sum that cancels); variances
    within rtol 1e-5."""
    def by_module(tree):
        return {jax.tree_util.keystr(k[:-1]): (np.asarray(tree_node["mean"]), np.asarray(tree_node["var"]))
                for k, tree_node in _bn_nodes(tree)}

    ours, ref = by_module(ours), by_module(ref)
    assert ours.keys() == ref.keys() and ours
    for name, (mean, var) in ref.items():
        np.testing.assert_allclose(ours[name][1], var, rtol=1e-5, atol=0, err_msg=f"{name} var")
        excess = np.abs(ours[name][0] - mean) - (1e-5 * np.abs(mean) + 1e-6 * np.sqrt(var))
        assert excess.max() <= 0, (name, ours[name][0], mean)


def _bn_nodes(tree, path=()):
    for key, value in tree.items():
        if "mean" in value:
            yield path + (jax.tree_util.DictKey(key), jax.tree_util.DictKey("mean")), value
        else:
            yield from _bn_nodes(value, path + (jax.tree_util.DictKey(key),))


# ---- vis_mvsnet -------------------------------------------------------------


@pytest.fixture(scope="module")
def vis_batch():
    return family_batch(0, 64, 64, 1.0, 10.0)


@pytest.fixture(scope="module")
def vis_variables():
    return _jax_variables(VisMvsnetModule(num_sampling_steps=192, warp_impl="xla"), _dummy(2), 3,
                          prob_gain=VIS_HEAD_GAIN)


def jax_vis_step(variables, batch, dtype="float32"):
    """JAX's vis training step: ``apply_fn_mutable`` (the batch-stats BN
    route of the JAX engine) under ``jax.value_and_grad``, jitted."""
    wrapper = types.SimpleNamespace(module=VisMvsnetModule(num_sampling_steps=192, train_bn=True, warp_impl="xla",
                                                          dtype=dtype))
    loss = jax_create_loss("vismvsnet_loss")
    images, poses, intrinsics, keyview_idx = jax_args(batch)
    depth_range = (jnp.asarray(batch["lo"]), jnp.asarray(batch["hi"]))

    def step(params):
        def loss_fn(p):
            (pred, aux), stats = JaxVisMvsnet.apply_fn_mutable(
                wrapper, {"params": p, "batch_stats": variables["batch_stats"]}, images, poses, intrinsics,
                keyview_idx, depth_range)
            return loss({}, jax_gt(batch), pred, aux, iteration=0, params=p)[0], stats

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, stats), grads = reference_step(step, variables["params"])
    return float(total), grads, stats


def vis_inputs(batch):
    return {"images": t(batch["images"]), "poses": t(batch["poses"]), "intrinsics": t(batch["intrinsics"]),
            "keyview_idx": t(batch["keyview_idx"]), "depth_range": (t(batch["lo"]), t(batch["hi"]))}


@pytest.fixture(scope="module")
def vis_steps(vis_batch, vis_variables):
    jax_total, jax_grads, jax_stats = jax_vis_step(vis_variables, vis_batch)
    model = port_model("vis_mvsnet", vis_variables)
    port_total, port_grads = port_step(model, "vismvsnet_loss", vis_inputs(vis_batch), vis_batch)
    return {"jax": (jax_total, jax_grads, jax_stats), "port": (port_total, port_grads, model)}


def test_vis_train_step_matches_jax(vis_steps):
    (j_total, j_grads, _), (p_total, p_grads, _) = vis_steps["jax"], vis_steps["port"]
    assert np.isfinite(p_total)
    np.testing.assert_allclose(p_total, j_total, rtol=1e-4)
    assert_grads_match(j_grads, p_grads)


def test_vis_train_step_moves_batch_stats_as_jax(vis_steps, vis_variables):
    _, _, model = vis_steps["port"]
    ours = variables_from_state_dict(model.state_dict())["batch_stats"]
    assert_stats_match(ours, vis_steps["jax"][2])
    moved = [k for k, v in state_dict_from_jax(vis_variables).items() if "running" in k
             and not torch.equal(v, model.state_dict()[k])]
    assert len(moved) == sum(1 for k in model.state_dict() if "running" in k)


def test_vis_every_parameter_upstream_of_the_readouts_gets_a_gradient(vis_steps):
    _, p_grads, _ = vis_steps["port"]
    zero = sorted(n for n, g in p_grads.items() if not g.any())
    # the second uncertainty head feeds neither the fusion nor the loss (reference: the occlusion head)
    assert zero == [f"stage{k}.uncert_net.head_1.weight" for k in (1, 2, 3)]


def test_vis_frozen_bn_keeps_running_statistics(vis_batch, vis_variables):
    model = port_model("vis_mvsnet", vis_variables, bn_mode="frozen")
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    total, grads = port_step(model, "vismvsnet_loss", vis_inputs(vis_batch), vis_batch)
    assert np.isfinite(total) and any(g.any() for g in grads.values())
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert model.training and model.warp_impl == "xla"


def test_vis_train_builds_jax_routes():
    model = create_model("vis_mvsnet", device="cpu", train=True, warp_impl="pallas")
    assert model.training and model.warp_impl == "xla" and model.bn_mode == "batch"
    assert all(s.warp_impl == "xla" for s in (model.stage1, model.stage2, model.stage3))
    with pytest.raises(ValueError, match="bn_mode"):
        create_model("vis_mvsnet", device="cpu", train=True, bn_mode="sync")


# ---- mvsnet_train and cvp_mvsnet ---------------------------------------------


def _mvsnet_setup():
    module = MVSNetModule(num_sampling_steps=16, warp_impl="xla", train_bn=False)
    variables = _jax_variables(module, _dummy(2), 3)
    batch = family_batch(1, 64, 64, 1.0, 10.0)
    inputs = {"images": t(batch["images"]), "poses": t(batch["poses"]), "intrinsics": t(batch["intrinsics"]),
              "keyview_idx": t(batch["keyview_idx"]), "depth_range": (t(batch["lo"]), t(batch["hi"]))}
    jax_inputs = (*jax_args(batch), (jnp.asarray(batch["lo"]), jnp.asarray(batch["hi"])))
    return module, variables, batch, inputs, jax_inputs, "mvsnet_loss", {"num_sampling_steps": 16}


def _cvp_setup():
    module = CVPMVSNetModule(nscale=3, mode="train", warp_impl="xla")
    variables = _jax_variables(CVPMVSNetModule(nscale=3, warp_impl="xla"), _dummy(3, with_range=False), 4)
    batch = family_batch(2, 64, 128, 425.0, 935.0, baseline=400.0)  # DTU's depth range, in mm
    batch["images"] = batch["images"] + 0.45  # cvp takes [0, 1]
    inputs = {"images": t(batch["images"]), "poses": t(batch["poses"]), "intrinsics": t(batch["intrinsics"]),
              "keyview_idx": t(batch["keyview_idx"]), "min_depth": t(batch["lo"]), "max_depth": t(batch["hi"])}
    jax_inputs = (*jax_args(batch), jnp.asarray(batch["lo"]), jnp.asarray(batch["hi"]))
    return module, variables, batch, inputs, jax_inputs, "SL1Loss", {"nscale": 3}


@pytest.mark.parametrize("name,setup", [("mvsnet_train", _mvsnet_setup), ("cvp_mvsnet", _cvp_setup)])
def test_train_step_matches_jax(name, setup):
    module, variables, batch, inputs, jax_inputs, loss_name, kwargs = setup()
    loss = jax_create_loss(loss_name)

    def step(params):
        def loss_fn(p):
            pred, aux = module.apply({"params": p, "batch_stats": variables["batch_stats"]}, *jax_inputs)
            return loss({}, jax_gt(batch), pred, aux, iteration=0, params=p)[0]

        return jax.value_and_grad(loss_fn)(params)

    j_total, j_grads = reference_step(step, variables["params"])
    model = port_model(name, variables, **kwargs)
    assert model.training and model.warp_impl == "xla" and not any(
        m.training for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._NormBase))
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    p_total, p_grads = port_step(model, loss_name, inputs, batch)
    assert np.isfinite(p_total) and np.isfinite(float(j_total))
    np.testing.assert_allclose(p_total, float(j_total), rtol=1e-4)
    assert_grads_match(j_grads, p_grads)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def test_cvp_train_hypotheses_match_jax(rng):
    B, H, W = 2, 6, 8
    depth = rng.uniform(400, 900, size=(B, H, W)).astype(np.float32)
    K = np.tile(np.array([[50.0, 0, 4], [0, 50, 3], [0, 0, 1]], np.float32), (B, 1, 1))
    E = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ours = cal_depth_hypos(t(depth), t(K), t(K), t(E), t(E), mode="train").numpy()
    ref = np.asarray(jax_cal_depth_hypos(*(jnp.asarray(a) for a in (depth, K, K, E, E)), mode="train"))
    assert ours.shape == (B, 8, H, W)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.diff(ours, axis=1), 6.8085, rtol=1e-4)
    with pytest.raises(ValueError, match="mode"):
        cal_depth_hypos(t(depth), t(K), t(K), t(E), t(E), mode="val")


# ---- registries, guards, the CLI ----------------------------------------------


def test_registries_match_jax():
    assert robustmvd_tpu_torch.list_losses() == robustmvd_tpu.list_losses()
    assert robustmvd_tpu_torch.list_models(trainable_only=True) == robustmvd_tpu.list_models(trainable_only=True)
    assert robustmvd_tpu_torch.list_models(trainable_only=True) == ["robust_mvd", "vis_mvsnet"]


def _group_cost_args(rng):
    ref, src = (t(rng.randn(1, 6, 8, 16).astype(np.float32)) for _ in range(2))
    cam = torch.zeros(1, 2, 4, 4)
    cam[:, 0] = torch.eye(4)
    cam[:, 1, :3, :3] = torch.tensor([[6.0, 0, 4], [0, 6, 3], [0, 0, 1]])
    src_cam = cam.clone()
    src_cam[:, 0, 0, 3] = 0.2
    A, Bm = get_homography_coeffs(cam, src_cam)
    centres = torch.tensor([[1.0, 0, 0.5], [0, 1, 0.5], [0, 0, 1]])
    w = (1.0 / torch.linspace(1, 5, 4)).reshape(1, 4, 1, 1).expand(1, 4, 6, 8).contiguous()
    return ref, src, matmul_sums(A, centres), matmul_sums(Bm, centres), w


@pytest.mark.parametrize("kernel", ["sweep_warp", "sweep_group_cost", "warp_volume"])
def test_forward_only_kernels_keep_autograd_on_the_cpu(rng, kernel):
    """On a CPU tensor that requires grad the forward-only wrappers run their
    plain version, which autograd differentiates (the guard is for CUDA)."""
    if kernel == "sweep_warp":
        ref = t(rng.randn(1, 6, 8, 4).astype(np.float32)).requires_grad_()
        src = t(rng.randn(1, 2, 6, 8, 4).astype(np.float32))
        rot = torch.eye(3).expand(1, 2, 3, 3).contiguous()
        out = sweep_variance(ref, src, rot, torch.full((1, 2, 3), 0.1), torch.linspace(1, 5, 3).reshape(1, 3))
    elif kernel == "sweep_group_cost":
        ref, src, A, Bm, w = _group_cost_args(rng)
        ref.requires_grad_()
        out = homography_group_cost(ref, src, A, Bm, w, groups=4)
    else:
        ref = t(rng.randn(1, 6, 8, 4).astype(np.float32)).requires_grad_()
        proj = torch.eye(4)[None].clone()
        proj[0, 0, 3] = 0.1
        out = homo_warp_volume(ref, proj, torch.eye(4)[None], torch.linspace(1, 5, 3).reshape(1, 3))
    out.square().sum().backward()
    assert ref.grad is not None and ref.grad.abs().sum() > 0


def test_refuse_gradient_is_the_guard():
    """The CUDA branches' guard: grad mode on and an input that requires grad."""
    x, y = torch.zeros(2, requires_grad=True), torch.zeros(2)
    with pytest.raises(RuntimeError, match="forward-only"):
        refuse_gradient("K", y, x)
    refuse_gradient("K", y, y)
    with torch.no_grad():
        refuse_gradient("K", x)
    with torch.inference_mode():
        refuse_gradient("K", x)


def test_train_cli_trains_vis_and_resumes(tmp_path):
    from robustmvd_tpu_torch.train import cli

    out = tmp_path / "train"
    args = ["--device", "cpu", "--training_type", "mvd", "--dataset", "synthetic.train.mvd", "--model", "vis_mvsnet",
            "--loss", "vismvsnet_loss", "--optimizer", "adam", "--lr", "1e-3", "--scheduler", "mvsnet_scheduler",
            "--batch_size", "1", "--num_workers", "0", "--input_size", "64", "64", "--output", str(out)]
    cli.main(args + ["--max_iterations", "2"])
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["snapshot-iter-000000002.pt"]
    state = torch.load(out / "checkpoints" / "snapshot-iter-000000002.pt", weights_only=True)
    fresh = create_model("vis_mvsnet", device="cpu", train=True, seed=0).state_dict()
    running = [k for k in fresh if "running" in k]
    assert running and all(not torch.equal(state["model"][k], fresh[k]) for k in running)
    cli.main(args + ["--max_iterations", "3"])
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["snapshot-iter-000000002.pt",
                                                                       "snapshot-iter-000000003.pt"]
    weights = out / "weights_only_checkpoints_dir" / "snapshot-iter-000000003.pt"
    model = create_model("vis_mvsnet", device="cpu", weights=str(weights))
    assert not model.training


def test_cvp_trains_after_inference_in_the_same_process():
    """The bicubic upsampling's cached weights are built outside inference
    mode: a forward under ``torch.inference_mode()`` (``model.run``, the
    evaluation engine) at a map size no call has used yet, then a training
    step at that size, backpropagates."""
    from robustmvd_tpu_torch.ops.interpolate import resize_bicubic_x2

    x = torch.rand(1, 7, 13)
    with torch.inference_mode():
        resize_bicubic_x2(x)
    leaf = x.clone().requires_grad_()
    resize_bicubic_x2(leaf).sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
