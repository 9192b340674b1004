"""Port parity for training: the losses, the optimizers and schedules, the
augmentations, K1b, and the engine and its CLI.

The same seeded numpy inputs go through the JAX package and the port (on
the CPU, where K1 and K1b run their plain versions). Bounds:
- ``robust_mvd_loss``: every sub-loss and the total within rtol 1e-5 (fp32
  sums over up to 1e4 pixels and, for the L2 term, 3e7 weights, in another
  order); the L2 filter selects the same parameters in both packages.
- optimizers: the parameters after each step within 1e-6 of optax's,
  relative to the tensor's largest magnitude: the same update, rounded
  elsewhere (optax forms Adam's bias corrections 1 - b^t in float32, where
  1 - 0.999 is 1.3e-5 off, which moves an update by up to 6.4e-6 of the
  learning rate; torch forms them in float64); schedules: the learning
  rate at every count within rtol 1e-6 (optax computes it in float32).
- augmentations and batch augmentations: bit for bit under the same
  ``np.random`` seed (the same numpy code; the JAX package's native resize
  switched off).
- K1's autograd ``Function``: within 1e-6 of autograd through its plain
  version (``scatter_add_`` vs autograd's gather backward, other sum order);
  the correlation's gradients with respect to both feature maps within
  rtol 1e-4, atol 1e-5 x their scale of ``jax.grad`` of the JAX matmul
  route (fp32 products and sums in another order).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import robustmvd_tpu as jrmvd
from robustmvd_tpu.loss.multi_scale_uni_laplace import regularization_l2 as jax_regularization_l2
from robustmvd_tpu.models.weights import convert_torch_state_dict
from robustmvd_tpu.ops.corr import planesweep_correlation as jax_corr
from robustmvd_tpu.optim.factory import build_optax
import robustmvd_tpu_torch as rmvd
from robustmvd_tpu_torch.loss.multi_scale_uni_laplace import regularization_parameters
from robustmvd_tpu_torch.ops.corr import planesweep_correlation
from robustmvd_tpu_torch.ops.kernels import planesweep_sample_backward
from robustmvd_tpu_torch.ops.kernels.planesweep_sample import planesweep_sample_reference, planesweep_sample_with_grad
from robustmvd_tpu_torch.optim import clip_grad_global_norm
from test_torch_port_data import assert_samples_equal, no_native_resize  # noqa: F401  (a fixture)

from torch_port_helpers import K_REL, load_bridged, random_pose, t

ROOT = Path(__file__).resolve().parents[1]


# --- the loss ------------------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    """JAX robust_mvd parameters and the port model carrying them."""
    params = jrmvd.create_model("robust_mvd", pretrained=False, corr_impl="matmul").variables["params"]
    return params, load_bridged(rmvd.create_model("robust_mvd", device="cpu", train=True), {"params": params})


def _decoder_outputs(rng, B=2, H=100, W=150):
    """Inverse-depth ground truth with holes and six coarse-to-fine levels of
    predictions at sizes that do not divide the ground truth's."""
    sizes = [(2, 3), (4, 5), (7, 10), (13, 19), (25, 38), (50, 75)]
    gt = (rng.rand(B, 1, H, W) * 2 + 0.01).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.2] = 0.0
    preds = [(rng.rand(B, 1, h, w) * 2).astype(np.float32) for h, w in sizes]
    log_bs = [(rng.rand(B, 1, h, w) * 4 - 2).astype(np.float32) for h, w in sizes]
    return gt, preds, log_bs


@pytest.mark.parametrize("iteration", [0, 1999, 2000])
def test_robust_mvd_loss_matches_jax(bridged, iteration):
    params, model = bridged
    gt, preds, log_bs = _decoder_outputs(np.random.RandomState(iteration))
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    j_total, j_sub, _ = jrmvd.create_loss("robust_mvd_loss")(
        {}, {"invdepth": nhwc(gt)}, None,
        {"invdepths_all": [nhwc(p) for p in preds], "invdepth_log_bs_all": [nhwc(b) for b in log_bs]},
        iteration=iteration, params=params)
    with torch.no_grad():
        total, sub, pointwise = rmvd.create_loss("robust_mvd_loss", model=model)(
            {}, {"invdepth": t(gt)}, None,
            {"invdepths_all": [t(p) for p in preds], "invdepth_log_bs_all": [t(b) for b in log_bs]},
            iteration=iteration)
    assert sorted(sub) == sorted(j_sub)
    for name in j_sub:
        np.testing.assert_allclose(float(sub[name]), float(j_sub[name]), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    assert float(sub["01_reg"]) > 0 and len(pointwise) == 6


def test_l2_filter_selects_the_jax_parameter_set(bridged):
    """Selected port parameters, marked with ones and carried onto the JAX
    tree by its bridge, are exactly the leaves the JAX filter regularises."""
    params, model = bridged
    selected = {name for name, _ in regularization_parameters(model)}
    marked = {name: (np.ones if name in selected else np.zeros)(tuple(v.shape), np.float32)
              for name, v in model.state_dict().items()}
    port_paths = {jax.tree_util.keystr(path) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(convert_torch_state_dict(marked)["params"]) if leaf.all()}
    leaves = jax.tree_util.tree_leaves_with_path(params)
    jax_paths = set()
    for path, _ in leaves:
        only = jax.tree_util.tree_map_with_path(lambda p, _: jnp.float32(1.0 if p == path else 0.0), params)
        if float(jax_regularization_l2(only, 1.0)) > 0:
            jax_paths.add(jax.tree_util.keystr(path))
    assert port_paths == jax_paths
    assert 0 < len(jax_paths) < len(leaves)
    assert not any("pred" in p or "bias" in p for p in jax_paths)


# --- optimizers and schedules ---------------------------------------------

SHAPES = [(4, 3), (7,), (2, 3, 5)]
STEP_SCALES = [1e-3, 1.0, 10.0, 1e-2, 3.0, 0.1]  # the global norm falls below and above the clip


def _grad_sequence(rng):
    """Per step, gradients whose elements span 1e-7 ... 10 (the optimizers'
    eps matters for the small ones)."""
    return [[(rng.randn(*s) * 10 ** rng.uniform(-6, 0, size=s) * scale).astype(np.float32) for s in SHAPES]
            for scale in STEP_SCALES]


@pytest.mark.parametrize("clip", [None, 2.0])
@pytest.mark.parametrize("scheduler", ["flownet_scheduler", "mvsnet_scheduler"])
@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_optimizers_match_optax(optimizer, scheduler, clip):
    rng = np.random.RandomState(3)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    lr = 1e-2  # large enough that a wrong update shows at rtol 1e-6

    # torch updates in place: no tensor may share memory with an array JAX reads
    plist = torch.nn.ParameterList([torch.nn.Parameter(t(p).clone()) for p in init])
    opt = rmvd.create_optimizer(optimizer, model=plist, lr=lr)
    sched = rmvd.create_scheduler(scheduler, optimizer=opt)

    tx, _ = build_optax(jrmvd.create_optimizer(optimizer, lr=lr), jrmvd.create_scheduler(scheduler), clip)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)

    clipped = []
    for grads in _grad_sequence(rng):
        for p, g in zip(plist, grads):
            p.grad = t(g).clone()
        if clip is not None:
            clipped.append(float(clip_grad_global_norm(plist.parameters(), clip)) >= clip)
        opt.step()
        sched.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, j in zip(plist, jparams):
            j = np.asarray(j)
            np.testing.assert_allclose(p.detach().numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max())
    if clip is not None:
        assert any(clipped) and not all(clipped)


@pytest.mark.parametrize("name,counts", [
    ("flownet_scheduler", [0, 1, 299999, 300000, 300001, 399999, 400000, 400001, 499999, 500000, 500001, 600000]),
    ("mvsnet_scheduler", [0, 1, 2, 1000, 10000, 99999, 300000, 599999]),
])
def test_schedules_give_optax_learning_rates(name, counts):
    """The rate that update ``count`` (from 0) takes: the scheduler stepped
    ``count`` times, as after a resume from a snapshot at ``count``."""
    schedule = jrmvd.create_scheduler(name).schedule_fn(1e-4)
    opt = rmvd.create_optimizer("adam", model=torch.nn.ParameterList([torch.nn.Parameter(torch.zeros(2))]), lr=1e-4)
    sched = rmvd.create_scheduler(name, optimizer=opt)
    opt.step()  # no gradients: no update
    for count in counts:
        sched.last_epoch = count - 1
        sched.step()
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(count)), rtol=1e-6, err_msg=str(count))


def test_clip_follows_optax_not_clip_grad_norm():
    """(g / norm) * max_norm, no 1e-6 in the divisor; untouched below the norm."""
    g = [np.full((3,), 4.0, np.float32), np.full((4,), 3.0, np.float32)]
    for max_norm in (1.0, 100.0):
        params = [torch.nn.Parameter(torch.zeros(len(a))) for a in g]
        for p, a in zip(params, g):
            p.grad = t(a).clone()
        norm = clip_grad_global_norm(params, max_norm)
        ref = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in g], None)[0]
        np.testing.assert_allclose(float(norm), np.sqrt(3 * 16 + 4 * 9), rtol=1e-6)
        for p, r in zip(params, ref):
            np.testing.assert_array_equal(p.grad.numpy(), np.asarray(r))


# --- augmentations ----------------------------------------------------------


def _augmented(package, preset, seed, num_samples=2):
    dataset = package.create_dataset("synthetic.train.mvd", num_samples=num_samples, num_views=3, height=60,
                                     width=100, augmentations=preset)
    np.random.seed(seed)
    return [dataset[i] for i in range(num_samples)]


@pytest.mark.parametrize("preset", sorted(jrmvd.list_augmentations()))
def test_augmentations_are_jax_bit_for_bit(no_native_resize, preset):  # noqa: F811
    assert rmvd.list_augmentations() == jrmvd.list_augmentations()
    ours, ref = _augmented(rmvd, preset, 5), _augmented(jrmvd, preset, 5)
    for o, r in zip(ours, ref):
        assert_samples_equal(o, r)


def test_batch_augmentations_are_jax_bit_for_bit(no_native_resize):  # noqa: F811
    """Thirteen batches: Scale3DEqualizedBatch rescales from its eleventh on,
    its histogram carried from batch to batch."""
    assert rmvd.list_batch_augmentations() == jrmvd.list_batch_augmentations() == ["robust_mvd_batch_augmentations"]
    preset = "robust_mvd_augmentations_staticthings3d"
    batches = {}
    for package, collate in ((rmvd, rmvd.utils.numpy_collate), (jrmvd, jrmvd.utils.numpy_collate)):
        np.random.seed(11)
        augment = package.create_batch_augmentation("robust_mvd_batch_augmentations")
        dataset = package.create_dataset("synthetic.train.mvd", num_samples=26, num_views=2, height=48,
                                         width=80, augmentations=preset)
        out = []
        for b in range(13):
            batch = collate([dataset[2 * b], dataset[2 * b + 1]])
            augment(batch)
            out.append(batch)
        batches[package.__name__] = out
    ours, ref = batches["robustmvd_tpu_torch"], batches["robustmvd_tpu"]
    assert not np.array_equal(ref[-1]["poses"][1], ref[-1]["poses"][0])
    for o, r in zip(ours, ref):
        assert_samples_equal(o, r)


def test_compound_dataset_indexes_like_jax():
    parts = [dict(num_samples=n, num_views=2, height=8, width=12) for n in (2, 3)]
    ours = rmvd.create_compound_dataset([rmvd.create_dataset("synthetic.train.mvd", **kw) for kw in parts])
    ref = jrmvd.create_compound_dataset([jrmvd.create_dataset("synthetic.train.mvd", **kw) for kw in parts])
    assert len(ours) == len(ref) == 5 and ours.name == ref.name
    for i in range(5):
        assert_samples_equal(ours[i], ref[i])


# --- K1b and the correlation's gradient -------------------------------------


def test_k1_function_gradient_matches_autograd_of_plain_version():
    rng = np.random.RandomState(0)
    P, Hs, Ws, S = 50, 6, 9, 40
    corr = rng.randn(P, Hs, Ws).astype(np.float32)
    y0 = rng.randint(-2, Hs + 1, (P, S)).astype(np.int32)
    x0 = rng.randint(-2, Ws + 1, (P, S)).astype(np.int32)
    y0[:, :8], x0[:, :8] = 2, 3  # coinciding taps
    y0[0, 8:12] = [-1, Hs - 1, int(1e9), -int(1e9)]
    wy, wx = rng.rand(P, S).astype(np.float32), rng.rand(P, S).astype(np.float32)
    g = rng.randn(P, S).astype(np.float32)
    taps = [t(a) for a in (y0, wy, x0, wx)]
    grads = []
    for fn in (planesweep_sample_with_grad, planesweep_sample_reference):
        leaf = t(corr).requires_grad_()
        out = fn(leaf, *taps)
        out.backward(t(g))
        grads.append((out.detach(), leaf.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=1e-6)
    assert planesweep_sample_backward.launches == 0  # the CPU takes the plain version


def test_correlation_gradients_match_jax_matmul_route():
    """d/d(feat_key, feat_src) of sum(w * corr) for random w, 2 source views."""
    rng = np.random.RandomState(1)
    B, V, H, W, C, S = 2, 2, 6, 8, 16, 32
    feat_key = rng.randn(B, H, W, C).astype(np.float32)
    feat_src = rng.randn(B, V, H, W, C).astype(np.float32)
    K = np.tile(K_REL, (B, 1, 1))
    Ks = np.tile(K[:, None], (1, V, 1, 1))
    Ts = np.stack([np.stack([random_pose(rng) for _ in range(V)]) for _ in range(B)])
    w = rng.randn(B, V, H, W, S).astype(np.float32)
    kw = dict(num_sampling_points=S, min_depth=0.5, max_depth=100.0)

    key, src = t(feat_key).requires_grad_(), t(feat_src).requires_grad_()
    corr, mask, _ = planesweep_correlation(key, src, t(K), t(Ks), t(Ts), **kw)
    (corr * t(w)).sum().backward()

    def jloss(fk, fs):
        c, _, _ = jax_corr(fk, fs, jnp.asarray(K), jnp.asarray(Ks), jnp.asarray(Ts), impl="matmul", **kw)
        return jnp.sum(c * jnp.asarray(w))

    jgk, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat_key), jnp.asarray(feat_src))
    assert mask.mean() > 0.05
    for ours, ref in ((key.grad.numpy(), np.asarray(jgk)), (src.grad.numpy(), np.asarray(jgs))):
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
        assert np.abs(ref).max() > 0


# --- the engine and its CLI -------------------------------------------------


def _engine(out_dir, max_iterations, model):
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=4, num_views=2, height=64, width=64,
                                  augmentations=[rmvd.data.transforms.Compose([
                                      rmvd.data.transforms.NormalizeImagesToMinMax(-0.4, 0.6),
                                      rmvd.data.transforms.NormalizeIntrinsics()])])
    optimizer = rmvd.create_optimizer("adam", model=model, lr=1e-4)
    return rmvd.create_training(
        "mvd", out_dir=str(out_dir), model=model, dataset=dataset, optimizer=optimizer,
        scheduler=rmvd.create_scheduler("flownet_scheduler", optimizer=optimizer),
        loss=rmvd.create_loss("robust_mvd_loss", model=model), batch_size=2, max_iterations=max_iterations,
        batch_augmentations="robust_mvd_batch_augmentations", grad_clip_max_norm=5.0, num_workers=0,
        verbose=False)


def test_training_runs_resumes_and_writes_loadable_weights(tmp_path):
    """The twin of tests/test_engines.py::test_training_runs_and_resumes."""
    np.random.seed(0)
    model = rmvd.create_model("robust_mvd", device="cpu", train=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = _engine(tmp_path, 2, model)()
    assert state["iteration"] == 2
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    snaps = sorted(os.listdir(tmp_path / "checkpoints"))
    assert snaps == ["snapshot-iter-000000002.pt"]
    weights = tmp_path / "weights_only_checkpoints_dir" / "snapshot-iter-000000002.pt"
    loaded = rmvd.create_model("robust_mvd", device="cpu", weights=str(weights))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    # a new engine picks up the newest snapshot and trains from 2 to 3
    model2 = rmvd.create_model("robust_mvd", device="cpu", train=True, seed=1)
    training2 = _engine(tmp_path, 3, model2)
    assert training2.finished_iterations == 2
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    assert training2.optimizer.state_dict()["state"][0]["step"] == 2
    assert training2()["iteration"] == 3
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["snapshot-iter-000000002.pt", "snapshot-iter-000000003.pt"]
    assert _engine(tmp_path, 3, model2)()["iteration"] == 3  # already finished: no step


def test_snapshots_keep_the_newest_three(tmp_path):
    from robustmvd_tpu_torch.utils.checkpoint import TrainStateSaver

    saver = TrainStateSaver(str(tmp_path))
    for iteration in (5, 40, 7, 100, 9):
        saver.save({"iteration": iteration}, iteration)
    assert [os.path.basename(p) for p in saver.snapshots()] == [
        "snapshot-iter-000000009.pt", "snapshot-iter-000000040.pt", "snapshot-iter-000000100.pt"]
    assert saver.restore() == ({"iteration": 100}, 100)


def test_train_cli_on_the_cpu(tmp_path):
    out = tmp_path / "tr"
    cmd = [sys.executable, "-m", "robustmvd_tpu_torch.train", "--device", "cpu", "--training_type", "mvd",
           "--dataset", "synthetic.train.mvd", "--model", "robust_mvd", "--loss", "robust_mvd_loss",
           "--optimizer", "adam", "--lr", "1e-4", "--max_iterations", "2", "--batch_size", "2",
           "--num_workers", "0", "--output", str(out)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Finished training MultiViewDepthTraining." in proc.stdout
    assert os.listdir(out / "weights_only_checkpoints_dir") == ["snapshot-iter-000000002.pt"]
    assert (out / "cmd.txt").read_text().startswith("python -m robustmvd_tpu_torch.train --device cpu")

