"""robust_mvd at bf16: the port's mixed precision vs the JAX package's

(``dtype="bfloat16"``: parameters, coordinates and prediction heads float32;
convolutions, correlation and fusion bf16). The same numpy inputs and the
same weights (JAX ``init``, bridged with ``state_dict_from_jax``) go through
both packages on the CPU, where K1 v2 and K1b's bf16 form run their plain
versions.

Tolerances. Both packages round every convolution's float32 sum once to bf16
(relative step 2^-8) but sum in another order, so a value may land one bf16
step apart, and such steps carry through the layers that follow:
- one block: mean |d| <= 1e-2 of mean |ref| (a one-step flip in a few
  values), max |d| <= 5e-2 of max |ref|;
- the correlation: within 1e-2 of max |corr|, the limit ``chip_smoke.py``
  holds K1 v2 to (v2 rounds its row weights, pixelscan its column weights);
- the full model: mean |d invdepth| / mean |invdepth at fp32| < 0.05, the
  JAX package's own bf16 bound (tests/test_models.py:113-114);
- a train step's gradients: cosine > 0.98 against JAX's bf16 gradients, the
  bound JAX holds its bf16 gradients to against fp32 (test_models.py:160).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.models.blocks import dispnet as jd
from robustmvd_tpu.ops.corr import planesweep_correlation as jax_corr
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.blocks import dispnet as td
from robustmvd_tpu_torch.models.weights import state_dict_from_jax
from robustmvd_tpu_torch.ops.corr import planesweep_correlation

from torch_port_helpers import K_REL, load_bridged, random_pose, t

BF16 = torch.bfloat16
BLOCK_BOUNDS = (1e-2, 5e-2)  # mean |d| / mean |ref|, max |d| / max |ref|
MODEL_BOUND = 0.05
GRAD_COSINE = 0.98


def _init(module, rng, *inputs):
    inputs = jax.tree_util.tree_map(jnp.asarray, inputs)
    variables = module.init(jax.random.PRNGKey(rng.randint(1 << 30)), *inputs)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.randn(*v.shape).astype(np.float32) * 0.1
        if path[-1].key == "bias" else np.asarray(v),
        variables["params"],
    )
    return {"params": params}


def _nchw(x, dtype=torch.float32):
    return t(np.moveaxis(x, -1, -3)).to(dtype)


def _nhwc(x):
    return np.moveaxis(x.detach().float().numpy(), -3, -1)


def _close(ours, ref, what, bounds=BLOCK_BOUNDS):
    ours, ref = np.asarray(ours, np.float64), np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert ours.shape == ref.shape, what
    diff = np.abs(ours - ref)
    mean, mx = diff.mean() / (np.abs(ref).mean() + 1e-12), diff.max() / (np.abs(ref).max() + 1e-12)
    assert mean <= bounds[0] and mx <= bounds[1], f"{what}: mean {mean:.3g}, max {mx:.3g} > {bounds}"


def test_conv_blocks_at_bf16(rng):
    """ConvLReLU (the encoder's 7x7 stride 2) and DeconvLReLU compute in bf16,
    the prediction head in float32 on bf16 features."""
    x = rng.randn(2, 10, 12, 5).astype(np.float32)
    jm = jd.ConvLReLU(8, kernel_size=7, stride=2, dtype=jnp.bfloat16)
    variables = _init(jm, rng, x)
    ours = load_bridged(td.conv_lrelu(5, 8, 7, 2, dtype=BF16), variables)(_nchw(x))
    ref = jm.apply(variables, jnp.asarray(x))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close(_nhwc(ours), ref, "conv_lrelu")

    x = rng.randn(1, 5, 7, 6).astype(np.float32)
    jm = jd.DeconvLReLU(4, dtype=jnp.bfloat16)
    variables = _init(jm, rng, x)
    port = load_bridged(torch.nn.ModuleDict({"deconv_1": td.deconv_lrelu(6, 4, dtype=BF16)}),
                        {"deconv_1": variables["params"]})
    ours = port["deconv_1"](_nchw(x, BF16))
    ref = jm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close(_nhwc(ours), ref, "deconv_lrelu")

    x = (rng.randn(1, 6, 6, 10) * 5).astype(np.float32)
    jm = jd.PredBlock()
    variables = _init(jm, rng, x)
    ours = load_bridged(td.pred_block(10), variables)(_nchw(x, BF16))
    ref = jm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_encoders_at_bf16(rng):
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    jm = jd.DispnetEncoder(dtype=jnp.bfloat16)
    variables = _init(jm, rng, x)
    ours, _ = load_bridged(td.DispnetEncoder(BF16), variables)(_nchw(x, BF16))
    ref, _ = jm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    for name in ("conv1", "conv2", "conv3a"):
        assert ours[name].dtype == BF16 and ref[name].dtype == jnp.bfloat16
        _close(_nhwc(ours[name]), ref[name], name)

    f = rng.randn(2, 4, 6, 256).astype(np.float32)
    jm = jd.DispnetContextEncoder(dtype=jnp.bfloat16)
    variables = _init(jm, rng, f)
    ours = load_bridged(td.DispnetContextEncoder(BF16), variables)(_nchw(f, BF16))
    _close(_nhwc(ours), jm.apply(variables, jnp.asarray(f, jnp.bfloat16)), "context")


def test_learned_fusion_at_bf16(rng):
    B, V, H, W, S = 2, 3, 5, 7, 16
    corrs = rng.randn(B, V, H, W, S).astype(np.float32)
    masks = (rng.rand(B, V, H, W, S) > 0.3).astype(np.float32)
    masks[:, :, 0, 0] = 0.0  # a pixel no view sees: fused mask 0
    jm = jd.LearnedFusion(dtype=jnp.bfloat16)
    variables = _init(jm, rng, corrs, masks)
    port = load_bridged(td.LearnedFusion(S, BF16), variables)
    ours_c, ours_m = port(t(np.moveaxis(corrs, -1, 2)).to(BF16), t(np.moveaxis(masks, -1, 2)).to(BF16))
    ref_c, ref_m = jm.apply(variables, jnp.asarray(corrs, jnp.bfloat16), jnp.asarray(masks, jnp.bfloat16))
    assert ours_c.dtype == ours_m.dtype == BF16 and ref_c.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_nhwc(ours_m), np.asarray(ref_m, np.float32))
    _close(_nhwc(ours_c), ref_c, "fused corr")


def test_costvolume_encoder_and_decoder_at_bf16(rng):
    """Full widths (256 ... 1024 channels) at 8x16 -> 1x2; float32 heads."""
    B, H, W, S = 1, 8, 16, 16
    corr = rng.randn(B, H, W, S).astype(np.float32)
    ctx = rng.randn(B, H, W, 32).astype(np.float32)
    jm = jd.DispnetCostvolumeEncoder(dtype=jnp.bfloat16)
    variables = _init(jm, rng, corr, ctx)
    port = load_bridged(td.DispnetCostvolumeEncoder(S, BF16), variables)
    ours_all, ours = port(_nchw(corr, BF16), _nchw(ctx, BF16))
    ref_all, ref = jm.apply(variables, jnp.asarray(corr, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16))
    for name in ref_all:
        assert ours_all[name].dtype == BF16
        _close(_nhwc(ours_all[name]), ref_all[name], name)

    # the decoder on the JAX encoder's bf16 outputs, so that both see the same inputs
    enc = {k: np.asarray(ref_all[k], np.float32) for k in ("conv3_1", "conv4_1", "conv5_1")}
    enc["conv2"] = rng.randn(B, 2 * H, 2 * W, 128).astype(np.float32)
    enc["conv1"] = rng.randn(B, 4 * H, 4 * W, 64).astype(np.float32)
    fused = np.asarray(ref, np.float32)
    jm = jd.DispnetDecoder(dtype=jnp.bfloat16)
    variables = _init(jm, rng, fused, enc)
    port = load_bridged(td.DispnetDecoder(BF16), variables)
    ours = port(_nchw(fused, BF16), {k: _nchw(v, BF16) for k, v in enc.items()})
    ref = jm.apply(variables, jnp.asarray(fused, jnp.bfloat16),
                   {k: jnp.asarray(v, jnp.bfloat16) for k, v in enc.items()})
    for key in ("invdepths_all", "invdepth_log_bs_all"):
        for scale, (o, r) in enumerate(zip(ours[key], ref[key])):
            assert o.dtype == torch.float32 and r.dtype == jnp.float32  # the heads stay float32
            _close(_nhwc(o), r, f"{key}[{scale}]")


# --- the correlation at bf16 ---

CB, CV, CH, CW, CC, CS = 1, 2, 6, 8, 256, 32


@pytest.fixture(scope="module", params=[0, 1])
def corr_problem(request):
    """bf16 features (rounded from the same numpy values on both sides) at
    robust_mvd's width C = 256, whose score scale 1/16 is a power of two."""
    rng = np.random.RandomState(request.param)
    feat_key = rng.randn(CB, CH, CW, CC).astype(np.float32)
    feat_src = rng.randn(CB, CV, CH, CW, CC).astype(np.float32)
    K = np.tile(K_REL, (CB, 1, 1))
    Ks = np.tile(K[:, None], (1, CV, 1, 1))
    Ts = np.stack([np.stack([random_pose(rng) for _ in range(CV)]) for _ in range(CB)])
    kw = dict(num_sampling_points=CS, min_depth=0.5, max_depth=100.0)
    corr, mask, _ = planesweep_correlation(t(feat_key).to(BF16), t(feat_src).to(BF16), t(K), t(Ks), t(Ts), **kw)
    return (feat_key, feat_src, K, Ks, Ts), kw, corr, mask


@pytest.mark.parametrize("impl", ["pixelscan", "matmul"])
def test_correlation_at_bf16_matches_jax(corr_problem, impl):
    """Held against the JAX routes that sample bf16 scores; ``"pallas"``
    samples float32 scores even for bf16 features, so it is not this route's
    reference at bf16."""
    (feat_key, feat_src, K, Ks, Ts), kw, corr, mask = corr_problem
    jcorr, jmask, _ = jax_corr(jnp.asarray(feat_key, jnp.bfloat16), jnp.asarray(feat_src, jnp.bfloat16),
                               jnp.asarray(K), jnp.asarray(Ks), jnp.asarray(Ts), impl=impl, **kw)
    assert corr.dtype == mask.dtype == BF16 and jcorr.dtype == jmask.dtype == jnp.bfloat16
    jcorr, jmask = np.asarray(jcorr, np.float32), np.asarray(jmask, np.float32)
    corr, mask = corr.float().numpy(), mask.float().numpy()
    flips = np.argwhere(mask != jmask)
    assert len(flips) <= 1e-4 * mask.size, f"mask flips at (b, v, y, x, s): {flips.tolist()}"
    assert mask.mean() > 0.05  # the comparison is not vacuous
    same = mask == jmask
    np.testing.assert_allclose(corr[same], jcorr[same], rtol=0, atol=1e-2 * np.abs(jcorr).max())


def test_correlation_gradient_at_bf16_is_bf16(corr_problem):
    """The backward of K1 v2 (K1b's bf16 form) hands bf16 gradients to the
    bf16 score product, and so to both bf16 feature maps."""
    (feat_key, feat_src, K, Ks, Ts), kw, _, _ = corr_problem
    fk = t(feat_key).to(BF16).requires_grad_()
    fs = t(feat_src).to(BF16).requires_grad_()
    corr, _, _ = planesweep_correlation(fk, fs, t(K), t(Ks), t(Ts), **kw)
    corr.float().square().sum().backward()
    assert fk.grad.dtype == fs.grad.dtype == BF16
    assert torch.isfinite(fk.grad).all() and fk.grad.abs().max() > 0 and fs.grad.abs().max() > 0


# --- the full model ---

def _bf16_inputs():
    """JAX's ``test_robust_mvd_bf16`` inputs (tests/test_models.py:95-102)."""
    rng = np.random.RandomState(42)
    B, V, H, W = 1, 2, 64, 128
    images = rng.rand(B, V, H, W, 3).astype(np.float32) - 0.4
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[:, 1, 0, 3] = 0.1
    K = np.tile(np.array([[0.8, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (B, V, 1, 1))
    gt = (1.0 / (1.0 + 9.0 * rng.rand(B, H, W, 1))).astype(np.float32)
    return images, poses, K, np.zeros(B, np.int32), gt


@pytest.fixture(scope="module")
def jax_variables():
    return jax_create_model("robust_mvd", pretrained=False, remat=False).variables


def _port_forward(name, variables, dtype, images, poses, K, kv):
    model = load_bridged(create_model(name, device="cpu", dtype=dtype), variables)
    with torch.no_grad():
        _, aux = model(t(np.moveaxis(images, -1, 2)), t(poses), t(K), t(kv, np.int64))
    return aux


@pytest.fixture(scope="module")
def fp32_invdepth(jax_variables):
    """The invdepth scale of the bound: the port's fp32 forward (within 1e-4
    of JAX's, tests/test_torch_port_model.py)."""
    images, poses, K, kv, _ = _bf16_inputs()
    return _port_forward("robust_mvd", jax_variables, "float32", images, poses, K, kv)["invdepth"].numpy()


@pytest.mark.parametrize("name,impl", [("robust_mvd", "pixelscan"), ("robust_mvd", "matmul"),
                                       ("robust_mvd_5M", "pixelscan")])
def test_robust_mvd_at_bf16_matches_jax(jax_variables, fp32_invdepth, name, impl):
    images, poses, K, kv, _ = _bf16_inputs()
    model = jax_create_model(name, pretrained=False, remat=False, dtype="bfloat16", corr_impl=impl)
    model.variables = jax_variables
    _, ref = model.module.apply(jax_variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(K),
                                jnp.asarray(kv))
    aux = _port_forward(name, jax_variables, "bf16", images, poses, K, kv)
    for key in ("invdepth", "invdepth_log_b", "depth", "depth_uncertainty"):
        assert aux[key].dtype == torch.float32 and ref[key].dtype == jnp.float32, key  # float32 heads
    assert all(o.dtype == torch.float32 for o in aux["invdepths_all"])
    ours, theirs = aux["invdepth"].numpy(), np.moveaxis(np.asarray(ref["invdepth"]), -1, 1)
    scale = np.abs(fp32_invdepth).mean() + 1e-6
    rel = np.abs(ours - theirs).mean() / scale
    assert rel < MODEL_BOUND, rel
    assert (fp32_invdepth > 0).mean() > 0.2  # the comparison is not vacuous
    assert np.isfinite(aux["depth"].numpy()).all() and np.isfinite(aux["depth_uncertainty"].numpy()).all()


def test_bf16_train_step_gradients_match_jax(jax_variables):
    """One step's gradients at bf16 (the loss of JAX's
    ``test_robust_mvd_bf16_grads``: mean |finest invdepth - gt| over valid gt)
    against ``jax.grad`` of the JAX bf16 model, carried into the port's
    parameter names by the weight bridge."""
    images, poses, K, kv, gt = _bf16_inputs()
    model = jax_create_model("robust_mvd", pretrained=False, train=True, remat=False, dtype="bfloat16")
    gt_s = jnp.asarray(gt[:, ::2, ::2])

    def loss_fn(params):
        _, aux = model.module.apply({**jax_variables, "params": params}, jnp.asarray(images), jnp.asarray(poses),
                                    jnp.asarray(K), jnp.asarray(kv))
        mask = gt_s > 0
        return jnp.sum(jnp.abs(aux["invdepths_all"][-1] - gt_s) * mask) / jnp.sum(mask)

    ref = state_dict_from_jax({"params": jax.grad(loss_fn)(jax_variables["params"])})

    port = load_bridged(create_model("robust_mvd", device="cpu", dtype="bfloat16", train=True), jax_variables)
    _, aux = port(t(np.moveaxis(images, -1, 2)), t(poses), t(K), t(kv, np.int64))
    gt_t = t(np.moveaxis(gt[:, ::2, ::2], -1, 1))
    mask = (gt_t > 0).float()
    ((aux["invdepths_all"][-1] - gt_t).abs() * mask).sum().div(mask.sum()).backward()

    params = dict(port.named_parameters())
    names = sorted(ref)
    ours = torch.cat([(params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])).flatten()
                      for n in names]).double()
    theirs = torch.cat([torch.as_tensor(np.asarray(ref[n])).flatten() for n in names]).double()
    assert torch.isfinite(ours).all() and ours.abs().max() > 0
    cosine = float(ours @ theirs / (ours.norm() * theirs.norm() + 1e-12))
    assert cosine > GRAD_COSINE, cosine
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in port.parameters())


# --- the CLIs' --dtype ---

@pytest.fixture
def recorded_models(monkeypatch):
    """The create_model calls of the three CLIs, recorded, the models built on
    the CPU at the size the CLIs need."""
    import robustmvd_tpu_torch.eval.cli as eval_cli
    import robustmvd_tpu_torch.inference as inference_cli
    import robustmvd_tpu_torch.train.cli as train_cli

    calls = []

    def record(**kwargs):
        calls.append(kwargs)
        return create_model(**kwargs)

    for module in (eval_cli, inference_cli, train_cli):
        monkeypatch.setattr(module, "create_model", record)
    return calls


def test_dtype_flag_on_the_three_clis(tmp_path, recorded_models):
    import os.path as osp

    from robustmvd_tpu_torch.eval.cli import main as eval_main
    from robustmvd_tpu_torch.inference import load_data
    from robustmvd_tpu_torch.inference import main as inference_main
    from robustmvd_tpu_torch.train.cli import main as train_main

    root = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "sample_data")
    inference_main(["--model", "robust_mvd", "--input_path", root, "--output_path", str(tmp_path / "inf"),
                    "--device", "cpu", "--dtype", "bfloat16"])
    depth = np.load(tmp_path / "inf" / "depth.npy")
    # the CLI's depth is the bf16 model's (in one process: the same CPU threads)
    sample, h, w = load_data(root)
    pred, _ = create_model("robust_mvd", device="cpu", dtype="bfloat16").run(**sample)
    from robustmvd_tpu_torch.utils import resize_bilinear
    np.testing.assert_array_equal(depth, resize_bilinear(pred["depth"], (h, w))[0])

    eval_main(["--eval_type", "mvd", "--dataset", "synthetic.train.mvd", "--model", "robust_mvd", "--inputs",
               "poses", "intrinsics", "--num_samples", "1", "--device", "cpu",
               "--dtype", "bfloat16", "--output", str(tmp_path / "eval")])
    assert osp.isfile(tmp_path / "eval" / "results.csv")
    train_main(["--model", "robust_mvd", "--dtype", "bfloat16", "--dataset", "synthetic.train.mvd", "--loss",
                "robust_mvd_loss", "--max_iterations", "1", "--batch_size", "1", "--num_workers", "0",
                "--device", "cpu", "--output", str(tmp_path / "train")])
    assert osp.isfile(tmp_path / "train" / "checkpoints" / "snapshot-iter-000000001.pt")
    assert [c.get("dtype") for c in recorded_models] == ["bfloat16"] * 3


@pytest.mark.parametrize("cli", ["inference", "eval", "train"])
def test_dtype_flag_is_refused_outside_the_robust_mvd_family(tmp_path, recorded_models, cli):
    from robustmvd_tpu_torch.eval.cli import main as eval_main
    from robustmvd_tpu_torch.inference import main as inference_main
    from robustmvd_tpu_torch.train.cli import main as train_main

    argv = {"inference": (inference_main, ["--input_path", "sample_data", "--output_path", str(tmp_path)]),
            "eval": (eval_main, ["--eval_type", "mvd", "--dataset", "synthetic.train.mvd", "--output", str(tmp_path)]),
            "train": (train_main, ["--dataset", "synthetic.train.mvd", "--loss", "robust_mvd_loss",
                                   "--output", str(tmp_path)])}
    main, args = argv[cli]
    with pytest.raises(SystemExit, match="only supported by the robust_mvd family, not mvsnet_train"):
        main(["--model", "mvsnet_train", "--dtype", "bfloat16", "--device", "cpu", *args])
    assert recorded_models == []
    # without --dtype the model builds as before (the gate passes nothing on)
    from robustmvd_tpu_torch.models import cli_model_kwargs
    assert cli_model_kwargs("mvsnet_train", None) == {}
    assert cli_model_kwargs("robust_mvd_5M", "bfloat16") == {"dtype": "bfloat16"}


def test_unknown_compute_dtype_is_refused():
    """robust_mvd computes in float32 or bf16 only; the parameters are float32
    at either."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        create_model("robust_mvd", device="cpu", dtype="float16")
    model = create_model("robust_mvd_5M", device="cpu", dtype="bf16")
    assert model.compute_dtype == BF16 and all(p.dtype == torch.float32 for p in model.parameters())
