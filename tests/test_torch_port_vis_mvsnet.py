"""vis_mvsnet in the port vs the JAX package, from the blocks up.

The same numpy inputs go through each JAX block and its port on the CPU;
weights come from the JAX ``init``, randomised (BatchNorm statistics and
shifts, biases, the score heads scaled so that no softmax is flat) and
bridged with ``state_dict_from_jax``. The JAX stages run K2's group mode as
the TPU does (``warp_impl="pallas"``, in interpret mode here: the ``"auto"``
default takes the XLA warp off the TPU, whose coordinate clamp differs on
maps under 10 px, ROADMAP queue 3) and plain 3D convolutions
(``conv3d_impl="xla"``). Bounds:
- blocks: rtol 1e-4 with an atol of 1e-5 of the output's scale (sums over
  up to 27 * 128 taps in another order);
- SingleStage and the model: depth relative to its mean magnitude, mean <=
  1e-4 and max <= 1e-3 (measured ~2e-6 and ~3e-5); the windowed probability
  mass (uncertainty) mean |diff| <= 1e-4, and |diff| > 1e-3 on at most 1% of
  the pixels, where the expected index lies within rounding of a window
  edge and the mask flips. The mass is a sum of probabilities of sharply
  peaked softmaxes (score heads scaled by 20), which turn a 1e-6 relative
  change in the scores into ~1e-4 of probability;
- the input adapter: 1e-6 (the same float32 ops).
The JAX modules are initialised under ``jax.jit`` (eager init with the
interpreted kernel takes minutes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.models.blocks import vis_mvsnet as jax_blocks
from robustmvd_tpu.models.vis_mvsnet import VisMvsnet as JaxVisMvsnet
from robustmvd_tpu.models.vis_mvsnet import VisMvsnetModule
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.blocks import vis_mvsnet as blocks
from robustmvd_tpu_torch.models.helpers import resize_to_multiple
from robustmvd_tpu_torch.models.mvsnet import IMAGENET_MEAN, IMAGENET_STD
from robustmvd_tpu_torch.models.weights import state_dict_from_jax, variables_from_state_dict

from torch_port_helpers import general_mvd_sample, randomized_variables, relative_errors, t

MODEL_BOUNDS = (1e-4, 1e-3)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _bridge(variables, port_module, name=None):
    """Load randomised JAX variables into a port module (strictly), under
    the module path ``name`` where the bridge needs it."""
    variables = {"params": {}, "batch_stats": {}, **variables}
    if name is not None:
        variables = {k: {name: v} for k, v in variables.items()}
        port_module = torch.nn.ModuleDict({name: port_module})
    port_module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port_module.eval()


def _run_block(jax_module, port_module, x, rng, name=None, **kwargs):
    """(port outputs, JAX outputs) as lists, the port fed channel-first and
    its outputs moved channel-last."""
    variables = randomized_variables(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs), rng)
    _bridge(variables, port_module, name)
    ref = jax_module.apply(variables, jnp.asarray(x), **kwargs)
    with torch.no_grad():
        out = port_module(t(x).movedim(-1, 1), **kwargs)
    listed = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]  # noqa: E731
    return [o.movedim(1, -1).numpy() for o in listed(out)], [np.asarray(r) for r in listed(ref)]


def _uncertainty_close(ours, ref):
    diff = np.abs(np.asarray(ours) - np.asarray(ref))
    assert diff.mean() <= 1e-4 and (diff > 1e-3).mean() <= 0.01, (diff.mean(), (diff > 1e-3).mean())


def _close(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)


@pytest.mark.parametrize("dim,in_ch,planes,stride", [(2, 8, 16, 2), (2, 16, 16, 1), (3, 8, 16, 2), (3, 8, 8, 1)])
def test_basic_block_matches_jax(rng, dim, in_ch, planes, stride):
    """With and without the downsampling branch, 2D and 3D."""
    down = stride != 1 or in_ch != planes
    x = rng.randn(1, *(8,) * dim, in_ch).astype(np.float32)
    _close(*_run_block(jax_blocks.BasicBlock(planes, stride, down, dim=dim),
                       blocks.BasicBlock(in_ch, planes, stride, dim), x, rng))


def test_res_layer_matches_jax(rng):
    x = rng.randn(1, 8, 12, 16).astype(np.float32)
    _close(*_run_block(jax_blocks.ResLayer(32, 2, 2, dim=2), blocks.ResLayer(16, 32, 2, 2, 2), x, rng))


@pytest.mark.parametrize("dim", [2, 3])
def test_torch_deconv_matches_jax(rng, dim):
    """The transposed conv through the bridge's ``*_deconv`` rule: flipped
    kernels, (I, O, k...) layout, twice the input."""
    x = rng.randn(1, *(4,) * dim, 6).astype(np.float32)
    outs, refs = _run_block(jax_blocks.TorchDeconv(5, dim=dim), blocks.torch_deconv(6, 5, dim), x, rng,
                            name="dec_3_deconv")
    assert refs[0].shape == (1, *(8,) * dim, 5)
    _close(outs, refs)


@pytest.mark.parametrize("dim,filters,in_ch,enc,dec", [(2, (8, 16, 32), 4, 2, 1), (3, (8, 16), 8, 1, 0)])
def test_unet_matches_jax(rng, dim, filters, in_ch, enc, dec):
    """FeatExt's 2D U-Net (three scales out) and the regularisers' 3D one."""
    x = rng.randn(1, *(8,) * dim, in_ch).astype(np.float32)
    multi_scale = len(filters) if dim == 2 else 1
    jax_unet = jax_blocks.UNet(enc, dec, (), filters, (), dim=dim)
    outs, refs = _run_block(jax_unet, blocks.UNet(in_ch, enc, dec, filters, dim), x, rng, multi_scale=multi_scale)
    assert len(refs) == multi_scale
    _close(outs, refs)


def test_feat_ext_matches_jax(rng):
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    outs, refs = _run_block(jax_blocks.FeatExt(), blocks.FeatExt(), x, rng)
    assert [r.shape for r in refs] == [(2, 4, 6, 32), (2, 8, 12, 32), (2, 16, 24, 32)]
    _close(outs, refs)


@pytest.mark.parametrize("name", ["Reg", "RegPair", "RegFuse"])
def test_regularisers_match_jax(rng, name):
    x = rng.randn(2, 4, 8, 12, 8).astype(np.float32)
    _close(*_run_block(getattr(jax_blocks, name)(), getattr(blocks, name)(), x, rng))


def test_uncert_net_matches_jax(rng):
    x = np.abs(rng.randn(2, 8, 12, 1)).astype(np.float32)
    outs, refs = _run_block(jax_blocks.UncertNet(2), blocks.UncertNet(), x, rng)
    assert len(refs) == 2
    _close(outs, refs)


@pytest.fixture(scope="module")
def stage_setup():
    """A JAX SingleStage (group-cost kernel in interpret mode) and its
    randomised variables, inputs at 8x12 with D = 8 and two source views."""
    rng = np.random.RandomState(7)
    B, h, w, C, D = 1, 8, 12, 32, 8
    sample = general_mvd_sample(rng, 4 * h, 4 * w, 3)
    cams = np.zeros((B, 3, 2, 4, 4), np.float32)
    cams[:, :, 0] = np.stack(sample["poses"], 1)
    cams[:, :, 1, :3, :3] = np.stack(sample["intrinsics"], 1)
    cams[:, :, 1, 3, :2] = [1.0, 0.1]  # depth start and interval
    feats = [rng.randn(B, h, w, C).astype(np.float32) for _ in range(3)]
    stage = jax_blocks.SingleStage(conv3d_impl="xla", warp_impl="pallas")
    args = (jnp.asarray(feats[0]), jnp.asarray(cams[:, 0]), [jnp.asarray(f) for f in feats[1:]],
            [jnp.asarray(cams[:, i]) for i in (1, 2)])
    variables = jax.jit(stage.init, static_argnums=(5,), static_argnames=("mode", "s_scale"))(
        jax.random.PRNGKey(0), *args, D, s_scale=4)
    variables = randomized_variables(variables, rng, prob_gain=20.0)
    port = _bridge(variables, blocks.SingleStage())
    return stage, variables, port, feats, cams, D


@pytest.mark.parametrize("mode,valid,per_pixel", [
    ("soft", (1, 1), False), ("soft", (1, 0), True), ("hard", (1, 1), True),
    ("average", (1, 0), False), ("uwta", (1, 1), False), ("maxpool", (1, 1), True)])
def test_single_stage_matches_jax(stage_setup, mode, valid, per_pixel):
    """Every fusion mode; a zero ``src_valid`` drops a view from the soft,
    hard and average fusions; a per-pixel depth start as stages 2 and 3 get."""
    stage, variables, port, feats, cams, D = stage_setup
    B, h, w, _ = feats[0].shape
    rng = np.random.RandomState(8)
    start = (1.0 + rng.rand(B, 1, h, w) if per_pixel else np.full((B, 1, 1, 1), 1.5)).astype(np.float32)
    interval = np.full((B, 1, 1, 1), 0.2, np.float32)
    src_valid = [np.full(B, v, np.float32) for v in valid]
    ref_depth, ref_prob, ref_pairs = stage.apply(
        variables, jnp.asarray(feats[0]), jnp.asarray(cams[:, 0]), [jnp.asarray(f) for f in feats[1:]],
        [jnp.asarray(cams[:, i]) for i in (1, 2)], D, mode=mode, depth_start_override=jnp.asarray(start),
        depth_interval_override=jnp.asarray(interval), s_scale=4, src_valid=[jnp.asarray(v) for v in src_valid])
    with torch.no_grad():
        depth, prob, pairs = port(t(feats[0]), t(cams[:, 0]), [t(f) for f in feats[1:]],
                                  [t(cams[:, i]) for i in (1, 2)], D, mode, t(start), t(interval), 4,
                                  [t(v) for v in src_valid])
    ref_depth = np.asarray(ref_depth)
    assert depth.shape == ref_depth.shape == (B, 1, h, w)
    assert ref_depth.std() > 1e-3 * np.abs(ref_depth).mean()  # not vacuous
    for ours, ref in [(depth, ref_depth)] + [(p[0], r[0]) for p, r in zip(pairs, ref_pairs)]:
        mean, mx = relative_errors(ours.numpy(), np.asarray(ref))
        assert mean <= MODEL_BOUNDS[0] and mx <= MODEL_BOUNDS[1], (mean, mx)
    for p, r in zip(pairs, ref_pairs):
        _close([hd.numpy() for hd in p[1]], [np.asarray(hd) for hd in r[1]])
    _uncertainty_close(prob.numpy(), ref_prob)


@pytest.fixture(scope="module")
def jax_model():
    """JAX vis_mvsnet's module and randomised variables, as
    ``create_model("vis_mvsnet", pretrained=False, warp_impl="pallas",
    conv3d_impl="xla")`` makes them, initialised under jit."""
    module = VisMvsnetModule(num_sampling_steps=192, warp_impl="pallas", conv3d_impl="xla")
    dummy = {"images": jnp.zeros((1, 2, 64, 64, 3)), "poses": jnp.tile(jnp.eye(4), (1, 2, 1, 1)),
             "intrinsics": jnp.tile(jnp.eye(3) * 32, (1, 2, 1, 1)), "keyview_idx": jnp.zeros((1,), jnp.int32),
             "depth_range": (jnp.ones((1,)), jnp.full((1,), 10.0))}
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), **dummy)
    return module, randomized_variables(variables, np.random.RandomState(3), prob_gain=20.0)


def test_weights_round_trip(jax_model):
    """The whole tree (311 leaves: BatchNorms named bn1/bn2, 2D and 3D
    ``*_deconv`` kernels) loads strictly and comes back bit for bit."""
    _, variables = jax_model
    port = create_model("vis_mvsnet", device="cpu")
    state = state_dict_from_jax(variables)
    assert sorted(state) == sorted(port.state_dict())
    port.load_state_dict(state, strict=True)
    back, ref = _leaves(variables_from_state_dict(port.state_dict())), _leaves(variables)
    assert len(ref) == 311 and sorted(back) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)
    jk = np.asarray(variables["params"]["feat_ext"]["unet"]["dec_3_deconv"]["kernel"])  # (kh, kw, I, O)
    w = state["feat_ext.unet.dec_3_deconv.weight"].numpy()  # (I, O, kh, kw), flipped
    assert w.shape == (128, 64, 3, 3)
    np.testing.assert_array_equal(w[5, 7, 0, 1], jk[2, 1, 5, 7])
    assert state["stage1.reg.unet.enc_1.block0.bn1.running_var"].shape == (16,)


def test_vis_mvsnet_matches_jax(jax_model):
    """64x64, 1+2 views, the same bridged weights: depth at every stage."""
    module, variables = jax_model
    sample = general_mvd_sample(np.random.RandomState(5), 64, 64, 3)
    port = create_model("vis_mvsnet", device="cpu")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    pred, aux = port.run(**sample)

    inputs = JaxVisMvsnet.input_adapter(None, **{k: sample[k] for k in ("images", "keyview_idx", "poses",
                                                                        "intrinsics", "depth_range")})
    ref_pred, ref_aux = jax.jit(module.apply)(variables, **inputs)
    ref_depth = np.asarray(ref_pred["depth"]).transpose(0, 3, 1, 2)
    assert pred["depth"].shape == ref_depth.shape == (1, 1, 32, 32)
    assert ref_depth.std() > 1e-3 * ref_depth.mean()  # not vacuous
    for k, (ours, ref) in enumerate(zip(aux["outputs"], ref_aux["outputs"])):
        mean, mx = relative_errors(ours[0], np.asarray(ref[0]))
        assert mean <= MODEL_BOUNDS[0] and mx <= MODEL_BOUNDS[1], (k, mean, mx)
    mean, mx = relative_errors(pred["depth"], ref_depth)
    assert mean <= MODEL_BOUNDS[0] and mx <= MODEL_BOUNDS[1], (mean, mx)
    ref_unc = np.asarray(ref_pred["depth_uncertainty"]).transpose(0, 3, 1, 2)
    _uncertainty_close(pred["depth_uncertainty"], ref_unc)


@pytest.mark.parametrize("H,W", [(64, 128), (48, 80)])
def test_input_adapter_truncates_like_jax(H, W):
    """Pixels with fractions: the reference truncates to uint8 after the
    resize to a multiple of 64, then normalises and flips RGB to BGR. The
    JAX package resizes in a native library where it can, the port in
    numpy: values within rounding of an integer may truncate one level
    apart after a resize (1 / 255 / 0.229 after normalising), on at most
    0.01% of the values; without a resize they agree to 1e-6."""
    rng = np.random.RandomState(9)
    sample = general_mvd_sample(rng, H, W, 3)
    args = {k: sample[k] for k in ("images", "keyview_idx", "poses", "intrinsics")}
    ours = create_model("vis_mvsnet", device="cpu").input_adapter(**args)
    ref = JaxVisMvsnet.input_adapter(None, **args)
    images = ours["images"].numpy()
    assert images.shape == (1, 3, 3, 64, 128)
    diff = np.abs(images - np.asarray(ref["images"]).transpose(0, 1, 4, 2, 3))
    assert (diff > 1e-6).mean() <= (1e-4 if (H, W) != (64, 128) else 0)
    assert diff.max() <= 1 / 255 / 0.229 + 1e-6
    np.testing.assert_allclose(ours["intrinsics"].numpy(), np.asarray(ref["intrinsics"]), rtol=1e-6)
    # without the truncation they would differ by up to 1 / 255 / 0.225
    resized, _, _ = resize_to_multiple(args["images"], args["intrinsics"], 64)
    untruncated = (np.stack(resized, 1) / 255.0 - IMAGENET_MEAN.reshape(3, 1, 1)) / IMAGENET_STD.reshape(3, 1, 1)
    assert np.abs(untruncated[:, :, ::-1] - images).max() > 1e-2
