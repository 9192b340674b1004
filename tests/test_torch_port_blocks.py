"""Port parity: each DispNet block of robust_mvd

(robustmvd_tpu_torch/models/blocks/dispnet.py vs the flax blocks of
robustmvd_tpu/models/blocks/dispnet.py). Parameters come from the flax
block's ``init`` (biases replaced by random values so that their mapping is
tested too) and are bridged with ``state_dict_from_jax``. Narrow spatial
inputs; rtol = atol = 1e-4 (fp32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.models.blocks import dispnet as jd
from robustmvd_tpu_torch.models.blocks import dispnet as td

from torch_port_helpers import load_bridged, t

TOL = dict(rtol=1e-4, atol=1e-4)


def _init(module, rng, *inputs):
    inputs = jax.tree_util.tree_map(jnp.asarray, inputs)
    variables = module.init(jax.random.PRNGKey(rng.randint(1 << 30)), *inputs)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.randn(*v.shape).astype(np.float32) * 0.1
        if path[-1].key == "bias" else np.asarray(v),
        variables["params"],
    )
    return {"params": params}


def _nchw(x):
    return t(np.moveaxis(x, -1, -3))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


@pytest.mark.parametrize("k,s", [(7, 2), (5, 2), (3, 2), (3, 1), (1, 1)])
def test_conv_lrelu(rng, k, s):
    x = rng.randn(2, 9, 12, 5).astype(np.float32)
    jm = jd.ConvLReLU(8, kernel_size=k, stride=s)
    variables = _init(jm, rng, x)
    ours = load_bridged(td.conv_lrelu(5, 8, k, s), variables)(_nchw(x))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


def test_deconv_and_pred_block(rng):
    x = rng.randn(1, 5, 7, 6).astype(np.float32)
    jm = jd.DeconvLReLU(4)
    variables = _init(jm, rng, x)
    # the bridge recognises a ConvTranspose kernel by its "deconv*" path
    port = load_bridged(torch.nn.ModuleDict({"deconv_1": td.deconv_lrelu(6, 4)}), {"deconv_1": variables["params"]})
    ours = port["deconv_1"](_nchw(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    assert ref.shape == (1, 10, 14, 4)
    np.testing.assert_allclose(_nhwc(ours), ref, **TOL)

    x = rng.randn(1, 6, 6, 10).astype(np.float32) * 5
    jm = jd.PredBlock()
    variables = _init(jm, rng, x)
    ours = load_bridged(td.pred_block(10), variables)(_nchw(x))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


def test_encoder_and_context_encoder(rng):
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    jm = jd.DispnetEncoder()
    variables = _init(jm, rng, x)
    port = load_bridged(td.DispnetEncoder(), variables)
    ours, _ = port(_nchw(x))
    ref, _ = jm.apply(variables, jnp.asarray(x))
    for name in ("conv1", "conv2", "conv3a"):
        np.testing.assert_allclose(_nhwc(ours[name]), np.asarray(ref[name]), **TOL)

    f = rng.randn(2, 4, 6, 256).astype(np.float32)
    jm = jd.DispnetContextEncoder()
    variables = _init(jm, rng, f)
    ours = load_bridged(td.DispnetContextEncoder(), variables)(_nchw(f))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(jm.apply(variables, jnp.asarray(f))), **TOL)


@pytest.mark.parametrize("V", [1, 3])
def test_learned_fusion(rng, V):
    """V == 1 is the reference's pass-through (learned_fusion.py:49-52)."""
    B, H, W, S = 2, 5, 7, 16
    corrs = rng.randn(B, V, H, W, S).astype(np.float32)
    masks = (rng.rand(B, V, H, W, S) > 0.3).astype(np.float32)
    masks[:, :, 0, 0] = 0.0  # a pixel no view sees: fused mask 0
    jm = jd.LearnedFusion()
    variables = _init(jm, rng, corrs, masks)
    port = load_bridged(td.LearnedFusion(S), variables)
    ours_c, ours_m = port(t(np.moveaxis(corrs, -1, 2)), t(np.moveaxis(masks, -1, 2)))
    ref_c, ref_m = jm.apply(variables, jnp.asarray(corrs), jnp.asarray(masks))
    np.testing.assert_array_equal(_nhwc(ours_m), np.asarray(ref_m))
    np.testing.assert_allclose(_nhwc(ours_c), np.asarray(ref_c), **TOL)


def test_costvolume_encoder_and_decoder(rng):
    """Full widths (256 ... 1024 channels) at 8x16 -> 1x2."""
    B, H, W, S = 1, 8, 16, 16
    corr = rng.randn(B, H, W, S).astype(np.float32)
    ctx = rng.randn(B, H, W, 32).astype(np.float32)
    jm = jd.DispnetCostvolumeEncoder()
    variables = _init(jm, rng, corr, ctx)
    port = load_bridged(td.DispnetCostvolumeEncoder(S), variables)
    ours_all, ours = port(_nchw(corr), _nchw(ctx))
    ref_all, ref = jm.apply(variables, jnp.asarray(corr), jnp.asarray(ctx))
    assert set(ours_all) == set(ref_all)
    for name in ref_all:
        np.testing.assert_allclose(_nhwc(ours_all[name]), np.asarray(ref_all[name]), **TOL)

    enc = {k: np.asarray(ref_all[k]) for k in ("conv3_1", "conv4_1", "conv5_1")}
    enc["conv2"] = rng.randn(B, 2 * H, 2 * W, 128).astype(np.float32)
    enc["conv1"] = rng.randn(B, 4 * H, 4 * W, 64).astype(np.float32)
    fused = np.asarray(ref)
    jm = jd.DispnetDecoder()
    variables = _init(jm, rng, fused, enc)
    port = load_bridged(td.DispnetDecoder(), variables)
    ours = port(_nchw(fused), {k: _nchw(v) for k, v in enc.items()})
    ref = jm.apply(variables, jnp.asarray(fused), {k: jnp.asarray(v) for k, v in enc.items()})
    assert set(ours) == set(ref)
    for key in ("invdepths_all", "invdepth_log_bs_all", "invdepth_uncertainties_all"):
        assert len(ours[key]) == len(ref[key]) == 6
        for o, r in zip(ours[key], ref[key]):
            np.testing.assert_allclose(_nhwc(o), np.asarray(r), **TOL)
    assert ours["invdepth"].shape == (B, 1, 4 * H, 4 * W)


def test_init_is_seeded_kaiming(rng):
    """Weights from a seed: same seed, same weights; kaiming fan-in std."""
    a, b = td.DispnetEncoder(), td.DispnetEncoder()
    td.init_weights(a, torch.Generator().manual_seed(3))
    td.init_weights(b, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.conv2[0].weight.detach()
    expected = np.sqrt(2.0 / (1.04 * 64 * 25))
    assert abs(float(w.std()) / expected - 1) < 0.02
    assert float(a.conv2[0].bias.detach().abs().max()) == 0.0
