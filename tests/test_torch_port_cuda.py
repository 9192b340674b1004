"""The port on the card: CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(CUDA kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.ops.corr import planesweep_correlation
from robustmvd_tpu_torch.ops.kernels.planesweep_sample import (
    planesweep_sample,
    planesweep_sample_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _taps(seed, P=40, Hs=6, Ws=8, S=16):
    rng = np.random.RandomState(seed)
    corr = rng.randn(P, Hs, Ws).astype(np.float32)
    y0 = rng.randint(-3, Hs + 2, size=(P, S)).astype(np.int32)
    x0 = rng.randint(-3, Ws + 2, size=(P, S)).astype(np.int32)
    y0[0, :4] = [-1, Hs - 1, int(1e9), -int(1e9)]
    x0[1, :4] = [-1, Ws - 1, int(1e9), -int(1e9)]
    wy = rng.rand(P, S).astype(np.float32)
    wx = rng.rand(P, S).astype(np.float32)
    return [torch.from_numpy(a) for a in (corr, y0, wy, x0, wx)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(40, 6, 8, 16), (1000, 12, 40, 256), (3, 1, 1, 5)])
def test_k1_matches_plain_version(cuda, dtype, shape):
    corr, y0, wy, x0, wx = (t.to(cuda) for t in _taps(0, *shape))
    corr = corr.to(dtype)
    before = planesweep_sample.launches
    out = planesweep_sample(corr, y0, wy, x0, wx)
    torch.cuda.synchronize()
    assert planesweep_sample.launches == before + 1
    ref = planesweep_sample_reference(corr, y0, wy, x0, wx)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    # and the plain version on the card is the one the CPU tests hold to JAX
    cpu = planesweep_sample_reference(corr.cpu(), y0.cpu(), wy.cpu(), x0.cpu(), wx.cpu())
    torch.testing.assert_close(ref.cpu(), cpu, atol=1e-6, rtol=0)


def test_k1_rejects_mixed_devices(cuda):
    corr, y0, wy, x0, wx = _taps(1)
    with pytest.raises(ValueError):
        planesweep_sample(corr.to(cuda), y0, wy.to(cuda), x0.to(cuda), wx.to(cuda))


def test_correlation_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(2)
    B, V, H, W, C, S = 2, 2, 12, 20, 32, 64
    feat_key = rng.randn(B, H, W, C).astype(np.float32)
    feat_src = rng.randn(B, V, H, W, C).astype(np.float32)
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (B, 1, 1))
    Ks = np.tile(K[:, None], (1, V, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    T[:, :, :3, 3] = rng.randn(B, V, 3) * 0.3
    args = [torch.from_numpy(a) for a in (feat_key, feat_src, K, Ks, T)]
    kw = dict(num_sampling_points=S, min_depth=0.4, max_depth=1000.0)
    before = planesweep_sample.launches
    corr_g, mask_g, _ = planesweep_correlation(*(a.to(cuda) for a in args), **kw)
    torch.cuda.synchronize()
    assert planesweep_sample.launches == before + V
    corr_c, mask_c, _ = planesweep_correlation(*args, **kw)
    torch.testing.assert_close(mask_g.cpu(), mask_c, atol=0, rtol=0)
    torch.testing.assert_close(corr_g.cpu(), corr_c, atol=1e-5, rtol=1e-5)


def test_robust_mvd_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(3)
    H, W = 64, 128
    images = [rng.rand(1, 3, H, W).astype(np.float32) * 255 for _ in range(3)]
    K = np.array([[[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]], np.float32)
    poses = [np.eye(4, dtype=np.float32)[None] for _ in range(3)]
    poses[1][0, 0, 3], poses[2][0, 0, 3] = 0.1, -0.1
    sample = dict(images=images, poses=poses, intrinsics=[K] * 3, keyview_idx=np.zeros(1, np.int64))
    _, aux_g = create_model("robust_mvd", device="cuda").run(**sample)
    _, aux_c = create_model("robust_mvd", device="cpu").run(**sample)
    for g, c in zip(aux_g["invdepths_all"], aux_c["invdepths_all"]):
        scale = np.abs(c).mean() + 1e-12
        assert np.abs(g - c).mean() / scale <= 1e-4
        assert np.abs(g - c).max() / scale <= 1e-3
