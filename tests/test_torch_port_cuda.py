"""The port on the card: CUDA kernels against their plain versions, the
models, the evaluation engine and the training step against the port on the
CPU.

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
    planesweep_sample_with_grad,
)
from robustmvd_tpu_torch.ops.kernels.planesweep_sample_backward import (
    planesweep_sample_backward,
    planesweep_sample_backward_reference,
    planesweep_sample_backward_route,
)
from robustmvd_tpu_torch.ops.homography import get_homography_coeffs, matmul_sums
from robustmvd_tpu_torch.ops.kernels.soft_argmin import (
    fused_soft_argmin,
    fused_soft_argmin_reference,
    soft_argmin_route,
)
from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import (
    homography_group_cost,
    homography_group_cost_reference,
    homography_group_cost_route,
)
from robustmvd_tpu_torch.ops.kernels.sweep_warp import sweep_variance, sweep_variance_reference, sweep_warp_tiling
from robustmvd_tpu_torch.ops.kernels.conv3d import conv3d_banded, conv3d_banded_path, conv3d_banded_reference
from robustmvd_tpu_torch.ops.kernels.warp_volume import homo_warp_volume, homo_warp_volume_reference

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


def _sweep_inputs(seed, B=2, V=2, H=12, W=20, C=32, D=8, dense=False):
    """K2's arguments: a row of cameras around the key, planes from 0.5 to 10
    (one at z = 0 of the first source view: non-finite coordinates)."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, H, W, C).astype(np.float32)
    src = rng.randn(B, V, H, W, C).astype(np.float32)
    rot = np.tile(np.array([[1.0, 0, -W / 2], [0, 1.0, -H / 2], [0, 0, 1]], np.float32), (B, V, 1, 1))
    rot += rng.randn(B, V, 3, 3).astype(np.float32) * 0.01
    rot[:, :, 2] = [0.0, 0.0, 1.0]
    trans = (rng.randn(B, V, 3) * [2.0, 1.0, 0.0]).astype(np.float32)
    trans[:, 0, 2] = -3.0
    depth = np.tile(np.linspace(0.5, 10.0, D, dtype=np.float32), (B, 1))
    depth[:, 1] = 3.0
    if dense:
        depth = (depth[:, :, None, None] * (1 + 0.1 * rng.rand(B, D, H, W))).astype(np.float32)
    valid = np.ones((B, V), np.float32)
    valid[-1, -1] = 0.0
    return [torch.from_numpy(a) for a in (ref, src, rot, trans, depth, valid)]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("C", [32, 16, 8, 6])  # 6: one channel per lane (C % 4 != 0)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain_version(cuda, dense, C, dtype):
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs(4, C=C, dense=dense))
    ref, src = ref.to(dtype), src.to(dtype)
    before = sweep_variance.launches
    out = sweep_variance(ref, src, rot, trans, depth, valid)
    torch.cuda.synchronize()
    assert sweep_variance.launches == before + 1
    plain = sweep_variance_reference(ref, src, rot, trans, depth, valid)
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(out).all()
    # the plain version on the card is the one the CPU tests hold to JAX
    cpu = sweep_variance_reference(*(a.cpu() for a in (ref, src, rot, trans, depth, valid)))
    torch.testing.assert_close(plain.cpu(), cpu, atol=1e-5, rtol=1e-5)
    out16 = sweep_variance(ref, src, rot, trans, depth, valid, out_dtype=torch.bfloat16)
    torch.testing.assert_close(out16.float(), plain.bfloat16().float(), atol=1e-2, rtol=1e-2)


def test_k2_unaligned_rows_take_one_channel_per_lane(cuda):
    """A map that starts 4 bytes into its storage cannot be read in 16-byte
    vectors; the kernel takes one channel per lane and agrees all the same."""
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs(7, C=16))
    src_off = torch.empty(src.numel() + 1, device=cuda)[1:].view(src.shape).copy_(src)
    out = sweep_variance(ref, src_off, rot, trans, depth, valid)
    torch.testing.assert_close(out, sweep_variance_reference(ref, src, rot, trans, depth, valid), atol=1e-5, rtol=1e-5)


def _on_map_share(rot, trans, depth, H, W, Hs, Ws):
    """Share of the first view's samples whose 00 tap lies on its map."""
    from robustmvd_tpu_torch.ops.homography import sweep_coordinates

    B, D = depth.shape[:2]
    d = depth.reshape(B, D, H * W) if depth.dim() == 4 else depth
    xi, yi = sweep_coordinates(rot[:, 0], trans[:, 0], d, H, W, Hs, Ws)
    return float(((xi >= 0) & (xi <= Ws - 1) & (yi >= 0) & (yi <= Hs - 1)).float().mean())


def _sweep_inputs_on_map(seed, V, H, W, C, D, B=1, dense=False):
    """K2's arguments with most samples on the source maps: pixel-space
    transforms near the identity, each source view shifted by 5-20 px at
    depth 1 (disparity over planes 0.5..10); every view valid."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, H, W, C).astype(np.float32)
    src = rng.randn(B, V, H, W, C).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
    rot[:, :, :2] += rng.randn(B, V, 2, 3).astype(np.float32) * [1e-3, 1e-3, 1e-1]
    trans = np.zeros((B, V, 3), np.float32)
    trans[..., 0] = rng.uniform(5, 20, (B, V)) * rng.choice([-1, 1], (B, V))
    trans[..., 1] = rng.uniform(-1, 1, (B, V))
    depth = np.tile(np.linspace(0.5, 10.0, D, dtype=np.float32), (B, 1))
    if dense:
        depth = (depth[:, :, None, None] * (1 + 0.1 * rng.rand(B, D, H, W))).astype(np.float32)
    return [torch.from_numpy(a) for a in (ref, src, rot, trans, depth, np.ones((B, V), np.float32))]


@pytest.mark.parametrize("case", [
    dict(V=2, H=96, W=320, C=32, D=256, dtype=torch.float32),  # mvsnet_train's volume
    dict(V=2, H=96, W=320, C=32, D=256, dtype=torch.bfloat16),  # with bf16 features
    dict(V=2, H=384, W=1280, C=16, D=8, dtype=torch.float32, dense=True),  # cvp_mvsnet's finest level
], ids=["mvsnet_f32", "mvsnet_bf16", "cvp_dense"])
def test_k2_at_main_path_shapes_matches_plain_version_bit_for_bit(cuda, case):
    """K2 at the main paths' shapes: equal to its plain version (the same
    operations on the same values in the same order)."""
    case = dict(case)
    dtype = case.pop("dtype")
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs_on_map(15, **case))
    ref, src = ref.to(dtype), src.to(dtype)
    out = sweep_variance(ref, src, rot, trans, depth, valid)
    torch.cuda.synchronize()
    assert torch.equal(out, sweep_variance_reference(ref, src, rot, trans, depth, valid))
    H, W = ref.shape[1:3]
    assert _on_map_share(rot, trans, depth, H, W, H, W) > 0.3


@pytest.mark.parametrize("V", [1, 3, 8])
@pytest.mark.parametrize("W", [20, 200, 513, 1100])  # one tile; two or more tiles not a multiple of the tile
@pytest.mark.parametrize("C", [32, 12, 6])  # 32: 8 channels per vector; 12, 6: one (C % 8 != 0)
def test_k2_row_tiles_and_views_match_plain_version(cuda, V, W, C):
    """K2 walks each output row in tiles of at most 512 pixels, fewer for
    many views (192 at V = 8): every W, V and C gives the plain version's
    volume bit for bit, with the last view of the last batch element masked."""
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs_on_map(W + V + C, V=V, H=4, W=W, C=C,
                                                                                    D=3, B=2))
    valid[-1, -1] = 0.0
    before = sweep_variance.launches
    out = sweep_variance(ref, src, rot, trans, depth, valid)
    torch.cuda.synchronize()
    assert sweep_variance.launches == before + 1
    assert out.shape == (2, 3, 4, W, C)
    assert torch.equal(out, sweep_variance_reference(ref, src, rot, trans, depth, valid))
    assert _on_map_share(rot, trans, depth, 4, W, 4, W) > 0.1


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_one_plane_and_bf16_output_match_plain_version(cuda, dense, dtype):
    """D = 1 (one plane per block z) with a masked view, and the bf16 output:
    equal to the plain version's float32 result rounded to bf16."""
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs_on_map(16, V=3, H=12, W=37, C=32, D=1,
                                                                                    dense=dense))
    ref, src = ref.to(dtype), src.to(dtype)
    valid[0, 1] = 0.0
    plain = sweep_variance_reference(ref, src, rot, trans, depth, valid)
    assert torch.equal(sweep_variance(ref, src, rot, trans, depth, valid), plain)
    out16 = sweep_variance(ref, src, rot, trans, depth, valid, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16 and torch.equal(out16, plain.bfloat16())


@pytest.mark.parametrize("C", [16, 6])
def test_k2_views_beyond_shared_memory_match_plain_version(cuda, C):
    """50 source views over rows of 96 pixels: three row tiles of 32 pixels,
    the least tile, whose shared memory holds the taps of 48 views; the last
    two views' taps are computed by each thread, in the same op order."""
    assert sweep_warp_tiling(50, 96) == (32, 48)
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs(17, V=50, H=4, W=96, C=C, D=2))
    valid[0, 10] = 0.0
    out = sweep_variance(ref, src, rot, trans, depth, valid)
    assert torch.equal(out, sweep_variance_reference(ref, src, rot, trans, depth, valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_unaligned_maps_match_plain_version_bit_for_bit(cuda, dtype):
    """Key and source maps one element into their storage: the one-channel
    path over several row tiles, bit for bit."""
    ref, src, rot, trans, depth, valid = (a.to(cuda) for a in _sweep_inputs(18, V=3, H=4, W=600, C=16))
    ref, src = ref.to(dtype), src.to(dtype)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda, dtype=dtype)[1:].view(t.shape).copy_(t)

    out = sweep_variance(shifted(ref), shifted(src), rot, trans, depth, valid, out_dtype=torch.bfloat16)
    assert torch.equal(out, sweep_variance_reference(ref, src, rot, trans, depth, valid, out_dtype=torch.bfloat16))


def test_k2_rejects_mixed_devices(cuda):
    ref, src, rot, trans, depth, valid = _sweep_inputs(5)
    with pytest.raises(ValueError):
        sweep_variance(ref.to(cuda), src.to(cuda), rot, trans.to(cuda), depth.to(cuda), valid.to(cuda))


def _family_sample(seed, H, W):
    """Three views with tilted, rotated cameras (a camera that only rotates
    about y makes CVP-MVSNet's interval singular on the principal row)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    images = [rng.rand(1, 3, H, W).astype(np.float32) * 255 for _ in range(3)]
    K = np.array([[[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]], np.float32)
    poses = [np.eye(4, dtype=np.float32)[None] for _ in range(3)]
    for i in (1, 2):
        poses[i][0, :3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        poses[i][0, :3, 3] = rng.randn(3) * 0.1 + [0.1 * i, 0.0, 0.0]
    return dict(images=images, poses=poses, intrinsics=[K] * 3, keyview_idx=np.zeros(1, np.int64),
                depth_range=(np.array([1.0], np.float32), np.array([10.0], np.float32)))


@pytest.mark.parametrize("name,launches", [("mvsnet_train", 1), ("cvp_mvsnet", 5)])
def test_family_on_card_matches_cpu(cuda, name, launches):
    """Card vs CPU, TF32 off: depth relative to its mean magnitude, mean
    <= 1e-4 and max <= 1e-3 (fp32 sums in another order through the 3D
    U-Nets); at most 1% of the uncertainty pixels pick another window. For
    cvp_mvsnet that holds at the coarsest level; the finer levels space
    their hypotheses by a mean over near-singular per-pixel solves, which
    magnifies rounding differences (chip_smoke.py ``CVP_FINE_BOUNDS``):
    mean <= 1e-2, max <= 5e-2."""
    sample = _family_sample(6, 128, 192)
    before = sweep_variance.launches
    pred_g, aux_g = create_model(name, device="cuda").run(**sample)
    assert sweep_variance.launches == before + launches
    pred_c, aux_c = create_model(name, device="cpu").run(**sample)
    g, c = pred_g["depth"], pred_c["depth"]
    assert np.isfinite(c).all() and c.std() > 1e-3 * np.abs(c).mean()

    def within(ours, ref, mean, mx):
        scale = np.abs(ref).mean()
        return np.abs(ours - ref).mean() / scale <= mean and np.abs(ours - ref).max() / scale <= mx

    ug, uc = pred_g["depth_uncertainty"], pred_c["depth_uncertainty"]
    if name == "cvp_mvsnet":
        assert within(aux_g["depths_all"][-1], aux_c["depths_all"][-1], 1e-4, 1e-3)
        assert within(g, c, 1e-2, 5e-2) and within(ug, uc, 1e-2, 5e-2)
    else:
        assert within(g, c, 1e-4, 1e-3)
        assert (np.abs(ug - uc) <= 1e-4 * np.abs(uc).mean()).mean() >= 0.99


def _group_inputs(seed, B=2, H=12, W=20, C=32, D=8, shift=(0.3, 0.1), singular=True):
    """K2 group mode's arguments from a key and a shifted, rotated source
    cam; per-pixel w around 1 / (1..4). With ``singular``, one pixel with w =
    inf (non-finite coordinates) and one plane through p_z = 0 of the first
    batch element (coordinates beyond 2^30)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    ref = rng.randn(B, H, W, C).astype(np.float32)
    src = rng.randn(B, H, W, C).astype(np.float32)
    key = np.zeros((B, 2, 4, 4), np.float32)
    key[:, 0] = np.eye(4)
    key[:, 1, :3, :3] = [[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]
    cam = key.copy()
    cam[:, 0, :3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
    cam[:, 0, :3, 3] = [*shift, 0.0]
    A, Bm = get_homography_coeffs(torch.from_numpy(key), torch.from_numpy(cam))
    centres = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]])
    A, Bm = matmul_sums(A, centres), matmul_sums(Bm, centres)
    depth = 1.0 + 3.0 * rng.rand(B, D, H, W)
    w = (1.0 / (depth + 1e-9)).astype(np.float32)
    if singular:
        A[0, 2], Bm[0, 2] = torch.tensor([0.0, 0.0, 1.0]), torch.tensor([0.0, 0.0, -1.0])  # p_z = 1 - w
        w[0, 1] = 1.0
        w[-1, 2, 0, 0] = np.inf
    return [torch.from_numpy(a) for a in (ref, src)] + [A.contiguous(), Bm.contiguous(), torch.from_numpy(w)]


@pytest.mark.parametrize("C", [32, 64, 24, 16])  # 32, 64: four channels per load; 24, 16: one (C/G % 4 != 0)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_group_matches_plain_version(cuda, C, out_dtype):
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(8, C=C))
    before = homography_group_cost.launches
    out = homography_group_cost(ref, src, A, Bm, w, groups=8, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert homography_group_cost.launches == before + 1
    plain = homography_group_cost_reference(ref, src, A, Bm, w, groups=8, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), plain.float(), atol=1e-5, rtol=0)
    assert torch.isfinite(out.float()).all() and (out.float() != 0).float().mean() > 0.3
    # the plain version on the card is the one the CPU tests hold to JAX
    cpu = homography_group_cost_reference(*(a.cpu() for a in (ref, src, A, Bm, w)), groups=8, out_dtype=out_dtype)
    torch.testing.assert_close(plain.cpu().float(), cpu.float(), atol=1e-5, rtol=1e-5)


def test_k2_group_unaligned_rows_take_one_channel_per_load(cuda):
    """A source map 4 bytes into its storage cannot be read in 16-byte
    vectors; the kernel loads one channel at a time and agrees all the same."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(9, C=32))
    src_off = torch.empty(src.numel() + 1, device=cuda)[1:].view(src.shape).copy_(src)
    out = homography_group_cost(ref, src_off, A, Bm, w)
    torch.testing.assert_close(out, homography_group_cost_reference(ref, src, A, Bm, w), atol=1e-5, rtol=0)


def test_k2_group_at_vis_stage3_matches_plain_version_bit_for_bit(cuda):
    """vis_mvsnet's stage-3 pair volume, (1, 16, 192, 640) with C 32, G 8:
    equal to the plain version."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(19, B=1, H=192, W=640, C=32, D=16, singular=False))
    out = homography_group_cost(ref, src, A, Bm, w)
    torch.cuda.synchronize()
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w))
    assert (out != 0).any(-1).float().mean() > 0.5


@pytest.mark.parametrize("G", [4, 8, 16])
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("W", [20, 100, 130])  # one tile; two or three tiles not a multiple of the tile
def test_k2_group_groups_and_row_tiles_match_plain_version(cuda, G, C, W):
    """Every G that divides C (four channels per load where C/G % 4 == 0,
    else one) and row tiles of at most 64 pixels (32 at C = 64), over 20
    planes in chunks of 8: bit for bit."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(G + C + W, H=8, W=W, C=C, D=20, shift=(0.3, 0.0),
                                                             singular=False))
    before = homography_group_cost.launches
    out = homography_group_cost(ref, src, A, Bm, w, groups=G)
    torch.cuda.synchronize()
    assert homography_group_cost.launches == before + 1
    assert out.shape == (2, 20, 8, W, G)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, groups=G))
    assert (out != 0).any(-1).float().mean() > 0.3


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_group_non_finite_and_off_map_w_give_zeros(cuda, out_dtype):
    """w of NaN, +-inf, 1e30 and -1e30 send every tap off the map: zeros, as
    in the plain version; one plane (D = 1) and planes beyond a chunk."""
    for D in (1, 11):
        ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(20 + D, H=6, W=70, D=D, singular=False))
        bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30], device=cuda)
        w[:, :, 2, :5] = bad
        w[0, -1, 4] = float("nan")
        out = homography_group_cost(ref, src, A, Bm, w, out_dtype=out_dtype)
        plain = homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=out_dtype)
        assert torch.equal(out, plain)
        assert (out[:, :, 2, :5] == 0).all() and (out[0, -1, 4] == 0).all()
        assert (out != 0).any()


@pytest.mark.parametrize("which", ["src", "ref", "both"])
def test_k2_group_unaligned_maps_match_plain_version_bit_for_bit(cuda, which):
    """A key or source map one element into its storage: one channel per
    load, bit for bit."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(21, H=6, W=90, C=32))

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    ref_in = shifted(ref) if which in ("ref", "both") else ref
    src_in = shifted(src) if which in ("src", "both") else src
    out = homography_group_cost(ref_in, src_in, A, Bm, w)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w))


def test_k2_group_wide_key_read_in_place(cuda):
    """C = 16384: the key tile does not fit in shared memory even at one
    pixel and is read from global memory; bit for bit."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(22, B=1, H=3, W=5, C=16384, D=3, shift=(0.1, 0.0),
                                                             singular=False))
    out = homography_group_cost(ref, src, A, Bm, w, groups=4096)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, groups=4096))


@pytest.mark.parametrize("C", [32, 64, 24, 16])  # 32, 64: four channels (8 bytes) per load; 24, 16: one
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_group_bf16_features_match_plain_version(cuda, C, out_dtype):
    """K2 group on bf16 features (bf16 x-tents, float32 rows and sums) vs
    its plain version on the card and on the CPU; counted as a bf16 launch."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(30 + C, C=C))
    ref, src = ref.bfloat16(), src.bfloat16()
    before = dict(homography_group_cost.launches_by_dtype)
    out = homography_group_cost(ref, src, A, Bm, w, groups=8, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert homography_group_cost.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + 1}
    assert out.dtype == out_dtype
    plain = homography_group_cost_reference(ref, src, A, Bm, w, groups=8, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), plain.float(), atol=1e-5, rtol=0)
    assert torch.isfinite(out.float()).all() and (out.float() != 0).float().mean() > 0.3
    cpu = homography_group_cost_reference(*(a.cpu() for a in (ref, src, A, Bm, w)), groups=8, out_dtype=out_dtype)
    torch.testing.assert_close(plain.cpu().float(), cpu.float(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", ["src", "ref"])
def test_k2_group_bf16_unaligned_maps_match_plain_version(cuda, which):
    """A bf16 key or source map one element (2 bytes) into its storage: one
    channel per load, bit for bit."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(23, H=6, W=90, C=32))
    ref, src = ref.bfloat16(), src.bfloat16()

    def shifted(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    out = homography_group_cost(shifted(ref) if which == "ref" else ref, shifted(src) if which == "src" else src,
                                A, Bm, w)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w))


def test_k2_group_bf16_at_vis_stage3_matches_plain_version(cuda):
    """vis_mvsnet's stage-3 pair volume at bf16, (1, 16, 192, 640), C 32,
    G 8, bf16 out as the bf16 model asks: bit for bit (the kernel keeps the
    plain version's order of operations and rounds once)."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(19, B=1, H=192, W=640, C=32, D=16, singular=False))
    ref, src = ref.bfloat16(), src.bfloat16()
    assert homography_group_cost_route(ref, src, out_dtype=torch.bfloat16) == "lanes"
    out = homography_group_cost(ref, src, A, Bm, w, out_dtype=torch.bfloat16)
    plain = homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=torch.bfloat16)
    assert torch.equal(out, plain)
    assert (out != 0).any(-1).float().mean() > 0.5


def _per_plane_w(w, seed):
    """w as vis_mvsnet's stage 1 passes it: one value per plane, 1 / (depth
    + 1e-9) over an even sweep of depths 1..4, expanded to every pixel."""
    B, D, H, W = w.shape
    start = 1.0 + np.random.RandomState(seed).rand()
    depth = torch.tensor(start + 3.0 * np.arange(D) / D, dtype=torch.float32, device=w.device)
    return (1.0 / (depth + 1e-9)).reshape(1, D, 1, 1).expand(B, D, H, W).contiguous()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_kind", ["per_plane", "per_pixel"])
@pytest.mark.parametrize("stage,D,H,W", [(1, 64, 48, 160), (2, 32, 96, 320), (3, 16, 192, 640)])
def test_k2_group_bf16_lane_route_at_vis_stages_matches_plain_version_bit_for_bit(cuda, out_dtype, w_kind, stage,
                                                                                 D, H, W):
    """vis_mvsnet's three stage volumes at 384x1280 (C 32, G 8, bf16
    features), with w per plane as stage 1 passes it and per pixel as
    stages 2-3 pass it: the lane route, bit for bit."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(40 + stage, B=1, H=H, W=W, C=32, D=D, singular=False))
    ref, src = ref.bfloat16(), src.bfloat16()
    if w_kind == "per_plane":
        w = _per_plane_w(w, stage)
    assert homography_group_cost_route(ref, src, out_dtype=out_dtype) == "lanes"
    before = dict(homography_group_cost.launches_by_dtype)
    out = homography_group_cost(ref, src, A, Bm, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert homography_group_cost.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + 1}
    assert out.dtype == out_dtype and out.shape == (1, D, H, W, 8)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=out_dtype))
    assert (out != 0).any(-1).float().mean() > 0.5


def _lane_route_expected(C, G):
    """The lane route's shape rule (csrc/sweep_group_cost.cu lane_route) for
    aligned bf16 maps: C/G divides a lane's 16 channels, 1, 2, 4 or 8 lanes."""
    return "lanes" if 16 % (C // G) == 0 and C % 16 == 0 and C // 16 in (1, 2, 4, 8) else "groups"


@pytest.mark.parametrize("G,C", [(G, C) for G in (4, 8, 16) for C in (16, 32, 64, 24, 8) if C % G == 0])
@pytest.mark.parametrize("W", [20, 100, 130])  # a partial last warp of pixels at every C
def test_k2_group_bf16_groups_and_widths_match_plain_version_bit_for_bit(cuda, G, C, W):
    """bf16 features at every G of 4, 8, 16 dividing C: the lane route
    where C/G divides 16 and C is 1, 2, 4 or 8 lanes of 16 channels (C 24
    and C 8 take the group route); W 20, 100, 130 end on a partial warp of
    pixels; 13 planes end on a partial turn and chunk."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(50 + G + C + W, H=8, W=W, C=C, D=13,
                                                             shift=(0.3, 0.0), singular=False))
    ref, src = ref.bfloat16(), src.bfloat16()
    assert homography_group_cost_route(ref, src, G, torch.bfloat16) == _lane_route_expected(C, G)
    for out_dtype in (torch.bfloat16, torch.float32):
        out = homography_group_cost(ref, src, A, Bm, w, groups=G, out_dtype=out_dtype)
        assert out.shape == (2, 13, 8, W, G)
        assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, groups=G, out_dtype=out_dtype))
    assert (out != 0).any(-1).float().mean() > 0.3


@pytest.mark.parametrize("D", [1, 2, 3, 5, 17, 33])  # one plane; remainders of the 2-plane turn, 16-plane chunk
@pytest.mark.parametrize("w_kind", ["per_plane", "per_pixel"])
def test_k2_group_bf16_plane_counts_match_plain_version_bit_for_bit(cuda, D, w_kind):
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(60 + D, H=7, W=45, C=32, D=D, singular=False))
    ref, src = ref.bfloat16(), src.bfloat16()
    if w_kind == "per_plane":
        w = _per_plane_w(w, D)
    out = homography_group_cost(ref, src, A, Bm, w, out_dtype=torch.bfloat16)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=torch.bfloat16))
    assert (out != 0).any(-1).float().mean() > 0.3


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_group_bf16_non_finite_and_off_map_w_give_zeros(cuda, out_dtype):
    """The lane route on w of NaN, +-inf, 1e30 and -1e30 (and at D = 11 a
    plane through p_z = 0 and an infinite w at one pixel): zeros where every
    tap is off the map, as in the plain version, bit for bit; D = 1 and 11."""
    for D in (1, 11):
        ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(70 + D, H=6, W=70, D=D, singular=D > 1))
        ref, src = ref.bfloat16(), src.bfloat16()
        bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30], device=cuda)
        w[:, :, 2, :5] = bad
        w[0, -1, 4] = float("nan")
        assert homography_group_cost_route(ref, src, out_dtype=out_dtype) == "lanes"
        out = homography_group_cost(ref, src, A, Bm, w, out_dtype=out_dtype)
        assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=out_dtype))
        assert (out[:, :, 2, :5] == 0).all() and (out[0, -1, 4] == 0).all()
        assert (out != 0).any()


@pytest.mark.parametrize("which", ["src", "ref", "out"])
@pytest.mark.parametrize("offset", [1, 4])  # 2 and 8 bytes: off a lane's 16-byte loads
def test_k2_group_bf16_unaligned_maps_take_the_group_route(cuda, which, offset):
    """A bf16 key or source map 2 or 8 bytes into its storage cannot be read
    in 16-byte loads: the group route, bit for bit. An output off a lane's
    store is refused by the route as well."""
    ref, src, A, Bm, w = (a.to(cuda) for a in _group_inputs(80 + offset, H=6, W=90, C=32))
    ref, src = ref.bfloat16(), src.bfloat16()

    def shifted(t):
        return torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)[offset:].view(t.shape).copy_(t)

    if which == "out":
        # a lane stores four sums: 8 bytes in bf16, 16 in float32; an offset of 4 elements keeps either aligned
        for out_dtype in (torch.bfloat16, torch.float32):
            out = shifted(torch.empty((2, 8, 6, 90, 8), dtype=out_dtype, device=cuda))
            assert homography_group_cost_route(ref, src, out_dtype=out_dtype, out=out) == (
                "groups" if offset == 1 else "lanes")
        return
    ref_in = shifted(ref) if which == "ref" else ref
    src_in = shifted(src) if which == "src" else src
    assert homography_group_cost_route(ref_in, src_in) == "groups"
    out = homography_group_cost(ref_in, src_in, A, Bm, w, out_dtype=torch.bfloat16)
    assert torch.equal(out, homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=torch.bfloat16))


def test_k2_group_float32_takes_the_group_route(cuda):
    ref, src, *_ = _group_inputs(90, H=4, W=10, C=32)
    assert homography_group_cost_route(ref.to(cuda), src.to(cuda)) == "groups"


@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 64, 5, 7), (2, 192, 3, 5), (1, 32, 48, 160)])
def test_k3_matches_plain_version(cuda, shape):
    """prob atol 1e-6, expectation atol 1e-5 + rtol 1e-6, entropy atol 1e-5
    (expf / logf vs torch's, sums in another order); the window mass off by
    more than 1e-5 on at most 1% of the pixels (the mask flips at ties)."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    vol = torch.randn(shape, generator=gen, device=cuda) * 3
    before = fused_soft_argmin.launches
    out = fused_soft_argmin(vol, window=2)
    torch.cuda.synchronize()
    assert fused_soft_argmin.launches == before + 1
    plain = fused_soft_argmin_reference(vol, window=2)
    for a, b, atol, rtol in zip(out[:3], plain[:3], (1e-6, 1e-5, 1e-5), (0, 1e-6, 0)):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
    assert ((out[3] - plain[3]).abs() > 1e-5).float().mean() <= 0.01


def _k3_limits_hold(out, plain):
    """chip_smoke.py's K3_LIMITS: prob atol 1e-6, expectation 1e-5 + 1e-6 D
    (it reaches D - 1; sums over D in another order), entropy 1e-5; the
    window mass off by more than 1e-5 on at most 1% of the pixels."""
    D = out[0].shape[1]
    for a, b, atol in zip(out[:3], plain[:3], (1e-6, 1e-5 + 1e-6 * D, 1e-5)):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)
    assert ((out[3] - plain[3]).abs() > 1e-5).float().mean() <= 0.01


@pytest.mark.parametrize("D,route", [(16, "registers"), (32, "registers"), (64, "registers"), (192, "generic"),
                                     (8, "generic"), (48, "generic")])
@pytest.mark.parametrize("B,H,W", [(2, 7, 13), (1, 12, 20), (2, 48, 160)])  # HW odd, even, a vis stage-1 map
def test_k3_routes_match_plain_version(cuda, D, route, B, H, W):
    """The register route (compile-time D) and the generic four-pass route,
    as the C entry's route export names them, each within chip_smoke.py's
    K3_LIMITS."""
    assert soft_argmin_route(D) == route
    gen = torch.Generator(device=cuda).manual_seed(D + H * W)
    vol = torch.randn((B, D, H, W), generator=gen, device=cuda) * 3
    before = fused_soft_argmin.launches
    out = fused_soft_argmin(vol, window=2)
    torch.cuda.synchronize()
    assert fused_soft_argmin.launches == before + 1
    assert [tuple(o.shape) for o in out] == [(B, D, H, W)] + [(B, 1, H, W)] * 3
    _k3_limits_hold(out, fused_soft_argmin_reference(vol, window=2))


@pytest.mark.parametrize("D", [16, 32, 64, 192])
@pytest.mark.parametrize("HW_odd", [False, True])
def test_k3_non_finite_columns_match_plain_version(cuda, D, HW_odd):
    """A column with +inf, one with NaN and one with -inf beside finite
    scores: every output is NaN exactly where the plain version's is (the
    window mass multiplies by the mask, so a NaN column gives NaN there
    too); the finite rest within the limits."""
    H, W = (5, 7) if HW_odd else (4, 6)
    gen = torch.Generator(device=cuda).manual_seed(D)
    vol = torch.randn((2, D, H, W), generator=gen, device=cuda) * 3
    zero = torch.zeros((), device=cuda)
    vol[0, 3, 1, 2] = (zero + 1) / zero
    vol[1, D - 1, 2, 3] = zero / zero
    vol[1, 0, 0, 0] = -(zero + 1) / zero
    out = fused_soft_argmin(vol, window=2)
    plain = fused_soft_argmin_reference(vol, window=2)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.isnan(a).any()
    finite = [torch.where(torch.isnan(a), torch.zeros_like(a), a) for a in out]
    _k3_limits_hold(finite, [torch.where(torch.isnan(b), torch.zeros_like(b), b) for b in plain])


@pytest.mark.parametrize("conv3d_impl,k5_launches", [("banded", 30), ("xla", 0)])
def test_vis_mvsnet_on_card_matches_cpu(cuda, conv3d_impl, k5_launches):
    """Card vs CPU, TF32 off, 128x192 with 1+2 views, with each lowering of
    the 3D convolutions: 6 K2-group, 6 K3 and (the default
    ``conv3d_impl="banded"``) 30 K5 launches or (``"xla"``, cuDNN) none;
    depth relative to its mean magnitude mean <= 1e-4, max <= 1e-3; the
    uncertainty (a windowed probability mass) mean |diff| <= 1e-4 and
    |diff| > 1e-3 on at most 1% of the pixels."""
    sample = _family_sample(6, 128, 192)
    kernels = (homography_group_cost, fused_soft_argmin, conv3d_banded)
    before = [k.launches for k in kernels]
    pred_g, _ = create_model("vis_mvsnet", device="cuda", conv3d_impl=conv3d_impl).run(**sample)
    assert [k.launches - b for k, b in zip(kernels, before)] == [6, 6, k5_launches]
    pred_c, _ = create_model("vis_mvsnet", device="cpu", conv3d_impl=conv3d_impl).run(**sample)
    g, c = pred_g["depth"], pred_c["depth"]
    assert g.shape == (1, 1, 64, 96)
    assert np.isfinite(c).all() and c.std() > 1e-3 * np.abs(c).mean()
    scale = np.abs(c).mean()
    assert np.abs(g - c).mean() / scale <= 1e-4 and np.abs(g - c).max() / scale <= 1e-3
    diff = np.abs(pred_g["depth_uncertainty"] - pred_c["depth_uncertainty"])
    assert diff.mean() <= 1e-4 and (diff > 1e-3).mean() <= 0.01


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 6, 10, 8),  # (B, Cin, D, H, W, Cout): D, H, W not multiples of the tile
    (1, 16, 9, 17, 40, 16),
    (1, 6, 5, 8, 33, 4),  # Cin not a multiple of the 4-channel stage (CUDA cores)
    (1, 8, 12, 10, 20, 1),  # a score head (CUDA cores)
    (1, 64, 4, 6, 10, 64),  # two 32-channel output tiles
    (2, 24, 4, 9, 70, 8),
    # the channel pairs of chip_smoke.py's K5_CASES at reduced volumes; W % 4
    # == 0 takes 16-byte halo copies in NCDHW, other W element copies
    (1, 16, 6, 9, 21, 16),
    (1, 32, 5, 6, 20, 32),
    (1, 64, 6, 5, 11, 64),
    (1, 8, 7, 6, 19, 1),
    (2, 8, 5, 12, 28, 8),
    (2, 16, 5, 12, 28, 8),
    (1, 64, 5, 7, 13, 40),  # ragged M-tile (W = 13) and N-tile (40 = 32 + 8) edges
    (1, 12, 6, 7, 18, 16),  # Cin not a multiple of the 8-channel mma chunk (tensor cores)
    (1, 32, 64, 24, 80, 32),  # mvsnet's conv4 at full size: Cout > 16 on the wide tile (small volumes: narrow)
])
@pytest.mark.parametrize("layout", ["ncdhw", "ndhwc", "ncdhw_strided"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_k5_matches_plain_version(cuda, shape, layout, with_bias):
    """Unit-scale inputs, kernels scaled by 1 / sqrt(27 Cin): atol 2e-5
    (float32 sums over 27 Cin taps in another order; for Cout > 4 the
    tensor cores' 3xTF32 products keep ~21 bits each). One source serves
    both layouts and strided views through its element strides."""
    B, Cin, D, H, W, Cout = shape
    gen = torch.Generator(device=cuda).manual_seed(Cin * Cout)
    x = torch.randn((B, Cin, D, H, W), generator=gen, device=cuda)
    k = torch.randn((3, 3, 3, Cin, Cout), generator=gen, device=cuda) / (27 * Cin) ** 0.5
    bias = torch.randn((Cout,), generator=gen, device=cuda) if with_bias else None
    plain = conv3d_banded_reference(x.movedim(1, -1), k, bias)  # NDHWC
    before = conv3d_banded.launches
    if layout == "ndhwc":
        out = conv3d_banded(x.movedim(1, -1).contiguous(), k, bias)
    else:
        if layout == "ncdhw_strided":  # a channel slice of a wider volume
            x = torch.cat([x, torch.zeros_like(x[:, :3])], 1)[:, :Cin]
        out = conv3d_banded(x, k, bias, channels_first=True).movedim(1, -1)
    torch.cuda.synchronize()
    assert conv3d_banded.launches == before + 1
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=0)
    # and the plain version on the card is the one the CPU tests hold to JAX
    cpu = conv3d_banded_reference(x.movedim(1, -1).cpu(), k.cpu(), None if bias is None else bias.cpu())
    torch.testing.assert_close(plain.cpu(), cpu, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", [(1, 8, 6, 9, 20, 8), (1, 16, 5, 7, 13, 16), (1, 64, 4, 6, 24, 64)])
def test_k5_takes_an_nn_conv3d_weight(cuda, shape):
    """An nn.Conv3d weight, (Cout, Cin, 3, 3, 3) seen as DHWIO, has its taps
    innermost: the kernel copies it in that order, with the same result."""
    B, Cin, D, H, W, Cout = shape
    gen = torch.Generator(device=cuda).manual_seed(Cin + Cout)
    x = torch.randn((B, Cin, D, H, W), generator=gen, device=cuda)
    weight = torch.randn((Cout, Cin, 3, 3, 3), generator=gen, device=cuda) / (27 * Cin) ** 0.5
    k = weight.permute(2, 3, 4, 1, 0)
    out = conv3d_banded(x, k, None, channels_first=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, conv3d_banded(x, k.contiguous(), None, channels_first=True), atol=0, rtol=0)
    torch.testing.assert_close(out.movedim(1, -1), conv3d_banded_reference(x.movedim(1, -1), k), atol=2e-5, rtol=0)


def test_k5_route_by_cout(cuda):
    """The score heads (Cout <= 4) on the CUDA cores, every wider Cout on
    the tensor cores, as the C entry dispatches."""
    assert [conv3d_banded_path(c) for c in (1, 4, 5, 8, 64)] == ["cuda_cores"] * 2 + ["tf32x3_mma"] * 3


@pytest.mark.parametrize("cout", [1, 16])  # the CUDA cores, the tensor cores
@pytest.mark.parametrize("where", ["input", "weight"])
def test_k5_keeps_non_finite_values(cuda, cout, where):
    """A NaN made by the card (0/0, whose mantissa is all ones) and an inf,
    in the input or in the weights, make the output non-finite exactly where
    they make the plain version's (a non-finite weight reaches its whole
    output channel: 0 * inf is NaN at the zero pad too); the finite rest is
    within 2e-5."""
    Cin, D, H, W = 12, 6, 7, 18
    gen = torch.Generator(device=cuda).manual_seed(cout)
    x = torch.randn((1, Cin, D, H, W), generator=gen, device=cuda)
    weight = torch.randn((cout, Cin, 3, 3, 3), generator=gen, device=cuda) / (27 * Cin) ** 0.5
    zero = torch.zeros((), device=cuda)
    nan, inf = zero / zero, (zero + 1) / zero
    if where == "input":
        x[0, 3, 2, 3, 5], x[0, 7, 4, 6, 12] = nan, -inf
    else:
        weight[0, 2, 1, 1, 1], weight[-1, 9, 0, 2, 0] = nan, inf
    k = weight.permute(2, 3, 4, 1, 0)
    out = conv3d_banded(x, k, None, channels_first=True).movedim(1, -1)
    plain = conv3d_banded_reference(x.movedim(1, -1), k)
    torch.cuda.synchronize()
    finite = torch.isfinite(plain)
    assert not finite.all() and (finite.any() or (cout, where) == (1, "weight"))
    assert torch.equal(torch.isfinite(out), finite)
    torch.testing.assert_close(out[finite], plain[finite], atol=2e-5, rtol=0)


def test_k5_backward_matches_plain_version(cuda):
    """K5's backward (cuDNN's conv3d_input / conv3d_weight) against autograd
    through the plain version: rtol 1e-4, atol 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 8, 6, 7, 12), generator=gen, device=cuda)
    k = torch.randn((3, 3, 3, 8, 4), generator=gen, device=cuda) / 15
    bias = torch.randn((4,), generator=gen, device=cuda)
    grads = []
    for fn in (lambda a, b, c: conv3d_banded(a, b, c, channels_first=True),
               lambda a, b, c: conv3d_banded_reference(a.movedim(1, -1), b, c).movedim(-1, 1)):
        leaves = [a.clone().requires_grad_() for a in (x, k, bias)]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([a.grad for a in leaves])
    for ours, ref in zip(*grads):
        torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4)


def test_k5_rejects_non_float32(cuda):
    x = torch.zeros((1, 4, 4, 4, 4), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv3d_banded(x, torch.zeros((3, 3, 3, 4, 2), device=cuda, dtype=torch.bfloat16))


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 6, 10, 8),  # (B, Cin, D, H, W, Cout): Cin 8, one chunk of two taps per k16
    (1, 16, 9, 17, 40, 16),
    (1, 64, 4, 6, 10, 64),
    (2, 24, 4, 9, 70, 8),  # Cin not a multiple of 16
    (1, 64, 5, 7, 13, 40),  # ragged M-tile and N-tile edges
    (2, 16, 5, 12, 28, 8),  # vis's dec_2_post pair at reduced volume
    (1, 32, 64, 24, 80, 32),  # mvsnet's conv4 at full size: the weights stay, two K groups
    (2, 8, 5, 6, 14, 8),  # Cin 8 with W % 4 != 0 (NCDHW staged with 2-byte loads), D not a multiple of 8 planes
    (1, 12, 6, 7, 24, 16),  # Cin not a multiple of 8: the wrapper pads the weights, the copy zero-fills
    (1, 24, 9, 5, 16, 24),  # three chunks for two K groups (the second idle on the last), 9 planes
    (1, 16, 5, 6, 16, 12),  # Cout not a multiple of 8: a partial n8 fragment, NDHWC out with 2-byte stores
    (1, 8, 3, 2, 8, 8),  # a volume smaller than one tile
    (1, 64, 32, 12, 40, 64),  # mvsnet's conv6 at full size: a tile per block, the weights stream
    (2, 8, 16, 192, 640, 8),  # vis's stage-3 pair regulariser at full size
])
@pytest.mark.parametrize("layout", ["ncdhw", "ndhwc", "ncdhw_strided"])
@pytest.mark.parametrize("kernel_dtype", [torch.float32, torch.bfloat16])
def test_k5_bf16_matches_plain_version(cuda, shape, layout, kernel_dtype):
    """K5's bf16 form (bf16 mma, float32 sums and bias, one rounding)
    against its plain version on the same bf16 inputs: max |d| <= 2^-7 max
    |ref|, one bf16 step at the largest magnitude (the float32 sums differ in
    order, so a value may round to the neighbouring step), on at most 2% of
    the values; a float32 kernel is cast once to bf16, as a bf16 one is. The
    layouts take the kernel's two halo copies: TMA for an NCDHW volume
    whose strides allow it (unit W stride, the others multiples of 8, as
    the channel-strided view's can be), else 2-byte loads with a channel
    pair per 32-bit shared store (NDHWC, and NCDHW with W % 8 != 0)."""
    B, Cin, D, H, W, Cout = shape
    gen = torch.Generator(device=cuda).manual_seed(Cin * Cout + 1)
    x = torch.randn((B, Cin, D, H, W), generator=gen, device=cuda).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, Cin, Cout), generator=gen, device=cuda) / (27 * Cin) ** 0.5).to(kernel_dtype)
    bias = torch.randn((Cout,), generator=gen, device=cuda)
    plain = conv3d_banded_reference(x.movedim(1, -1), k, bias)
    before = dict(conv3d_banded.launches_by_dtype)
    if layout == "ndhwc":
        out = conv3d_banded(x.movedim(1, -1).contiguous(), k, bias)
    else:
        if layout == "ncdhw_strided":
            x = torch.cat([x, torch.zeros_like(x[:, :3])], 1)[:, :Cin]
        out = conv3d_banded(x, k, bias, channels_first=True).movedim(1, -1)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert conv3d_banded.launches_by_dtype["bfloat16"] == before["bfloat16"] + 1
    assert conv3d_banded.launches_by_dtype["float32"] == before["float32"]
    diff = (out.float() - plain.float()).abs()
    assert diff.max() <= 2.0**-7 * plain.float().abs().max()
    assert (diff > 0).float().mean() <= 0.02
    # and the plain version on the card is, within the same step, the one the CPU tests hold to JAX
    cpu = conv3d_banded_reference(x.movedim(1, -1).cpu(), k.cpu(), bias.cpu()).float()
    assert (plain.cpu().float() - cpu).abs().max() <= 2.0**-7 * cpu.abs().max()


def test_k5_bf16_route_and_score_heads(cuda):
    """bf16 runs on the tensor cores only: the score heads stay float32."""
    assert [conv3d_banded_path(c, torch.bfloat16) for c in (5, 8, 64)] == ["bf16_mma"] * 3
    x = torch.zeros((1, 8, 4, 4, 4), device=cuda, dtype=torch.bfloat16)
    for cout in (1, 4):
        with pytest.raises(TypeError, match="score head"):
            conv3d_banded(x, torch.zeros((3, 3, 3, 8, cout), device=cuda), channels_first=True)


def test_k5_bf16_backward_matches_plain_version(cuda):
    """The bf16 form's backward (cuDNN's conv3d_input / conv3d_weight in
    bf16) against autograd through the plain version: each gradient in its
    input's dtype, within 2^-6 of its largest magnitude (bf16 sums)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((2, 16, 6, 7, 12), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((3, 3, 3, 16, 8), generator=gen, device=cuda) / 20
    bias = torch.randn((8,), generator=gen, device=cuda)
    grads = []
    for fn in (lambda a, b, c: conv3d_banded(a, b, c, channels_first=True),
               lambda a, b, c: conv3d_banded_reference(a.movedim(1, -1), b, c).movedim(-1, 1)):
        leaves = [a.clone().requires_grad_() for a in (x, k, bias)]
        (fn(*leaves).float() ** 2).sum().backward()
        grads.append([a.grad for a in leaves])
    for ours, ref, leaf in zip(*grads, (x, k, bias)):
        assert ours.dtype == leaf.dtype
        assert (ours.float() - ref.float()).abs().max() <= 2.0**-6 * ref.float().abs().max()


@pytest.mark.parametrize("name,kwargs,launches", [
    ("mvsnet_train", {}, {"sweep_warp": 1}),
    ("mvsnet_train", {"conv3d_impl": "banded", "warp_impl": "xla"}, {"warp_volume": 2, "conv3d_banded[bfloat16]": 3,
                                                                      "conv3d_banded[float32]": 1}),
    ("cvp_mvsnet", {}, {"sweep_warp": 5}),
    ("cvp_mvsnet", {"warp_impl": "xla"}, {"sweep_warp": 0}),
    ("vis_mvsnet", {}, {"sweep_group_cost[bfloat16]": 6, "sweep_group_cost[float32]": 0, "soft_argmin": 6,
                        "conv3d_banded[bfloat16]": 24, "conv3d_banded[float32]": 6}),
    ("vis_mvsnet", {"warp_impl": "xla"}, {"sweep_group_cost": 0, "soft_argmin": 6, "conv3d_banded[bfloat16]": 24}),
])
def test_family_bf16_on_card_matches_cpu(cuda, name, kwargs, launches):
    """The family at ``dtype="bfloat16"``, card vs CPU, TF32 off, cuDNN
    deterministic, 128x192 with 1+2 views; every kernel of the path
    launched, K2 group and K5 by dtype. The score heads are conditioned
    (:data:`FAMILY_HEAD_GAINS`) so that the random model's own bf16-vs-fp32
    distance on the CPU stays under 0.3 points with depth that varies. The
    card's bf16 depth is scored against the CPU's bf16 depth as ground
    truth, as the benchmark scores depth, within FAMILY_BF16_BOUNDS: half a
    point of absrel and 99% 1.03-inliers, tighter than the bounds JAX holds
    its bf16 to against fp32 (1 point, 97%). The CPU tests
    (``test_torch_port_family_bf16.py``) hold the conditioned models' bf16
    noise under 0.3 points and show that planted faults (K5 bf16 dropping a
    corner tap, K2 group dropping a channel) fail these bounds."""
    from robustmvd_tpu_torch.eval.metrics import m_rel_ae, thresh_inliers
    from robustmvd_tpu_torch.ops.kernels import KERNELS

    def counts():
        out = {k: fn.launches for k, fn in KERNELS.items()}
        for k, fn in KERNELS.items():
            out.update({f"{k}[{d}]": n for d, n in getattr(fn, "launches_by_dtype", {}).items()})
        return out

    def scores(pred, gt):
        ones = np.ones_like(gt)
        return (m_rel_ae(gt=gt, pred=pred, mask=ones, output_scaling_factor=100.0),
                thresh_inliers(gt=gt, pred=pred, thresh=1.03, mask=ones, output_scaling_factor=100.0))

    def model(device, dtype="bfloat16"):
        return conditioned_heads(create_model(name, device=device, dtype=dtype, **kwargs), name)

    sample = _family_sample(6, 128, 192)
    torch.backends.cudnn.deterministic = True
    try:
        before = counts()
        pred_g, _ = model("cuda").run(**sample)
        after = counts()
    finally:
        torch.backends.cudnn.deterministic = False
    assert {k: after[k] - before[k] for k in launches} == launches
    pred_c, _ = model("cpu").run(**sample)
    g, c = pred_g["depth"], pred_c["depth"]
    assert g.dtype == np.float32 and np.isfinite(g).all()
    assert np.isfinite(c).all() and c.std() > 5e-2 * np.abs(c).mean()
    absrel, inliers = scores(g, c)
    assert absrel < FAMILY_BF16_BOUNDS["absrel"] and inliers > FAMILY_BF16_BOUNDS["inliers"], (
        absrel, inliers, scores(c, model("cpu", "float32").run(**sample)[0]["depth"]))


# score-head gains of the random family models in the bf16 card tests: the
# softmax over hypotheses peaked enough for depth to vary (std over mean
# 0.07-0.14 here), not so much that bf16 rounding moves its argmax
FAMILY_HEAD_GAINS = {"mvsnet_train": 4.0, "cvp_mvsnet": 1.0, "vis_mvsnet": 0.25}
# card vs CPU bf16 depth: absrel in points below, 1.03-inliers in % above
FAMILY_BF16_BOUNDS = {"absrel": 0.5, "inliers": 99.0}


def conditioned_heads(model, name):
    """``model`` with its score heads' weights (``prob``, ``prob0``,
    ``final_conv``) scaled by the model's FAMILY_HEAD_GAINS."""
    with torch.no_grad():
        for path, module in model.named_modules():
            if path.rsplit(".", 1)[-1] in ("prob", "prob0", "final_conv"):
                module.weight.mul_(FAMILY_HEAD_GAINS[name])
    return model


def _warp_inputs(seed, B=2, H=12, W=20, C=32, D=8, focal=None):
    """K4's arguments: a source camera shifted and turned from the key
    (focal length 0.8 W unless given), planes from 0.5 to 10 and one at
    depth 0 with no translation in the second batch element (0/0
    coordinates)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    src = rng.randn(B, H, W, C).astype(np.float32)
    f = 0.8 * W if focal is None else focal
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    key, proj = np.tile(np.eye(4, dtype=np.float32), (2, B, 1, 1))
    key[:, :3, :3] = K
    for b in range(B):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        pose[:3, 3] = [0.3, 0.1, 0.0] if b == 0 else 0.0
        proj[b, :3, :4] = K @ pose[:3, :4]
    depth = np.tile(np.linspace(0.5, 10.0, D, dtype=np.float32), (B, 1))
    depth[-1, 0] = 0.0
    return [torch.from_numpy(a) for a in (src, proj, np.linalg.inv(key).astype(np.float32), depth)]


@pytest.mark.parametrize("C", [32, 16, 8, 6])  # 6: one channel per lane (C % 4 != 0)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_version(cuda, C, dtype):
    """float32 features atol 1e-6, bf16 features 1e-5 (the same op order,
    no fused multiply-add); the out-of-map and 0/0 samples are zeros."""
    src, proj, inv, depth = (a.to(cuda) for a in _warp_inputs(10, C=C))
    src = src.to(dtype)
    before = homo_warp_volume.launches
    out = homo_warp_volume(src, proj, inv, depth)
    torch.cuda.synchronize()
    assert homo_warp_volume.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (2, 8, 12, 20, C)
    plain = homo_warp_volume_reference(src, proj, inv, depth)
    torch.testing.assert_close(out, plain, atol=1e-6 if dtype == torch.float32 else 1e-5, rtol=0)
    assert torch.isfinite(out).all() and (out[-1, 0] == 0).all() and (out != 0).float().mean() > 0.3
    # the plain version on the card is the one the CPU tests hold to JAX
    cpu = homo_warp_volume_reference(*(a.cpu() for a in (src, proj, inv, depth)))
    torch.testing.assert_close(plain.cpu(), cpu, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [dict(), dict(H=4, W=600, D=3, focal=16.0)])  # one row tile, two
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_unaligned_rows_take_one_channel_per_lane(cuda, shape, dtype):
    """A map one element into its storage cannot be read in whole vectors:
    the kernel takes one channel per element and agrees bit for bit."""
    src, proj, inv, depth = (a.to(cuda) for a in _warp_inputs(11, C=16, **shape))
    src = src.to(dtype)
    src_off = torch.empty(src.numel() + 1, device=cuda, dtype=dtype)[1:].view(src.shape).copy_(src)
    out = homo_warp_volume(src_off, proj, inv, depth)
    assert torch.equal(out, homo_warp_volume_reference(src, proj, inv, depth))


@pytest.mark.parametrize("W", [2, 13, 513])  # a row of two pixels, one odd tile, two tiles of 512 at most
@pytest.mark.parametrize("C", [6, 8, 16, 32, 64])  # 6: one channel per element
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_row_tiles_match_plain_version(cuda, W, C, dtype):
    """K4 walks each output row in tiles of at most 512 pixels: every W and
    C gives the plain version's volume bit for bit (the same operations on
    the same values), with float32 and bf16 features."""
    # focal 20: samples shift by up to ~12 columns and ~1 row of the 5-row map
    src, proj, inv, depth = (a.to(cuda) for a in _warp_inputs(W + C, B=2, H=5, W=W, C=C, D=3, focal=20.0))
    src = src.to(dtype)
    before = homo_warp_volume.launches
    out = homo_warp_volume(src, proj, inv, depth)
    torch.cuda.synchronize()
    assert homo_warp_volume.launches == before + 1
    plain = homo_warp_volume_reference(src, proj, inv, depth)
    assert out.shape == (2, 3, 5, W, C) and torch.equal(out, plain)
    assert (out[-1, 0] == 0).all() and (out != 0).any()


def test_k4_at_mvsnet_shape_matches_plain_version_bit_for_bit(cuda):
    """mvsnet_train's warp_impl="xla" volume, (1, 256, 96, 320, 32) float32
    from a (1, 96, 320, 32) map: equal to the plain version; with bf16
    features within 1e-5 (the same op order; equal in practice)."""
    src, proj, inv, depth = (a.to(cuda) for a in _warp_inputs(14, B=1, H=96, W=320, C=32, D=256))
    out = homo_warp_volume(src, proj, inv, depth)
    torch.cuda.synchronize()
    assert torch.equal(out, homo_warp_volume_reference(src, proj, inv, depth))
    assert (out != 0).float().mean() > 0.3
    del out
    src16 = src.bfloat16()
    torch.testing.assert_close(homo_warp_volume(src16, proj, inv, depth),
                               homo_warp_volume_reference(src16, proj, inv, depth), atol=1e-5, rtol=0)


def test_k4_refuses_gradient_and_homo_warp_grad_matches_cpu(cuda):
    """What stands in for K4's backward in training: MVSNet trains through
    the plain version's op, ``ops/homography.py::homo_warp``, whose gradient
    on the card matches the CPU's for the features and the projections (no
    0/0 plane: its coordinates' gradient is NaN on both). K4's own refusal
    of a gradient is ``test_forward_only_kernels_refuse_a_gradient``'s."""
    src, proj, inv, depth = (a.to(cuda) for a in _warp_inputs(12, C=8))
    depth[:, 0] = 0.25
    weight = torch.randn((2, 8, 12, 20, 8), device=cuda)
    grads = []
    for device in ("cuda", "cpu"):
        leaves = [a.to(device).clone().requires_grad_() for a in (src, proj)]
        (homo_warp_volume_reference(leaves[0], leaves[1], inv.to(device), depth.to(device))
         * weight.to(device)).sum().backward()
        grads.append([a.grad.cpu() for a in leaves])
    for ours, ref in zip(*grads):
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kwargs,launches", [
    ("mvsnet_train", {"conv3d_impl": "banded", "warp_impl": "xla"}, {"warp_volume": 2, "conv3d_banded": 4}),
    ("cvp_mvsnet", {"conv3d_impl": "banded"}, {"sweep_warp": 5, "conv3d_banded": 40}),
])
def test_family_kernel_paths_on_card_match_cpu(cuda, name, kwargs, launches):
    """K4's and K5's paths, card vs CPU, TF32 off, with the bounds of
    ``test_family_on_card_matches_cpu``."""
    from robustmvd_tpu_torch.ops.kernels import KERNELS

    sample = _family_sample(6, 128, 192)
    before = {k: KERNELS[k].launches for k in launches}
    pred_g, aux_g = create_model(name, device="cuda", **kwargs).run(**sample)
    assert {k: KERNELS[k].launches - before[k] for k in launches} == launches
    pred_c, aux_c = create_model(name, device="cpu", **kwargs).run(**sample)
    g, c = pred_g["depth"], pred_c["depth"]
    assert np.isfinite(c).all() and c.std() > 1e-3 * np.abs(c).mean()

    def within(ours, ref, mean, mx):
        scale = np.abs(ref).mean()
        return np.abs(ours - ref).mean() / scale <= mean and np.abs(ours - ref).max() / scale <= mx

    ug, uc = pred_g["depth_uncertainty"], pred_c["depth_uncertainty"]
    if name == "cvp_mvsnet":
        assert within(aux_g["depths_all"][-1], aux_c["depths_all"][-1], 1e-4, 1e-3)
        assert within(g, c, 1e-2, 5e-2) and within(ug, uc, 1e-2, 5e-2)
    else:
        assert within(g, c, 1e-4, 1e-3)
        assert (np.abs(ug - uc) <= 1e-4 * np.abs(uc).mean()).mean() >= 0.99


def _evaluate(device, out_dir=None, num_samples=2, burn_in_samples=1, size=(64, 128), model=None):
    """The evaluation engine with robust_mvd (seeded weights) on ``device``
    over synthetic samples (3 views, 64x128), nearest ordering."""
    from robustmvd_tpu_torch import create_dataset, create_evaluation

    evaluation = create_evaluation("mvd", out_dir=out_dir, inputs=["poses", "intrinsics"], view_ordering="nearest",
                                   verbose=False)
    dataset = create_dataset("synthetic.train.mvd", num_samples=num_samples, num_views=3, height=size[0],
                             width=size[1])
    return evaluation(dataset=dataset, model=model or create_model("robust_mvd", device=device), qualitatives=0,
                      burn_in_samples=burn_in_samples)


def test_evaluation_on_card_matches_cpu(cuda, tmp_path):
    """Every metric column but runtime and memory within PERF.md §2's limits
    (the 1.03-inlier ratio, a count over a threshold, within a share of 1e-3
    of the pixels); K1 launched once per source view per run (1 + 2 per
    sample)."""
    _check_evaluation_on_card(tmp_path, (64, 128))


def test_staged_evaluation_with_a_resize_on_card_matches_cpu(cuda, tmp_path):
    """The same at 60x120: the staged views are resized on the card
    (``utils/image.py::resize_bilinear_torch``) and on the CPU."""
    _check_evaluation_on_card(tmp_path, (60, 120))


def _check_evaluation_on_card(tmp_path, size):
    import pandas as pd

    torch.backends.cudnn.deterministic = True
    try:
        before = planesweep_sample.launches
        card = _evaluate("cuda", str(tmp_path / "cuda"), size=size)
        assert planesweep_sample.launches - before == 2 * 3
        cpu = _evaluate("cpu", str(tmp_path / "cpu"), size=size)
    finally:
        torch.backends.cudnn.deterministic = False
    timing = ("runtime_model_in_sec", "runtime_model_in_msec", "runtime_model_and_io_in_sec",
              "runtime_model_and_io_in_msec", "device_mem_peak_in_mib")
    assert list(card.columns) == list(cpu.columns)
    for column in card.columns:
        a, b = card[column].to_numpy(np.float64), cpu[column].to_numpy(np.float64)
        if column[1] in timing:
            continue
        if column[1] in ("num_views", "pred_depth_density"):
            np.testing.assert_array_equal(a, b)
        elif column[1] == "inliers103":
            assert np.abs(a - b).max() / 100 <= 1e-3, column
        else:
            scale = np.abs(b).mean()
            assert np.abs(a - b).mean() / scale <= 1e-4 and np.abs(a - b).max() / scale <= 1e-3, column
    for curve in ("pred", "oracle"):
        a, b = (pd.read_pickle(tmp_path / d / "per_sample" / "sparsification_curves.pickle").xs(curve, level="curve")
                .to_numpy(np.float64) for d in ("cuda", "cpu"))
        scale = np.abs(b).mean()
        assert np.abs(a - b).mean() / scale <= 1e-4 and np.abs(a - b).max() / scale <= 1e-3, curve


def test_evaluation_times_the_forward_with_its_k1_launches(cuda):
    """After the burn-in sample, each run's runtime_model_in_msec is finite,
    and the runs' sum covers at least the device time of the K1 launches in
    them (torch.profiler); device_mem_peak_in_mib is positive."""
    from torch.profiler import ProfilerActivity, profile

    _evaluate("cuda", num_samples=1, burn_in_samples=0)  # warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        results = _evaluate("cuda", num_samples=1, burn_in_samples=0)
    k1_us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                for e in prof.key_averages() if "planesweep_sample" in e.key)
    runtimes = results.loc[:, [(n, "runtime_model_in_msec") for n in (1, 2)]].to_numpy(np.float64)
    assert np.isfinite(runtimes).all() and k1_us > 0
    assert runtimes.sum() >= k1_us / 1e3
    memory = results.loc[:, (slice(None), "device_mem_peak_in_mib")].to_numpy(np.float64)
    assert (memory > 0).all()


def test_evaluation_leaves_burn_in_runs_untimed(cuda):
    results = _evaluate("cuda", num_samples=2, burn_in_samples=1)
    runtimes = results.loc[:, (slice(None), "runtime_model_in_msec")]
    assert runtimes.loc[0].isna().all() and np.isfinite(runtimes.loc[1].to_numpy(np.float64)).all()
    assert np.isnan(results.loc[0, (1, "device_mem_peak_in_mib")]) and results.loc[1, (1, "device_mem_peak_in_mib")] > 0


def _k1b_taps(seed, P, Hs, Ws, S):
    """K1b's arguments: random taps, a quarter of them coinciding (one tap
    per row repeated), some out of range and the +-1e9 sentinels."""
    corr, y0, wy, x0, wx = _taps(seed, P, Hs, Ws, S)
    y0[:, S // 2: S // 2 + S // 4] = y0[:, S // 2: S // 2 + 1]
    x0[:, S // 2: S // 2 + S // 4] = x0[:, S // 2: S // 2 + 1]
    grad = torch.from_numpy(np.random.RandomState(seed + 1).randn(P, S).astype(np.float32))
    return grad, y0, wy, x0, wx


# (P, Hs, Ws, S): the row in shared memory (float4 rows; odd rows; S beyond a
# block's 256 threads; a row of two pixels), then rows beyond the block's
# shared memory
@pytest.mark.parametrize("shape,route", [((40, 6, 8, 16), "shared"), ((37, 6, 7, 300), "shared"),
                                         ((1000, 12, 40, 256), "shared"), ((3, 1, 2, 9), "shared"),
                                         ((2, 48, 96, 256), "shared"), ((5, 128, 512, 64), "global")])
def test_k1b_matches_plain_version(cuda, shape, route):
    """Within 1e-5 of the gradient's largest magnitude: atomics add the taps of
    coinciding hypotheses in another order."""
    P, Hs, Ws, S = shape
    grad, y0, wy, x0, wx = (a.to(cuda) for a in _k1b_taps(0, P, Hs, Ws, S))
    assert planesweep_sample_backward_route(Hs, Ws) == route
    before = planesweep_sample_backward.launches
    out = planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws)
    torch.cuda.synchronize()
    assert planesweep_sample_backward.launches == before + 1
    ref = planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws)
    assert out.shape == (P, Hs, Ws) and ref.abs().max() > 0
    torch.testing.assert_close(out, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)
    cpu = planesweep_sample_backward_reference(*(a.cpu() for a in (grad, y0, wy, x0, wx)), Hs, Ws)
    torch.testing.assert_close(ref.cpu(), cpu, atol=1e-6 * float(cpu.abs().max()), rtol=0)


def test_k1b_rejects_mixed_devices_and_wrong_types(cuda):
    grad, y0, wy, x0, wx = _k1b_taps(1, 4, 3, 5, 8)
    with pytest.raises(ValueError):
        planesweep_sample_backward(grad.to(cuda), y0, wy.to(cuda), x0.to(cuda), wx.to(cuda), 3, 5)
    with pytest.raises(ValueError):
        planesweep_sample_backward(grad.to(cuda).double(), y0.to(cuda), wy.to(cuda), x0.to(cuda), wx.to(cuda), 3, 5)


def test_k1_function_on_card_matches_cpu(cuda):
    """K1 forward and K1b backward through autograd: output and the score
    images' gradient within 1e-5 of the CPU's plain versions."""
    corr, y0, wy, x0, wx = _taps(2, 300, 12, 20, 64)
    grad = torch.from_numpy(np.random.RandomState(3).randn(300, 64).astype(np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        leaf = corr.to(device).requires_grad_()
        before = (planesweep_sample.launches, planesweep_sample_backward.launches)
        out = planesweep_sample_with_grad(leaf, *(a.to(device) for a in (y0, wy, x0, wx)))
        out.backward(grad.to(device))
        launched = (planesweep_sample.launches - before[0], planesweep_sample_backward.launches - before[1])
        results[device] = (out.detach().cpu(), leaf.grad.cpu(), launched)
    assert results["cuda"][2] == (1, 1) and results["cpu"][2] == (0, 0)
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(results["cuda"][1], results["cpu"][1], atol=1e-5, rtol=0)


def test_correlation_gradient_on_card_matches_cpu(cuda):
    """d/d(feat_key, feat_src) of sum(w * corr), 2 source views: the score
    matmul's backward after K1b, within rtol 1e-4 and 1e-5 of the scale."""
    rng = np.random.RandomState(4)
    B, V, H, W, C, S = 2, 2, 12, 20, 32, 64
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (B, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    T[:, :, :3, 3] = rng.randn(B, V, 3) * 0.3
    args = [torch.from_numpy(a) for a in (rng.randn(B, H, W, C).astype(np.float32),
                                          rng.randn(B, V, H, W, C).astype(np.float32), K,
                                          np.tile(K[:, None], (1, V, 1, 1)), T)]
    w = torch.from_numpy(rng.randn(B, V, H, W, S).astype(np.float32))
    grads = {}
    for device in ("cuda", "cpu"):
        key, src = (a.to(device).requires_grad_() for a in args[:2])
        corr, _, _ = planesweep_correlation(key, src, *(a.to(device) for a in args[2:]), num_sampling_points=S,
                                            min_depth=0.4, max_depth=1000.0)
        (corr * w.to(device)).sum().backward()
        grads[device] = (key.grad.cpu(), src.grad.cpu())
    for ours, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))


def test_training_engine_on_card(cuda, tmp_path):
    """Two recipe steps through create_training on the card (key + 1 source
    view: K1 and K1b once per step), finite losses, the snapshots written;
    the final weights load onto the card."""
    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.data.transforms import Compose, NormalizeImagesToMinMax, NormalizeIntrinsics

    model = rmvd.create_model("robust_mvd", device="cuda", train=True)
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=4, num_views=2, height=64, width=64,
                                  augmentations=[Compose([NormalizeImagesToMinMax(-0.4, 0.6), NormalizeIntrinsics()])])
    optimizer = rmvd.create_optimizer("adam", model=model, lr=1e-4)
    training = rmvd.create_training(
        "mvd", out_dir=str(tmp_path), model=model, dataset=dataset, optimizer=optimizer,
        scheduler=rmvd.create_scheduler("flownet_scheduler", optimizer=optimizer),
        loss=rmvd.create_loss("robust_mvd_loss", model=model), batch_size=2, max_iterations=2,
        batch_augmentations="robust_mvd_batch_augmentations", grad_clip_max_norm=5.0, num_workers=0, verbose=False)
    losses = []
    step = training.train_step

    def kept_step(inputs, gt):
        loss, sub_losses = step(inputs, gt)
        losses.append(float(loss))
        return loss, sub_losses

    training.train_step = kept_step
    before = (planesweep_sample.launches, planesweep_sample_backward.launches)
    assert training()["iteration"] == 2
    assert (planesweep_sample.launches - before[0], planesweep_sample_backward.launches - before[1]) == (2, 2)
    assert len(losses) == 2 and np.isfinite(losses).all()
    weights = tmp_path / "weights_only_checkpoints_dir" / "snapshot-iter-000000002.pt"
    loaded = rmvd.create_model("robust_mvd", device="cuda", weights=str(weights))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# --- bf16: K1b's bf16 form, K1 v2 through the correlation, a bf16 train step ---

# K1b's bf16 form vs its plain version (float32 sums, one rounding): the sums
# differ by the atomics' order, so a value may round to the neighbouring bf16
# step, 2^-8 of its magnitude at most
K1B_BF16_LIMIT = 2.0**-8


@pytest.mark.parametrize("shape,route", [((37, 6, 7, 300), "shared"), ((2, 48, 96, 256), "shared"),
                                         ((5, 128, 512, 64), "global")])
def test_k1b_bf16_matches_plain_version(cuda, shape, route):
    """Odd rows (scalar stores), the recipe's 48x96 rows (16-byte stores of
    eight bf16), and rows beyond shared memory (float32 scratch, then one
    rounding pass)."""
    P, Hs, Ws, S = shape
    grad, y0, wy, x0, wx = (a.to(cuda) for a in _k1b_taps(5, P, Hs, Ws, S))
    assert planesweep_sample_backward_route(Hs, Ws) == route
    before = dict(planesweep_sample_backward.launches_by_dtype)
    out = planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert planesweep_sample_backward.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + 1}
    ref = planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws, dtype=torch.bfloat16)
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == (P, Hs, Ws)
    scale = float(ref.float().abs().max())
    assert scale > 0
    torch.testing.assert_close(out.float(), ref.float(), atol=K1B_BF16_LIMIT * scale, rtol=0)
    # the row weights are rounded as K1 v2 rounds them: the float32 form differs
    f32 = planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws)
    assert not torch.equal(f32.bfloat16(), out)


def test_correlation_bf16_on_card_matches_cpu(cuda):
    """bf16 features: the bf16 score product, K1 v2 (one launch per source
    view) and bf16 corrs and masks, card vs CPU within 1e-2 of max |corr|."""
    rng = np.random.RandomState(6)
    B, V, H, W, C, S = 2, 2, 12, 20, 256, 64
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (B, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    T[:, :, :3, 3] = rng.randn(B, V, 3) * 0.3
    args = [torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.randn(B, V, H, W, C).astype(np.float32)).bfloat16()]
    args += [torch.from_numpy(a) for a in (K, np.tile(K[:, None], (1, V, 1, 1)), T)]
    kw = dict(num_sampling_points=S, min_depth=0.4, max_depth=1000.0)
    before = dict(planesweep_sample.launches_by_dtype)
    corr_g, mask_g, _ = planesweep_correlation(*(a.to(cuda) for a in args), **kw)
    torch.cuda.synchronize()
    assert planesweep_sample.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + V}
    corr_c, mask_c, _ = planesweep_correlation(*args, **kw)
    assert corr_g.dtype == mask_g.dtype == corr_c.dtype == torch.bfloat16
    torch.testing.assert_close(mask_g.cpu(), mask_c, atol=0, rtol=0)
    assert float(mask_c.float().mean()) > 0.05
    scale = float(corr_c.float().abs().max())
    torch.testing.assert_close(corr_g.cpu().float(), corr_c.float(), atol=1e-2 * scale, rtol=0)


def test_bf16_train_step_on_card_matches_cpu(cuda, tmp_path):
    """One recipe step (the engine's train_step) of robust_mvd at bf16, B = 1,
    1+2 views, 64x128, same weights and batch: K1 v2 and K1b's bf16 form twice
    each on the card; the loss within 1e-2 relative and the gradients at a
    cosine > 0.99 of the CPU's (bf16 convolutions round in other places on
    cuDNN and on the CPU); the parameters and their gradients float32."""
    import robustmvd_tpu_torch as rmvd

    rng = np.random.RandomState(7)
    B, V, H, W = 1, 3, 64, 128
    images = rng.rand(B, V, 3, H, W).astype(np.float32) - 0.4
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (B, V, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[:, 1:, 0, 3] = [0.1, -0.1]
    invdepth = (1.0 / (rng.rand(B, 1, H, W) * 8.0 + 2.0)).astype(np.float32)
    inputs = {"images": images, "poses": poses, "intrinsics": K, "keyview_idx": np.zeros(B, np.int64)}
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=1, num_views=V, height=H, width=W)
    steps = {}
    for device in ("cpu", "cuda"):
        model = rmvd.create_model("robust_mvd", device=device, train=True, dtype="bfloat16")
        optimizer = rmvd.create_optimizer("adam", model=model, lr=1e-4)
        training = rmvd.create_training(
            "mvd", out_dir=str(tmp_path / device), model=model, dataset=dataset, optimizer=optimizer,
            scheduler=rmvd.create_scheduler("flownet_scheduler", optimizer=optimizer),
            loss=rmvd.create_loss("robust_mvd_loss", model=model), batch_size=1, max_iterations=1,
            grad_clip_max_norm=5.0, num_workers=0, verbose=False)
        before = (dict(planesweep_sample.launches_by_dtype), dict(planesweep_sample_backward.launches_by_dtype))
        loss, _ = training.train_step({k: torch.from_numpy(v).to(device) for k, v in inputs.items()},
                                      {"invdepth": torch.from_numpy(invdepth).to(device)})
        launched = (planesweep_sample.launches_by_dtype["bfloat16"] - before[0]["bfloat16"],
                    planesweep_sample_backward.launches_by_dtype["bfloat16"] - before[1]["bfloat16"])
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters() if p.grad is not None)
        grads = torch.cat([p.grad.flatten().double().cpu() for p in model.parameters() if p.grad is not None])
        steps[device] = (float(loss), grads, launched)
    assert steps["cuda"][2] == (2, 2) and steps["cpu"][2] == (0, 0)
    assert np.isfinite(steps["cuda"][0]) and torch.isfinite(steps["cuda"][1]).all()
    assert abs(steps["cuda"][0] - steps["cpu"][0]) <= 1e-2 * abs(steps["cpu"][0])
    g, c = steps["cuda"][1], steps["cpu"][1]
    assert float(g @ c / (g.norm() * c.norm())) > 0.99


# --- the MVSNet family's training: K3's gradient, the forward-only guards, BatchNorm, a vis step ---

K3_GRAD_SHAPES = [(2, 64, 32, 40), (2, 32, 64, 80), (2, 16, 128, 160)]  # vis's readouts at 256x320, batch 2


@pytest.mark.parametrize("shape", K3_GRAD_SHAPES)
@pytest.mark.parametrize("with_mass", [False, True])
def test_k3_gradient_matches_plain_version(cuda, shape, with_mass):
    """K3's autograd Function (the kernel forward, the closed-form backward in
    torch ops) against autograd through the plain version, random upstream
    gradients of the expectation, the entropy and (``with_mass``) the window
    mass: within 1e-4 of the gradient's largest |value| (the kernel's prob
    differs from the plain version's by up to 1e-5). With the mass, pixels
    whose window mask differs between the two expectations (a tie at a
    window edge, on at most 1% of them) are left out."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    vol = torch.randn(shape, generator=gen, device=cuda) * 3
    B, D, H, W = shape
    gs = [torch.randn((B, 1, H, W), generator=gen, device=cuda) for _ in range(3)]
    grads, outs = [], []
    for fn in (fused_soft_argmin, fused_soft_argmin_reference):
        leaf = vol.clone().requires_grad_()
        out = fn(leaf, window=2)
        terms = [out[1], out[2]] + ([out[3]] if with_mass else [])
        torch.autograd.backward(terms, gs[:len(terms)])
        grads.append(leaf.grad)
        outs.append(out)
    before = fused_soft_argmin.launches
    fused_soft_argmin(vol, window=2)
    assert fused_soft_argmin.launches == before + 1  # the backward launches no kernel
    keep = torch.ones((B, 1, H, W), dtype=torch.bool, device=cuda)
    if with_mass:
        index = torch.arange(D, device=cuda, dtype=torch.float32).reshape(1, D, 1, 1)
        masks = [(torch.abs(index - o[1]) <= 2) for o in outs]
        keep = (masks[0] == masks[1]).all(dim=1, keepdim=True)
        assert keep.float().mean() >= 0.99
    ours, ref = grads
    assert torch.isfinite(ours).all()
    assert ((ours - ref).abs() * keep).max() <= 1e-4 * ref.abs().max()


def _guarded_calls(cuda):
    """Each forward-only wrapper with its CUDA arguments; the first requires grad."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    ref = torch.randn((1, 6, 8, 16), generator=gen, device=cuda).requires_grad_()
    src = torch.randn((1, 6, 8, 16), generator=gen, device=cuda)
    eye3 = torch.eye(3, device=cuda)
    depth = torch.linspace(1, 5, 4, device=cuda).reshape(1, 4)
    proj = torch.eye(4, device=cuda)[None].clone()
    proj[0, 0, 3] = 0.1
    w = (1.0 / depth).reshape(1, 4, 1, 1).expand(1, 4, 6, 8).contiguous()
    A = torch.tensor([[6.0, 0, 4], [0, 6, 3], [0, 0, 1]], device=cuda)[None]
    return {
        "sweep_warp": (sweep_variance, sweep_variance_reference,
                       (ref, src[:, None], eye3.expand(1, 1, 3, 3).contiguous(), torch.full((1, 1, 3), 0.1, device=cuda),
                        depth, torch.ones((1, 1), device=cuda))),
        "sweep_group_cost": (homography_group_cost, homography_group_cost_reference,
                             (ref, src, A, A * 0.1, w)),
        "warp_volume": (homo_warp_volume, homo_warp_volume_reference, (ref, proj, torch.eye(4, device=cuda)[None], depth)),
    }


@pytest.mark.parametrize("kernel", ["sweep_warp", "sweep_group_cost", "warp_volume"])
def test_forward_only_kernels_refuse_a_gradient(cuda, kernel):
    """K2, K2 group and K4 have no backward (JAX's K2 has no VJP, its K4's VJP
    refuses training): a CUDA input that requires grad raises while grad mode
    is on; under torch.no_grad() the kernel runs and matches its plain version."""
    fn, plain, args = _guarded_calls(cuda)[kernel]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args)
    before = fn.launches
    with torch.no_grad():
        out = fn(*args)
        torch.testing.assert_close(out, plain(*args), atol=1e-5, rtol=0)
    assert fn.launches == before + 1


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_training_on_card_matches_cpu(cuda, dim, dtype):
    """The family's BatchNorm in training (flax's statistics): output within
    1e-5 (bf16: one rounding step, 2^-8 relative), running mean and variance
    within rtol 1e-5, the card against the CPU."""
    from robustmvd_tpu_torch.ops import layers

    gen = torch.Generator().manual_seed(4)
    x = (torch.randn((2, 8, 6, 9, 20)[: dim + 2], generator=gen) * 2 + 0.5).to(dtype)
    outs = {}
    for device in ("cpu", "cuda"):
        bn = (layers.BatchNorm2d if dim == 2 else layers.BatchNorm3d)(8).to(device).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 8)), bn.bias.copy_(torch.linspace(-0.2, 0.2, 8))
        y = bn(x.to(device))
        outs[device] = (y.float().cpu(), bn.running_mean.cpu(), bn.running_var.cpu())
    (y_g, m_g, v_g), (y_c, m_c, v_c) = outs["cuda"], outs["cpu"]
    tol = 1e-5 if dtype == torch.float32 else 2.0**-8
    assert ((y_g - y_c).abs() <= tol * (1 + y_c.abs())).all()
    torch.testing.assert_close(m_g, m_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v_g, v_c, rtol=1e-5, atol=0)


def test_conv3d_bf16_weight_gradient_is_float32(cuda):
    """``ops/conv3d.py::Conv3d`` at bf16 on K5's bf16 form: the weight's
    gradient is float32 (through the per-call bf16 layout), within 2^-6 of its
    largest magnitude of the CPU's (bf16 sums)."""
    from robustmvd_tpu_torch.ops.conv3d import Conv3d

    gen = torch.Generator().manual_seed(6)
    x = torch.randn((1, 8, 6, 10, 12), generator=gen)
    grads = {}
    for device in ("cpu", "cuda"):
        conv = Conv3d(8, 16, impl="banded", dtype=torch.bfloat16)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(7)) / 10)
        conv = conv.to(device)
        before = conv3d_banded.launches_by_dtype["bfloat16"]
        (conv(x.to(device)).float() ** 2).sum().backward()
        assert conv3d_banded.launches_by_dtype["bfloat16"] == before + (device == "cuda")
        assert conv.weight.grad.dtype == torch.float32
        grads[device] = conv.weight.grad.cpu()
    assert (grads["cuda"] - grads["cpu"]).abs().max() <= 2.0**-6 * grads["cpu"].abs().max()


def _grad_off_bound(ours, ref):
    """Parameters whose gradient leaves ``tests/test_gradient_parity.py``'s
    bound: rtol 2e-3, atol max(2e-3 x its max |g|, 1e-4 x the largest)."""
    largest = max(float(r.abs().max()) for r in ref.values())
    return [n for n, r in ref.items()
            if ((ours[n] - r).abs() > 2e-3 * r.abs() + max(2e-3 * float(r.abs().max()), 1e-4 * largest)).any()]


def test_vis_train_step_on_card_matches_cpu(cuda):
    """One vis_mvsnet training step (train=True: BatchNorm on batch statistics,
    the pairs one at a time, the "xla" warp route), card vs CPU, 64x64, B 1,
    1+2 views, score heads conditioned (FAMILY_HEAD_GAINS), cuDNN
    deterministic: K5 45 times and K3 9 times forward on the card, none in the
    backward; loss within rtol 1e-4, gradients at test_gradient_parity.py's
    bounds, every parameter upstream of the readouts with a non-zero gradient,
    the new running statistics within rtol 1e-5."""
    import robustmvd_tpu_torch as rmvd

    rng = np.random.RandomState(9)
    B, V, H, W = 1, 3, 64, 64
    images = rng.rand(B, V, 3, H, W).astype(np.float32) - 0.45
    K = np.tile(np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32), (B, V, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[:, 1:, 0, 3] = [0.1, -0.12]
    depth = rng.uniform(1.0, 12.0, size=(B, 1, H, W)).astype(np.float32)
    torch.backends.cudnn.deterministic = True
    steps = {}
    try:
        for device in ("cpu", "cuda"):
            model = conditioned_heads(rmvd.create_model("vis_mvsnet", device=device, train=True, seed=0), "vis_mvsnet")
            loss = rmvd.create_loss("vismvsnet_loss", model=model)
            inputs = {"images": torch.from_numpy(images).to(device), "poses": torch.from_numpy(poses).to(device),
                      "intrinsics": torch.from_numpy(K).to(device),
                      "keyview_idx": torch.zeros(B, dtype=torch.int64, device=device),
                      "depth_range": (torch.full((B,), 1.0, device=device), torch.full((B,), 10.0, device=device))}
            before = (conv3d_banded.launches, fused_soft_argmin.launches)
            pred, aux = model(**inputs)
            forward = (conv3d_banded.launches - before[0], fused_soft_argmin.launches - before[1])
            total = loss(inputs, {"depth": torch.from_numpy(depth).to(device)}, pred, aux, iteration=0)[0]
            total.backward()
            assert (conv3d_banded.launches - before[0], fused_soft_argmin.launches - before[1]) == forward
            steps[device] = (float(total.detach()), {n: p.grad.cpu() for n, p in model.named_parameters()
                                                     if p.grad is not None},
                             {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}, forward)
    finally:
        torch.backends.cudnn.deterministic = False
    (l_g, g_g, s_g, n_g), (l_c, g_c, s_c, n_c) = steps["cuda"], steps["cpu"]
    assert n_g == (45, 9) and n_c == (0, 0)
    assert np.isfinite(l_g) and abs(l_g - l_c) <= 1e-4 * abs(l_c)
    assert g_g.keys() == g_c.keys()
    assert not _grad_off_bound(g_g, g_c)
    zero = sorted(n for n, g in g_g.items() if not g.any())
    assert all(n.endswith("uncert_net.head_1.weight") for n in zero)
    for k, v in s_c.items():
        torch.testing.assert_close(s_g[k], v, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("shape, size", [((1, 3, 375, 1242), (384, 1280)), ((2, 3, 120, 250), (128, 256)),
                                         ((1, 3, 100, 90), (50, 45))])
def test_device_resize_matches_the_host_resize(cuda, shape, size):
    """``resize_bilinear_torch`` on the card against the numpy resize: the
    same taps and lerps as separate IEEE float32 kernels, within 2^-16 x 255
    (the bound of chip_smoke.py's resize_parity; bit for bit unless a
    multiply and an add were fused)."""
    from robustmvd_tpu_torch.utils.image import resize_bilinear, resize_bilinear_torch

    img = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    ours = resize_bilinear_torch(torch.from_numpy(img).to(cuda), size)
    assert ours.device.type == "cuda"
    assert np.abs(ours.cpu().numpy() - resize_bilinear(img, size)).max() <= 2.0**-16 * 255


def test_staged_views_stay_on_the_card(cuda):
    """The engine hands robust_mvd's input adapter the views it uploaded
    once per sample: the same CUDA tensors on every run."""
    model = create_model("robust_mvd", device="cuda")
    seen = []
    adapter = model.input_adapter

    def noted(images, **kwargs):
        seen.append(list(images))
        return adapter(images=images, **kwargs)

    model.input_adapter = noted
    _evaluate("cuda", num_samples=1, burn_in_samples=0, size=(60, 120), model=model)
    assert len(seen) == 2 and all(image.device.type == "cuda" for images in seen for image in images)
    assert len({id(image) for images in seen for image in images}) == 3


def test_wrapped_model_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """vis_mvsnet_wrapped on a stub repository (``wrapper_stubs.py``): the
    network's parameters on the card, the prediction within 1e-5 (relative
    to the mean) of the same wrapper on the CPU."""
    import robustmvd_tpu_torch.models.wrappers.wrappers as wrappers
    from wrapper_stubs import isolated_imports, stub_sample, write_stub_repos

    monkeypatch.setattr(wrappers, "PATHS_FILE", write_stub_repos(str(tmp_path)))
    with isolated_imports():
        card = create_model("vis_mvsnet_wrapped", device="cuda")
        cpu = create_model("vis_mvsnet_wrapped", device="cpu")
    assert card.device.type == "cuda" and all(p.is_cuda for p in card.model.parameters())
    ours, _ = card.run(**stub_sample(1, 60, 120))
    ref, _ = cpu.run(**stub_sample(1, 60, 120))
    for key in ("depth", "depth_uncertainty"):
        assert isinstance(ours[key], np.ndarray)
        assert np.abs(ours[key] - ref[key]).max() / np.abs(ref[key]).mean() <= 1e-5, key


def test_writer_takes_card_tensors(cuda, tmp_path):
    """The event writer reads scalars, images and histograms that live on the
    card (``.item()`` and host copies), into events.jsonl and, where
    ``tensorboard`` imports, its event file."""
    import json

    from robustmvd_tpu_torch.utils import writer

    writer.setup_writers(out_dir=str(tmp_path))
    writer.put_scalar("loss", torch.tensor(2.5, device=cuda), step=0)
    writer.put_tensor("image", torch.zeros(4, 6, 3, dtype=torch.uint8, device=cuda), step=0)
    writer.put_histogram("params", torch.linspace(-1, 1, 11, device=cuda), step=0)
    writer.write_out_storage()
    writer.setup_writers(out_dir=None)
    lines = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert lines == [{"type": "scalar", "name": "loss", "value": 2.5, "step": 0}]


def test_profiler_on_the_card(cuda, tmp_path):
    """``time_fn`` times with CUDA events, ``trace`` records the card's
    kernels (50 launches: a process's first profiler session was seen to
    record none of one), ``device_memory_stats`` reads the allocator."""
    import json

    from robustmvd_tpu_torch.utils import profiler

    x = torch.randn(1024, 1024, device=cuda)
    seconds = profiler.time_fn(lambda: x @ x, iters=5, burn_in=2)
    with profiler.trace(tmp_path, device=cuda):
        for _ in range(50):  # a process's first session may drop its first records
            x @ x
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    stats = profiler.device_memory_stats(cuda)
    assert 0 < seconds < 1 and any(e.get("cat") == "kernel" for e in events)
    assert stats.keys() == {"mib_in_use", "peak_mib_in_use", "mib_limit"} and stats["mib_limit"] > 1000
