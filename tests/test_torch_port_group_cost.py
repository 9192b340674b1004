"""K2 group mode (fused homography warp + group correlation) and the
Vis-MVSNet homographies: the port vs JAX.

On the CPU the port's ``homography_group_cost`` runs its plain torch version
(the TPU kernel's coordinates, a bilinear gather, group sums in channel
order). The same numpy inputs go through
- the JAX TPU kernel in interpret mode (``ops/pallas/sweep_warp.py``): atol
  5e-5, rtol 1e-4. The coordinates are formed in the same order; the TPU
  kernel samples by tent-weight matmuls, the port by a gather, so the sums
  differ by rounding;
- the JAX XLA route (``get_homographies`` -> ``homography_warping`` ->
  ``groupwise_correlation``) on maps of at least 10 px, within the bound the
  JAX package holds its kernel to against that route
  (``tests/test_sweep_warp.py``: atol 5e-4, rtol 1e-3): the route forms the
  homography per depth before applying it and divides by the map size;
- on an 8 px map the two JAX routes differ: ``homography_warping`` clamps
  the normalised coordinates to +-1.1 (rmvd's ``interpolate``), which there
  still reaches the edge pixels; the kernel does not clamp. The port follows
  the kernel (ROADMAP queue 3).
The homography functions hold 1e-6 relative to JAX (3x3 products written
out as sums in both; the inverse rounds differently at the ulp level).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.ops import homography as jax_homography
from robustmvd_tpu.ops.pallas.sweep_warp import homography_group_cost as jax_group_cost
from robustmvd_tpu.ops.reductions import groupwise_correlation as jax_groupwise_correlation
from robustmvd_tpu_torch.models.blocks.vis_mvsnet import scale_camera
from robustmvd_tpu_torch.ops import homography
from robustmvd_tpu_torch.ops.kernels import sweep_group_cost as k2g

from torch_port_helpers import t

KERNEL_TOL = dict(atol=5e-5, rtol=1e-4)
ROUTE_TOL = dict(atol=5e-4, rtol=1e-3)
CENTRES = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32)


def _cams(rng, B, h, w, shift=(0.15, 0.07)):
    """Key and source cam tensors (B, 2, 4, 4): the source shifted by
    ``shift`` and slightly rotated, both with intrinsics for an h x w map."""
    from scipy.spatial.transform import Rotation

    key = np.zeros((B, 2, 4, 4), np.float32)
    key[:, 0] = np.eye(4)
    key[:, 1, :3, :3] = [[w * 0.8, 0, w / 2], [0, w * 0.8, h / 2], [0, 0, 1]]
    src = key.copy()
    for b in range(B):
        src[b, 0, :3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
        src[b, 0, :2, 3] = np.array(shift) * (1 + 0.2 * b)
    return key, src


def _depth_start(rng, B, h, w, per_pixel):
    if per_pixel:
        return (2.0 + rng.rand(B, 1, h, w)).astype(np.float32)
    return np.full((B, 1, 1, 1), 2.0, np.float32)


def _kernel_args(key, src, start, interval, D, h, w):
    """The fused route's A, B (pixel centres folded in) and per-pixel w, as
    numpy, from the port's functions (the JAX ones are held to them below)."""
    A, Bm = homography.get_homography_coeffs(t(key), t(src))
    A, Bm = A.numpy() @ CENTRES, Bm.numpy() @ CENTRES
    depth = start + interval * np.arange(D, dtype=np.float32).reshape(1, D, 1, 1)
    wd = np.broadcast_to(1.0 / (depth + 1e-9), (key.shape[0], D, h, w)).astype(np.float32)
    return A.astype(np.float32), Bm.astype(np.float32), np.ascontiguousarray(wd)


def _xla_route(ref, src_feat, key, src, start, interval, D, groups=8):
    """JAX's get_homographies -> homography_warping -> groupwise_correlation."""
    B, h, w, C = ref.shape
    Hs = jax_homography.get_homographies(jnp.asarray(key), jnp.asarray(src), D, jnp.asarray(start),
                                         jnp.asarray(np.full_like(start[:, :, :1, :1], interval)))
    Hs = jnp.broadcast_to(Hs, (B, D, h, w, 3, 3)).reshape(B * D, h, w, 3, 3)
    src_rep = jnp.broadcast_to(jnp.asarray(src_feat)[:, None], (B, D, h, w, C)).reshape(B * D, h, w, C)
    warped = jax_homography.homography_warping(src_rep, Hs).reshape(B, D, h, w, C)
    ref_vol = jnp.broadcast_to(jnp.asarray(ref)[:, None], (B, D, h, w, C))
    return np.asarray(jax_groupwise_correlation(ref_vol, warped, groups, axis=-1))


@pytest.mark.parametrize("B,C,D", [(1, 16, 6), (1, 32, 20), (2, 16, 20), (2, 32, 6)])
def test_group_cost_matches_jax_kernel(rng, B, C, D):
    """Per-pixel w from a per-pixel depth start; D = 6 and 20 are no multiple
    of the TPU kernel's depth block."""
    h, w = 12, 20
    key, src = _cams(rng, B, h, w)
    A, Bm, wd = _kernel_args(key, src, _depth_start(rng, B, h, w, True), 0.25, D, h, w)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src_feat = rng.randn(B, h, w, C).astype(np.float32)
    before = k2g.homography_group_cost.launches
    ours = k2g.homography_group_cost(t(ref), t(src_feat), t(A), t(Bm), t(wd), groups=8).numpy()
    assert k2g.homography_group_cost.launches == before  # the CPU runs the plain version
    assert ours.shape == (B, D, h, w, 8)
    kernel = np.asarray(jax_group_cost(jnp.asarray(ref), jnp.asarray(src_feat), jnp.asarray(A), jnp.asarray(Bm),
                                       jnp.asarray(wd), groups=8, interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    assert (ours != 0).any(axis=-1).mean() > 0.5  # most samples land on the source map


@pytest.mark.parametrize("per_pixel", [False, True])
def test_group_cost_matches_jax_xla_route(rng, per_pixel):
    B, h, w, C, D = 1, 16, 24, 16, 6
    key, src = _cams(rng, B, h, w)
    start = _depth_start(rng, B, h, w, per_pixel)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src_feat = rng.randn(B, h, w, C).astype(np.float32)
    A, Bm, wd = _kernel_args(key, src, start, 0.5, D, h, w)
    ours = k2g.homography_group_cost(t(ref), t(src_feat), t(A), t(Bm), t(wd)).numpy()
    np.testing.assert_allclose(ours, _xla_route(ref, src_feat, key, src, start, 0.5, D), **ROUTE_TOL)


@pytest.mark.parametrize("G,C,D,w", [
    (4, 32, 6, 21),  # eight channels per group, odd W
    (16, 32, 1, 19),  # two channels per group (one per load on the card), one plane
    (4, 16, 3, 25),
    (16, 64, 2, 17),
    (8, 32, 9, 33),  # planes beyond one chunk of the CUDA kernel, odd W
])
def test_group_counts_and_row_tiles_match_jax(rng, G, C, D, w):
    """The shapes the CUDA kernel's row tiles, plane chunks and group loads
    make special (G 4 and 16, D = 1, odd W): the plain version the card
    tests hold the kernel to agrees with the JAX kernel in interpret mode
    (KERNEL_TOL) and with the JAX XLA route (ROUTE_TOL, maps of 12 px and
    more: no clamp)."""
    B, h = 1, 12
    key, src = _cams(rng, B, h, w)
    start = _depth_start(rng, B, h, w, True)
    A, Bm, wd = _kernel_args(key, src, start, 0.25, D, h, w)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src_feat = rng.randn(B, h, w, C).astype(np.float32)
    ours = k2g.homography_group_cost(t(ref), t(src_feat), t(A), t(Bm), t(wd), groups=G).numpy()
    assert ours.shape == (B, D, h, w, G)
    kernel = np.asarray(jax_group_cost(jnp.asarray(ref), jnp.asarray(src_feat), jnp.asarray(A), jnp.asarray(Bm),
                                       jnp.asarray(wd), groups=G, interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    np.testing.assert_allclose(ours, _xla_route(ref, src_feat, key, src, start, 0.25, D, G), **ROUTE_TOL)
    assert (ours != 0).any(axis=-1).mean() > 0.5


def test_small_maps_show_the_clamp_apart(rng):
    """8x8 maps and a baseline that sends samples beyond the map: the XLA
    route clamps them to index 1.05 N - 0.5 = 7.9 (or -0.9) and still reads
    the edge pixel with weight 0.1; the kernel and the port read zeros."""
    B, h, w, C, D = 1, 8, 8, 16, 6
    key, src = _cams(rng, B, h, w, shift=(0.6, 0.3))
    start = _depth_start(rng, B, h, w, False)
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src_feat = rng.randn(B, h, w, C).astype(np.float32)
    A, Bm, wd = _kernel_args(key, src, start, 0.25, D, h, w)
    ours = k2g.homography_group_cost(t(ref), t(src_feat), t(A), t(Bm), t(wd)).numpy()
    kernel = np.asarray(jax_group_cost(jnp.asarray(ref), jnp.asarray(src_feat), jnp.asarray(A), jnp.asarray(Bm),
                                       jnp.asarray(wd), interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    route = _xla_route(ref, src_feat, key, src, start, 0.25, D)
    xi, yi = (c.numpy() for c in k2g.homography_coordinates(t(A), t(Bm), t(wd)))
    clamped = (np.abs(xi + 0.5 - w / 2) > 0.55 * w) | (np.abs(yi + 0.5 - h / 2) > 0.55 * h)
    assert 0.05 < clamped.mean() < 0.95, clamped.mean()
    assert np.abs(route - ours)[clamped].max() > 1e-2  # clamped samples still read the edge
    np.testing.assert_allclose(ours[~clamped], route[~clamped], **ROUTE_TOL)


def test_group_sum_is_the_jax_groupwise_correlation(rng):
    """Where every sample lies inside the map, the plain version is the
    warped source's group correlation with the key (JAX's definition)."""
    B, h, w, C, D = 1, 6, 7, 24, 3
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src_feat = rng.randn(B, h, w, C).astype(np.float32)
    A = np.tile(CENTRES, (B, 1, 1))  # identity homography: p = pixel centre
    Bm = np.zeros((B, 3, 3), np.float32)
    wd = np.ones((B, D, h, w), np.float32)
    ours = k2g.homography_group_cost(t(ref), t(src_feat), t(A), t(Bm), t(wd), groups=8).numpy()
    ref_vol = np.broadcast_to(ref[:, None], (B, D, h, w, C))
    src_vol = np.broadcast_to(src_feat[:, None], (B, D, h, w, C))
    expected = np.asarray(jax_groupwise_correlation(jnp.asarray(ref_vol), jnp.asarray(src_vol), 8, axis=-1))
    np.testing.assert_allclose(ours, expected, atol=1e-5, rtol=1e-5)


def test_group_cost_bf16_output_and_rejections(rng):
    B, h, w, C, D = 1, 6, 7, 16, 3
    ref, src_feat = (t(rng.randn(B, h, w, C).astype(np.float32)) for _ in range(2))
    A, Bm = t(np.tile(CENTRES, (B, 1, 1))), t(np.zeros((B, 3, 3), np.float32))
    wd = t(np.ones((B, D, h, w), np.float32))
    out = k2g.homography_group_cost(ref, src_feat, A, Bm, wd)
    out16 = k2g.homography_group_cost(ref, src_feat, A, Bm, wd, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16, out.bfloat16(), atol=0, rtol=0)
    with pytest.raises(ValueError):
        k2g.homography_group_cost(ref, src_feat, A, Bm, wd, groups=5)
    with pytest.raises(TypeError):
        k2g.homography_group_cost(ref.bfloat16(), src_feat, A, Bm, wd)
    with pytest.raises(ValueError):
        k2g.homography_group_cost(ref, src_feat, A, Bm, wd[:, :, :-1])


@pytest.mark.parametrize("per_pixel", [False, True])
def test_get_homographies_matches_jax(rng, per_pixel):
    B, h, w, D = 2, 5, 6, 4
    key, src = _cams(rng, B, 24, 32)
    start = _depth_start(rng, B, h, w, per_pixel)
    interval = np.full_like(start, 0.3)
    ours = homography.get_homographies(t(key), t(src), D, t(start), t(interval)).numpy()
    ref = np.asarray(jax_homography.get_homographies(jnp.asarray(key), jnp.asarray(src), D, jnp.asarray(start),
                                                     jnp.asarray(interval)))
    assert ours.shape == ref.shape == ((B, D, h, w, 3, 3) if per_pixel else (B, D, 1, 1, 3, 3))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the affine form A + B / (d + 1e-9) gives the same matrices
    A, Bm = homography.get_homography_coeffs(t(key), t(src))
    depth = start + interval * np.arange(D, dtype=np.float32).reshape(1, D, 1, 1)
    affine = A.numpy()[:, None, None, None] + Bm.numpy()[:, None, None, None] / (depth[..., None, None] + 1e-9)
    np.testing.assert_allclose(ours, affine, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_get_homography_coeffs_matches_jax(rng):
    key, src = _cams(rng, 2, 24, 32)
    ours = homography.get_homography_coeffs(t(key), t(src))
    ref = jax_homography.get_homography_coeffs(jnp.asarray(key), jnp.asarray(src))
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("per_pixel", [False, True])
def test_homography_warping_matches_jax(rng, per_pixel):
    """3x3 or per-pixel homographies; a baseline that sends part of the map
    off the source and into the clamp."""
    B, h, w, C = 2, 12, 16, 5
    key, src = _cams(rng, B, h, w, shift=(0.4, 0.2))
    start = _depth_start(rng, B, h, w, per_pixel)
    Hs = homography.get_homographies(t(key), t(src), 1, t(start), t(np.full_like(start, 0.1)))[:, 0].numpy()
    H_mat = np.ascontiguousarray(Hs[:, 0, 0] if not per_pixel else Hs)
    feat = rng.randn(B, h, w, C).astype(np.float32)
    ours = homography.homography_warping(t(feat), t(H_mat)).numpy()
    ref = np.asarray(jax_homography.homography_warping(jnp.asarray(feat), jnp.asarray(H_mat)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    off = (ref == 0).all(axis=-1)  # beyond the clamp of a map of 12 or 16 px
    assert 0.05 < off.mean() < 0.95, off.mean()


def test_scale_camera_matches_jax(rng):
    from robustmvd_tpu.models.blocks.vis_mvsnet import scale_camera as jax_scale_camera

    cam = rng.randn(2, 2, 4, 4).astype(np.float32)
    np.testing.assert_array_equal(scale_camera(t(cam), 1 / 8).numpy(),
                                  np.asarray(jax_scale_camera(jnp.asarray(cam), 1 / 8)))


# --- chip_smoke.py's K2 group cases and its bf16 gate ---

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture(scope="module")
def k2_group_cases(smoke):
    return smoke.k2_group_cases(torch.device("cpu"))


def test_chip_smoke_k2_group_cases_are_vis_mvsnets_calls(monkeypatch, smoke, k2_group_cases):
    """``k2_group_cases`` times K2 group at the shapes vis_mvsnet's
    SingleStage passes it: recorded from the port's vis_mvsnet on the CPU at
    1+2 views of 128x192, scaled to 384x1280 by ``FEATURE_STRIDES``, with
    ``DEPTH_NUMS`` planes and the recorded feature width and groups."""
    from robustmvd_tpu_torch import create_model
    from robustmvd_tpu_torch.models.blocks import vis_mvsnet as vis_blocks
    from robustmvd_tpu_torch.models.vis_mvsnet import DEPTH_NUMS, FEATURE_STRIDES

    calls = []

    def record(ref, src, A, Bm, w, groups=8, out_dtype=torch.float32):
        calls.append((tuple(ref.shape), tuple(src.shape), tuple(w.shape), groups))
        return k2g.homography_group_cost(ref, src, A, Bm, w, groups=groups, out_dtype=out_dtype)

    H0, W0 = 128, 192
    model = create_model("vis_mvsnet", device="cpu", seed=0)
    monkeypatch.setattr(vis_blocks, "homography_group_cost", record)
    model.run(**smoke.sideways_sample(np.random.RandomState(3), H0, W0, 3))
    assert len(calls) == 2 * len(DEPTH_NUMS)  # two source views a stage
    assert list(k2_group_cases) == [f"stage{k}" for k in range(1, len(DEPTH_NUMS) + 1)]
    for k, (D, stride) in enumerate(zip(DEPTH_NUMS, FEATURE_STRIDES)):
        (ref, src, w, groups), other = calls[2 * k], calls[2 * k + 1]
        assert other == (ref, src, w, groups)
        C = ref[3]
        assert ref == src == (1, H0 // stride, W0 // stride, C) and w == (1, D, H0 // stride, W0 // stride)
        case = k2_group_cases[f"stage{k + 1}"]
        assert tuple(case[0].shape) == tuple(case[1].shape) == (1, 384 // stride, 1280 // stride, C)
        assert tuple(case[4].shape) == (1, D, 384 // stride, 1280 // stride) and groups == 8
        assert tuple(case[2].shape) == tuple(case[3].shape) == (1, 3, 3)


def test_chip_smoke_gates_k2_group_bf16_against_float32_at_every_stage(smoke, k2_group_cases):
    """Phase ``kernel`` sweep_group_cost fails where K2 group's bf16 form is
    not faster than its float32 form in the same run, at each of the three
    stages it times."""
    import inspect

    assert smoke.K2_GROUP_BF16_MUST_BEAT_F32 == ("stage1", "stage2", "stage3") == tuple(k2_group_cases)
    assert "check_k2_group_bf16_beats_f32(results)" in inspect.getsource(smoke.phase_kernel_k2_group)

    def results(**bf16_ms):
        return {case: {"ms": 0.1, "bf16": {"ms": bf16_ms.get(case, 0.05)}} for case in k2_group_cases}

    smoke.check_k2_group_bf16_beats_f32(results())
    for case in k2_group_cases:
        for ms in (0.1, 0.2):  # as slow as the float32 form, slower
            with pytest.raises(AssertionError, match=case):
                smoke.check_k2_group_bf16_beats_f32(results(**{case: ms}))
