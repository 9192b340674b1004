"""cvp_mvsnet's and vis_mvsnet's XLA warp routes, in the port vs the JAX package.

``warp_impl="xla"`` is the route the JAX models take off the TPU and train
through: cvp warps each source view with ``rt_planesweep_warp`` and keeps
float32 running sums of the views and their squares; vis warps each source
map by the homography of every hypothesis (``get_homographies`` +
``homography_warping``) and sums channel products by group. The same numpy
inputs and bridged weights go through both packages on the CPU, JAX's
models under ``jax.jit`` at ``warp_impl="xla"``. Bounds:
- the warps and cost volumes at float32: atol 1e-5 (the same float32 ops);
- the models at float32: cvp's depth mean <= 1e-5 and max <= 1e-4 of its
  mean magnitude (``test_torch_port_cvp.py``), vis's mean <= 1e-4 and max
  <= 1e-3 with the uncertainty's mean |d| <= 1e-4 and |d| > 1e-3 on at most
  1% of the pixels (``test_torch_port_vis_mvsnet.py``);
- the models at bf16: the benchmark's bounds of ``test_torch_port_family_
  bf16.py`` (absrel < 1 point, 1.03-inliers > 97%), JAX's bf16 depth as the
  ground truth.
The JAX routes build their pixel grids in the features' dtype and the port
in float32 (ROADMAP queue 3): the two agree where bf16 holds every grid
value, integer grids up to 256 pixels and pixel centres up to 127.5. The
maps here are at most 64 x 128 (integer grids) and 32 x 40 (centres);
``test_bf16_pixel_grids_depart_from_jax_beyond_their_exact_range`` shows the
widths beyond.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.models.blocks.cvp_mvsnet import proj_cost_volume as jax_proj_cost_volume
from robustmvd_tpu.ops import homography as jax_homography
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.models.blocks.cvp_mvsnet import proj_cost_volume
from robustmvd_tpu_torch.models.weights import state_dict_from_jax
from robustmvd_tpu_torch.ops import homography

from test_torch_port_group_cost import _cams, _depth_start
from torch_port_helpers import (
    assert_depth_within_benchmark_bounds,
    family_sample,
    jax_family,
    random_pose,
    relative_errors,
    run_jax_family,
    t,
)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_homography_sweep_matches_jax_repeated_warp(rng, per_pixel):
    """One source map under D homographies, against JAX's route: the map
    repeated D times and ``homography_warping`` of each."""
    B, h, w, C, D = 2, 12, 20, 8, 5
    key, src = _cams(rng, B, h, w)
    start = _depth_start(rng, B, h, w, per_pixel)
    interval = np.full_like(start, 0.3)
    feat = rng.randn(B, h, w, C).astype(np.float32)
    Hs = jax_homography.get_homographies(jnp.asarray(key), jnp.asarray(src), D, jnp.asarray(start),
                                         jnp.asarray(interval))
    Hp, Wp = Hs.shape[2:4]
    H_flat = Hs.reshape(B * D, 3, 3) if (Hp, Wp) == (1, 1) else Hs.reshape(B * D, Hp, Wp, 3, 3)
    rep = jnp.broadcast_to(jnp.asarray(feat)[:, None], (B, D, h, w, C)).reshape(B * D, h, w, C)
    ref = np.asarray(jax_homography.homography_warping(rep, H_flat)).reshape(B, D, h, w, C)
    ours_Hs = homography.get_homographies(t(key), t(src), D, t(start), t(interval))
    ours = homography.homography_sweep(t(feat), ours_Hs).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    assert (ours != 0).mean() > 0.5


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cvp_xla_cost_volume_matches_jax(rng, dtype):
    """Per-pixel hypotheses, two source views: ``rt_planesweep_warp`` per view
    and float32 running sums, float32 out for float32 and bf16 features."""
    B, h, w, C, D, V = 1, 10, 16, 8, 6, 2
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] + [random_pose(rng, scale=0.05) for _ in range(V)])[None]
    ref_feat = jnp.asarray(rng.randn(B, h, w, C), dtype)
    src_feats = jnp.asarray(rng.randn(B, V, h, w, C), dtype)
    hypos = (2.0 + rng.rand(B, D, h, w) * 3).astype(np.float32)
    Ks = np.tile(K, (B, V, 1, 1))
    ref = jax_proj_cost_volume(ref_feat, [src_feats[:, i] for i in range(V)], jnp.asarray(K[None]), jnp.asarray(Ks),
                               jnp.asarray(poses[:, 0]), jnp.asarray(poses[:, 1:]), jnp.asarray(hypos), impl="xla")
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    as_torch = lambda a: t(np.asarray(a, np.float32)).to(torch_dtype)  # noqa: E731
    ours = proj_cost_volume(as_torch(ref_feat), as_torch(src_feats), t(K[None]), t(Ks), t(poses[:, 0]),
                            t(poses[:, 1:]), t(hypos), warp_impl="xla")
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _port(name, variables, kwargs, **more):
    port = create_model(name, device="cpu", warp_impl="xla", **kwargs, **more)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port


@pytest.mark.parametrize("name", ["cvp_mvsnet", "vis_mvsnet"])
def test_xla_route_matches_jax_at_float32(name):
    module, variables, adapter, kwargs = jax_family(name, "xla", "float32")
    sample = family_sample(name)
    ref, _ = run_jax_family(module, variables, adapter, sample)
    pred, _ = _port(name, variables, kwargs).run(**sample)
    assert pred["depth"].shape == ref["depth"].shape
    assert np.isfinite(ref["depth"]).all() and ref["depth"].std() > 1e-3 * np.abs(ref["depth"]).mean()
    mean, mx = relative_errors(pred["depth"], ref["depth"])
    diff = np.abs(pred["depth_uncertainty"] - ref["depth_uncertainty"])
    if name == "cvp_mvsnet":
        assert mean <= 1e-5 and mx <= 1e-4, (mean, mx)
        assert (diff <= 1e-4 * np.abs(ref["depth_uncertainty"]).mean()).mean() >= 0.99
    else:
        assert mean <= 1e-4 and mx <= 1e-3, (mean, mx)
        assert diff.mean() <= 1e-4 and (diff > 1e-3).mean() <= 0.01, (diff.mean(), (diff > 1e-3).mean())


@pytest.mark.parametrize("name", ["cvp_mvsnet", "vis_mvsnet"])
def test_xla_route_matches_jax_at_bf16(name):
    module, variables, adapter, kwargs = jax_family(name, "xla", "bfloat16")
    sample = family_sample(name)
    ref, _ = run_jax_family(module, variables, adapter, sample)
    pred, _ = _port(name, variables, kwargs, dtype="bfloat16").run(**sample)
    assert_depth_within_benchmark_bounds(pred["depth"], ref["depth"], ref["depth_uncertainty"],
                                         pred["depth_uncertainty"])


@pytest.mark.parametrize("name", ["cvp_mvsnet", "vis_mvsnet"])
def test_fused_and_xla_cost_volumes_agree(rng, name):
    """The two routes build one cost volume. cvp: K2's dense mode and the
    per-view warps with float32 running sums read the same coordinates
    (atol 1e-5, sums in another order). vis: K2's group mode and
    ``homography_sweep`` + ``groupwise_correlation`` form the coordinates in
    another order (the kernel's ``p_x / (p_z + 1e-9) - 0.5``, the XLA route's
    normalised and clamped ``((g + 1) W - 1) / 2``, a few ulps of a pixel
    apart; the clamp acts only on maps under ~10 px, here 16 x 24): atol
    1e-4 of the volume's scale."""
    B, h, w, C, D = 1, 16, 24, 16, 6
    ref = rng.randn(B, h, w, C).astype(np.float32)
    if name == "cvp_mvsnet":
        V = 2
        K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
        poses = np.stack([np.eye(4, dtype=np.float32)] + [random_pose(rng, scale=0.05) for _ in range(V)])[None]
        args = (t(ref), t(rng.randn(B, V, h, w, C).astype(np.float32)), t(K[None]), t(np.tile(K, (B, V, 1, 1))),
                t(poses[:, 0]), t(poses[:, 1:]), t((2.0 + rng.rand(B, D, h, w) * 3).astype(np.float32)))
        fused, xla = (proj_cost_volume(*args, warp_impl=impl).numpy() for impl in ("fused", "xla"))
        np.testing.assert_allclose(xla, fused, atol=1e-5, rtol=1e-5)
        return
    from robustmvd_tpu_torch.models.blocks.vis_mvsnet import GROUPS, PIXEL_CENTRES
    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import homography_group_cost
    from robustmvd_tpu_torch.ops.reductions import groupwise_correlation

    key, src = _cams(rng, B, h, w)
    start, interval = _depth_start(rng, B, h, w, True), 0.25
    src_feat = t(rng.randn(B, h, w, C).astype(np.float32))
    A, Bm = homography.get_homography_coeffs(t(key), t(src))
    centres = torch.tensor(PIXEL_CENTRES)
    depth = start + interval * np.arange(D, dtype=np.float32).reshape(1, D, 1, 1)  # (B, D, h, w)
    w_dense = t((1.0 / (depth + 1e-9)).astype(np.float32))
    fused = homography_group_cost(t(ref), src_feat, homography.matmul_sums(A, centres),
                                  homography.matmul_sums(Bm, centres), w_dense, groups=GROUPS).numpy()
    Hs = homography.get_homographies(t(key), t(src), D, t(start), t(np.full_like(start, interval)))
    xla = groupwise_correlation(t(ref)[:, None], homography.homography_sweep(src_feat, Hs), GROUPS, -1).numpy()
    assert (fused != 0).mean() > 0.5
    np.testing.assert_allclose(xla, fused, atol=1e-4 * np.abs(fused).max(), rtol=0)


@pytest.mark.parametrize("name", ["cvp_mvsnet", "vis_mvsnet"])
@pytest.mark.parametrize("jax_name,route", [("auto", "fused"), ("pallas", "fused"), ("pallas_fused", "fused"),
                                            ("fused", "fused"), ("xla", "xla")])
def test_create_model_maps_jax_warp_impl_names(name, jax_name, route):
    kwargs = {"nscale": 2} if name == "cvp_mvsnet" else {}
    assert create_model(name, device="cpu", warp_impl=jax_name, **kwargs).warp_impl == route
    with pytest.raises(ValueError, match="warp_impl"):
        create_model(name, device="cpu", warp_impl="gather", **kwargs)


def test_bf16_pixel_grids_depart_from_jax_beyond_their_exact_range(rng):
    """JAX's XLA warps build the pixel grid in the features' dtype. bf16
    holds integers up to 256 and pixel centres up to 127.5: beyond, JAX's
    bf16 route samples other points than its float32 route (128.5 is 128 in
    bf16), while the port's float32 grid gives the float32 route's samples
    at every width. Maps of bf16 values, so that only the grid differs."""
    as_bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    # homography_warping (vis): pixel centres, a map 160 wide, shifted by a quarter pixel
    feat = as_bf16(rng.randn(1, 3, 160, 4))
    H = np.array([[[1.0, 0.0, 0.25], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    jax_f32 = np.asarray(jax_homography.homography_warping(jnp.asarray(feat), jnp.asarray(H)))
    jax_bf16 = np.asarray(jax_homography.homography_warping(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(H)))
    ours = homography.homography_warping(t(feat).to(torch.bfloat16), t(H)).numpy()
    _departs(jax_f32, jax_bf16, ours, exact_below=128)

    # homo_warp and rt_planesweep_warp (mvsnet, cvp): integer grids, a map 288 wide
    feat = as_bf16(rng.randn(1, 2, 288, 4))
    src_proj, key_inv = np.eye(4, dtype=np.float32)[None], np.eye(4, dtype=np.float32)[None]
    src_proj[0, 0, 3] = 0.3  # a third of a pixel at depth 1
    depth = np.ones((1, 1), np.float32)
    args = [jnp.asarray(a) for a in (src_proj, key_inv, depth)]
    jax_f32 = np.asarray(jax_homography.homo_warp(jnp.asarray(feat), *args))[:, 0]
    jax_bf16 = np.asarray(jax_homography.homo_warp(jnp.asarray(feat, jnp.bfloat16), *args))[:, 0]
    ours = homography.homo_warp(t(feat).to(torch.bfloat16), t(src_proj), t(key_inv), t(depth)).numpy()[:, 0]
    _departs(jax_f32, jax_bf16, ours, exact_below=257)


def _departs(jax_f32, jax_bf16, ours, exact_below):
    """The port's bf16-feature warp is JAX's float32 one at every column;
    JAX's bf16 one agrees with it up to ``exact_below`` and not beyond."""
    np.testing.assert_allclose(ours, jax_f32, atol=1e-6)
    np.testing.assert_allclose(jax_bf16[:, :, :exact_below], jax_f32[:, :, :exact_below], atol=1e-6)
    beyond = np.abs(jax_bf16[:, :, exact_below:] - jax_f32[:, :, exact_below:]).max(axis=(0, 1, 3))
    assert (beyond > 1e-3).mean() > 0.4, beyond
