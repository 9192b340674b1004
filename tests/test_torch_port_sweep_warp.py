"""K2 (fused plane-sweep warp + variance): the port's plain version vs JAX.

On the CPU the port's ``warp_variance`` / ``warp_variance_rt`` /
``warp_variance_dense`` run their plain torch version (``rt_planesweep_warp``
per view, then ``E[x^2] - E[x]^2`` in float32). The same numpy inputs go
through
- the JAX TPU kernel in interpret mode (``ops/pallas/sweep_warp.py``):
  atol 5e-5, rtol 1e-4, the bound the JAX package holds that kernel to
  against its own ``homo_warp`` path (``tests/test_sweep_warp.py``). The
  kernel forms ``M_d = d * R + T e3^T`` before applying it to the pixel, the
  port applies R first; the coordinates differ by ulps and bilinear
  sampling is continuous, so the values do too;
- the JAX ``homo_warp`` / ``rt_planesweep_warp`` + variance path, which has
  the port's op order: atol 1e-5, rtol 1e-5 (the 4x4 product and the
  inverse round differently at the ulp level).
The cases mirror ``tests/test_sweep_warp.py``: tilings that pad the depth
axis, a masked view, rows off the image, bf16 features, and planes through
``z = 0`` (non-finite coordinates, which the TPU kernel and the port both
send off the image).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.ops.homography import homo_warp as jax_homo_warp
from robustmvd_tpu.ops.homography import rt_planesweep_warp as jax_rt_warp
from robustmvd_tpu.ops.pallas import sweep_warp as jax_k2
from robustmvd_tpu_torch.ops.kernels import sweep_warp as k2
from robustmvd_tpu_torch.ops.homography import plane_sweep_transform

from torch_port_helpers import t

KERNEL_TOL = dict(atol=5e-5, rtol=1e-4)
PATH_TOL = dict(atol=1e-5, rtol=1e-5)


def _setup(rng, B, V, h, w, C, D, shift=0.1):
    """As tests/test_sweep_warp.py: a row of cameras shifted along x and y."""
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src = rng.randn(B, V, h, w, C).astype(np.float32)
    W = w * 4
    K = np.array([[W * 0.2, 0, w / 2], [0, W * 0.2, h / 2], [0, 0, 1]], np.float32)
    proj = np.tile(np.eye(4, dtype=np.float32), (B, V + 1, 1, 1))
    for i in range(V + 1):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3], pose[1, 3] = shift * i, shift / 2 * i
        proj[:, i, :3, :4] = K @ pose[:3, :4]
    ref_proj_inv = np.linalg.inv(proj[:, 0]).astype(np.float32)
    depths = np.broadcast_to(np.linspace(0.5, 10.0, D, dtype=np.float32)[None], (B, D)).copy()
    return ref, src, proj[:, 1:].copy(), ref_proj_inv, depths


def _jax_variance(ref, src, warps, valid=None):
    """The JAX warp path + variance, as tests/test_sweep_warp.py builds it."""
    B, V = src.shape[:2]
    valid = np.ones((B, V), np.float32) if valid is None else valid
    vs = jnp.asarray(ref, jnp.float32)[:, None]
    vq = vs**2
    for v in range(V):
        wp = warps(v).astype(jnp.float32) * valid[:, v].reshape(B, 1, 1, 1, 1)
        vs, vq = vs + wp, vq + wp**2
    n = (1.0 + valid.sum(1)).reshape(B, 1, 1, 1, 1)
    return np.asarray(vq / n - (vs / n) ** 2)


def _homo_path(ref, src, sp, rpi, dv, valid=None):
    return _jax_variance(ref, src, lambda v: jax_homo_warp(jnp.asarray(src[:, v]), jnp.asarray(sp[:, v]),
                                                           jnp.asarray(rpi), jnp.asarray(dv)), valid)


@pytest.mark.parametrize("dc,band,D", [(4, 4, 12), (4, 4, 10), (12, 8, 12)])
def test_warp_variance_matches_jax(rng, dc, band, D):
    """D = 10 with dc = 4: the TPU kernel pads the depth axis and slices it off."""
    ref, src, sp, rpi, dv = _setup(rng, 1, 2, 16, 24, 8, D)
    before = k2.sweep_variance.launches
    ours = k2.warp_variance(t(ref), t(src), t(sp), t(rpi), t(dv)).numpy()
    assert k2.sweep_variance.launches == before  # the CPU runs the plain version
    assert ours.shape == (1, D, 16, 24, 8)
    kernel = np.asarray(jax_k2.warp_variance(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(sp), jnp.asarray(rpi),
                                             jnp.asarray(dv), dc=dc, band=band, interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    np.testing.assert_allclose(ours, _homo_path(ref, src, sp, rpi, dv), **PATH_TOL)


def test_view_masking(rng):
    """A masked view slot adds nothing, and the count leaves it out."""
    ref, src, sp, rpi, dv = _setup(rng, 1, 3, 16, 24, 8, 8)
    valid = np.array([[1.0, 1.0, 0.0]], np.float32)
    ours = k2.warp_variance(t(ref), t(src), t(sp), t(rpi), t(dv), src_valid=t(valid)).numpy()
    kernel = np.asarray(jax_k2.warp_variance(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(sp), jnp.asarray(rpi),
                                             jnp.asarray(dv), src_valid=jnp.asarray(valid), dc=4, band=4,
                                             interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    np.testing.assert_allclose(ours, _homo_path(ref, src, sp, rpi, dv, valid), **PATH_TOL)
    two = k2.warp_variance(t(ref), t(src[:, :2]), t(sp[:, :2]), t(rpi), t(dv)).numpy()
    np.testing.assert_array_equal(ours, two)


def test_offimage_rows(rng):
    """A large baseline sends whole rows off the source image."""
    ref, src, sp, rpi, dv = _setup(rng, 1, 2, 16, 24, 8, 12, shift=0.8)
    ours = k2.warp_variance(t(ref), t(src), t(sp), t(rpi), t(dv)).numpy()
    kernel = np.asarray(jax_k2.warp_variance(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(sp), jnp.asarray(rpi),
                                             jnp.asarray(dv), dc=4, band=4, interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    np.testing.assert_allclose(ours, _homo_path(ref, src, sp, rpi, dv), **PATH_TOL)
    # not vacuous: some pixels lose both source samples (variance of
    # {ref, 0, 0} = 2/9 ref^2), others keep them
    off = np.isclose(ours, 2.0 / 9.0 * ref[:, None] ** 2, rtol=1e-5, atol=1e-7).all(axis=-1)
    assert 0.05 < off.mean() < 0.95, off.mean()


def test_bfloat16_features(rng):
    """bf16 features are sampled with float32 weights and f32 accumulation:
    equal to the JAX path on the same values in float32; the TPU kernel
    rounds its bilinear tents to bf16 as well, so it is held at the JAX
    package's own bf16 bound (3e-2 of the largest value)."""
    ref, src, sp, rpi, dv = _setup(rng, 1, 2, 16, 24, 8, 12)
    ref16, src16 = t(ref).bfloat16(), t(src).bfloat16()
    ours = k2.warp_variance(ref16, src16, t(sp), t(rpi), t(dv)).numpy()
    ref32, src32 = ref16.float().numpy(), src16.float().numpy()
    np.testing.assert_allclose(ours, _homo_path(ref32, src32, sp, rpi, dv), **PATH_TOL)
    kernel = np.asarray(jax_k2.warp_variance(jnp.asarray(ref, jnp.bfloat16), jnp.asarray(src, jnp.bfloat16),
                                             jnp.asarray(sp), jnp.asarray(rpi), jnp.asarray(dv), dc=4, band=4,
                                             interpret=True)).astype(np.float32)
    assert np.abs(ours - kernel).max() / np.abs(kernel).max() < 3e-2
    out16 = k2.warp_variance(ref16, src16, t(sp), t(rpi), t(dv), out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_array_equal(out16.float().numpy(), torch.from_numpy(ours).bfloat16().float().numpy())


def _rt(sp, rpi):
    rot, trans = plane_sweep_transform(t(sp), t(rpi))
    return rot.numpy(), trans.numpy()


def test_rt_mode_matches(rng):
    ref, src, sp, rpi, dv = _setup(rng, 1, 2, 16, 24, 8, 12)
    rot, trans = _rt(sp, rpi)
    ours = k2.warp_variance_rt(t(ref), t(src), t(rot), t(trans), t(dv)).numpy()
    kernel = np.asarray(jax_k2.warp_variance_rt(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(rot), jnp.asarray(trans),
                                                jnp.asarray(dv), dc=4, band=4, interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    path = _jax_variance(ref, src, lambda v: jax_rt_warp(jnp.asarray(src[:, v]), jnp.asarray(rot[:, v]),
                                                         jnp.asarray(trans[:, v]), jnp.asarray(dv)))
    np.testing.assert_allclose(ours, path, **PATH_TOL)


def test_dense_hypotheses_match(rng):
    B, V, h, w, C, D = 1, 2, 16, 24, 8, 6
    ref, src, sp, rpi, _ = _setup(rng, B, V, h, w, C, D)
    rot, trans = _rt(sp, rpi)
    base = 2.0 + rng.rand(B, 1, h, w).astype(np.float32)
    hypos = (base + np.linspace(-0.5, 0.5, D, dtype=np.float32)[None, :, None, None]).astype(np.float32)
    ours = k2.warp_variance_dense(t(ref), t(src), t(rot), t(trans), t(hypos)).numpy()
    kernel = np.asarray(jax_k2.warp_variance_dense(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(rot),
                                                   jnp.asarray(trans), jnp.asarray(hypos), dc=3, band=4,
                                                   interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    path = _jax_variance(ref, src, lambda v: jax_rt_warp(jnp.asarray(src[:, v]), jnp.asarray(rot[:, v]),
                                                         jnp.asarray(trans[:, v]),
                                                         jnp.asarray(hypos.reshape(B, D, h * w))))
    np.testing.assert_allclose(ours, path, **PATH_TOL)


def test_planes_through_z0(rng):
    """The source camera 3 units ahead: planes at d < 3 lie behind it (no
    z-mask: their points flip sign and may land on the image), d = 3 puts
    every point at z = 0 (inf and NaN coordinates: no tap counts)."""
    B, V, h, w, C = 1, 1, 8, 12, 8
    ref = rng.randn(B, h, w, C).astype(np.float32)
    src = rng.randn(B, V, h, w, C).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
    rot[:, :, 0, 2], rot[:, :, 1, 2] = -w / 2, -h / 2  # principal point to the origin
    trans = np.zeros((B, V, 3), np.float32)
    trans[:, :, 0], trans[:, :, 1], trans[:, :, 2] = w / 2 * -3.0, h / 2 * -3.0, -3.0
    dv = np.array([[1.0, 2.5, 3.0, 3.5, 6.0]], np.float32)
    ours = k2.warp_variance_rt(t(ref), t(src), t(rot), t(trans), t(dv)).numpy()
    assert np.isfinite(ours).all()
    # at d = 3 nothing is sampled: the variance of {ref, 0}
    np.testing.assert_allclose(ours[:, 2], (ref / 2) ** 2, rtol=1e-6)
    kernel = np.asarray(jax_k2.warp_variance_rt(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(rot),
                                                jnp.asarray(trans), jnp.asarray(dv), dc=5, band=4, interpret=True))
    np.testing.assert_allclose(ours, kernel, **KERNEL_TOL)
    # the finite planes agree with the JAX warp path too (d = 3 gives NaN there)
    path = _jax_variance(ref, src, lambda v: jax_rt_warp(jnp.asarray(src[:, v]), jnp.asarray(rot[:, v]),
                                                         jnp.asarray(trans[:, v]), jnp.asarray(dv)))
    finite = [0, 1, 3, 4]
    np.testing.assert_allclose(ours[:, finite], path[:, finite], **PATH_TOL)


@pytest.mark.parametrize("V,masked,D,w,dense", [
    (1, None, 5, 23, False),  # one source view, odd W
    (3, 1, 4, 37, False),  # three views, the middle one masked, odd W
    (2, None, 1, 24, False),  # one plane
    (3, 2, 1, 19, True),  # one per-pixel hypothesis, the last view masked, odd W
    (3, 0, 3, 31, True),  # per-pixel hypotheses, the first view masked
])
def test_row_tile_shapes_match_jax(rng, V, masked, D, w, dense):
    """The shapes the CUDA kernel's row tiles and view slots make special
    (V = 1, V = 3 with a masked view, D = 1, odd W): the plain version the
    card tests hold the kernel to agrees with the JAX kernel in interpret
    mode (KERNEL_TOL) and with the JAX warp path (PATH_TOL)."""
    h, C = 12, 8
    ref, src, sp, rpi, dv = _setup(rng, 1, V, h, w, C, D)
    valid = np.ones((1, V), np.float32)
    if masked is not None:
        valid[0, masked] = 0.0
    rot, trans = _rt(sp, rpi)
    if dense:
        depth = (dv[:, :, None, None] * (1 + 0.1 * rng.rand(1, D, h, w))).astype(np.float32)
        ours = k2.warp_variance_dense(t(ref), t(src), t(rot), t(trans), t(depth), src_valid=t(valid)).numpy()
        kernel = jax_k2.warp_variance_dense(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(rot), jnp.asarray(trans),
                                            jnp.asarray(depth), src_valid=jnp.asarray(valid), dc=4, band=4,
                                            interpret=True)
        depth_path = depth.reshape(1, D, h * w)
    else:
        ours = k2.warp_variance_rt(t(ref), t(src), t(rot), t(trans), t(dv), src_valid=t(valid)).numpy()
        kernel = jax_k2.warp_variance_rt(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(rot), jnp.asarray(trans),
                                         jnp.asarray(dv), src_valid=jnp.asarray(valid), dc=4, band=4, interpret=True)
        depth_path = dv
    assert ours.shape == (1, D, h, w, C)
    np.testing.assert_allclose(ours, np.asarray(kernel), **KERNEL_TOL)
    path = _jax_variance(ref, src, lambda v: jax_rt_warp(jnp.asarray(src[:, v]), jnp.asarray(rot[:, v]),
                                                         jnp.asarray(trans[:, v]), jnp.asarray(depth_path)), valid)
    np.testing.assert_allclose(ours, path, **PATH_TOL)


def test_rejects_what_the_kernel_does_not_take(rng):
    ref, src, sp, rpi, dv = _setup(rng, 1, 2, 8, 12, 4, 4)
    with pytest.raises(TypeError):
        k2.warp_variance(t(ref).bfloat16(), t(src), t(sp), t(rpi), t(dv))
    with pytest.raises(ValueError):
        k2.warp_variance(t(ref), t(src), t(sp), t(rpi), t(dv)[:, None])
    with pytest.raises(TypeError):
        k2.warp_variance(t(ref), t(src), t(sp), t(rpi), t(dv), out_dtype=torch.float16)
