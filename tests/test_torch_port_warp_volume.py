"""K4 (the materialised plane-sweep warp volume) in the port vs the JAX package.

The port's plain version (``homo_warp_volume_reference``, which is
``ops/homography.py::homo_warp``, what the wrapper runs on the CPU) takes
the same numpy inputs as the JAX package's functions, in the setups of
``tests/test_warp_volume_pallas.py`` (a random source pose; strong vertical
motion; coordinates far outside the image, one plane at z = 1e-3):
- float32 features against JAX ``homo_warp`` (XLA): atol = rtol = 1e-6
  (the same bilinear taps; the coordinates in the port's op order, a few
  ulps from JAX's);
- bfloat16 features against the TPU kernel ``homo_warp_pallas`` (interpret
  mode on the CPU): atol 1e-4, the JAX test's bound.
The same bounds hold at the shapes where the CUDA kernel's row tiles split
(``csrc/warp_volume.cu``: tiles of at most 512 pixels, C % 4 == 0 or one
channel per element).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.ops.homography import homo_warp as jax_homo_warp
from robustmvd_tpu.ops.pallas.warp_volume import homo_warp_pallas
from robustmvd_tpu_torch.ops.homography import homo_warp
from robustmvd_tpu_torch.ops.kernels.warp_volume import homo_warp_volume, homo_warp_volume_reference

from tests_common import random_pose_np
from torch_port_helpers import t


def _setup(rng, case, B=1, C=8):
    """(src, src_proj, ref_proj_inv, depths) as numpy, per case."""
    D, H, W = {"pose": (12, 16, 24), "wide_span": (6, 40, 16), "out_of_image": (4, 16, 24)}[case]
    src = rng.rand(B, H, W, C).astype(np.float32)
    K = np.array([[W * 0.8, 0, W / 2], [0, W * 0.8, H / 2], [0, 0, 1]], np.float32)
    projk = np.eye(4, dtype=np.float32)
    projk[:3, :3] = K
    projs = np.eye(4, dtype=np.float32)
    projs[:3, :4] = K @ random_pose_np(rng, 0.15, 0.1)[:3, :4]
    depths = np.linspace(0.5, 10.0, D, dtype=np.float32)
    if case == "wide_span":
        projs[1, 3] += 30.0
    if case == "out_of_image":
        projs[0, 3] += 500.0
        depths = np.array([1e-3, 0.5, 5.0, 1e4], np.float32)
    return (src, np.tile(projs, (B, 1, 1)), np.tile(np.linalg.inv(projk), (B, 1, 1)).astype(np.float32),
            np.tile(depths[None], (B, 1)))


CASES = ["pose", "wide_span", "out_of_image"]


def _row_setup(rng, H, W, D, C):
    """(src, src_proj, ref_proj_inv, depths) as numpy for one (H, W, D, C):
    a random source pose, D planes from 0.5 to 10."""
    src = rng.rand(1, H, W, C).astype(np.float32)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * H, H / 2], [0, 0, 1]], np.float32)
    projk = np.eye(4, dtype=np.float32)
    projk[:3, :3] = K
    projs = np.eye(4, dtype=np.float32)
    projs[:3, :4] = K @ random_pose_np(rng, 0.15, 0.1)[:3, :4]
    depths = np.linspace(0.5, 10.0, D, dtype=np.float32)[None]
    return src, projs[None], np.linalg.inv(projk)[None].astype(np.float32), depths


# (H, W, D): W prime, W one pixel longer than the kernel's 512-pixel tile, D = 1
ROW_SHAPES = [(4, 37, 3), (3, 513, 2), (5, 20, 1)]


@pytest.mark.parametrize("H,W,D", ROW_SHAPES)
@pytest.mark.parametrize("C", [6, 64])  # 6: the kernel's one-channel route
def test_plain_k4_float32_at_row_tiles_matches_jax_homo_warp(rng, H, W, D, C):
    args = _row_setup(rng, H, W, D, C)
    ours = homo_warp_volume(*(t(a) for a in args))
    ref = np.asarray(jax_homo_warp(*(jnp.asarray(a) for a in args)))
    assert ours.shape == ref.shape == (1, D, H, W, C)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-6)
    assert (ref != 0).mean() > 0.05


@pytest.mark.parametrize("H,W,D", ROW_SHAPES)
@pytest.mark.parametrize("C", [6, 64])
def test_plain_k4_bfloat16_at_row_tiles_matches_jax_kernel(rng, H, W, D, C):
    src, *rest = _row_setup(rng, H, W, D, C)
    ref = np.asarray(homo_warp_pallas(jnp.asarray(src).astype(jnp.bfloat16), *(jnp.asarray(a) for a in rest)))
    ours = homo_warp_volume(t(src).bfloat16(), *(t(a) for a in rest))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    assert (ref != 0).mean() > 0.05


def test_k4_one_pixel_wide_map_raises_as_jax(rng):
    """W = 1 has no align_corners scale (W / (W - 1)): JAX's ``homo_warp``
    and ``homo_warp_pallas`` raise ZeroDivisionError, and so does the port
    before any kernel could launch."""
    args = _row_setup(rng, 4, 1, 2, 8)
    for fn in (jax_homo_warp, homo_warp_pallas):
        with pytest.raises(ZeroDivisionError):
            fn(*(jnp.asarray(a) for a in args))
    with pytest.raises(ZeroDivisionError):
        homo_warp_volume(*(t(a) for a in args))


@pytest.mark.parametrize("case", CASES)
def test_plain_k4_float32_matches_jax_homo_warp(rng, case):
    args = _setup(rng, case, B=2)
    ours = homo_warp_volume(*(t(a) for a in args))
    ref = np.asarray(jax_homo_warp(*(jnp.asarray(a) for a in args)))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-6)
    assert (ref != 0).mean() > 0.05  # not vacuous: samples land on the map
    if case == "out_of_image":
        assert (ref == 0).mean() > 0.2 and np.array_equal(ours.numpy() == 0, ref == 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_k4_bfloat16_matches_jax_kernel(rng, case):
    src, *rest = _setup(rng, case)
    srcb = jnp.asarray(src).astype(jnp.bfloat16)
    ref = np.asarray(homo_warp_pallas(srcb, *(jnp.asarray(a) for a in rest)))
    ours = homo_warp_volume(t(src).bfloat16(), *(t(a) for a in rest))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    # bf16 features: the taps of the rounded map, weighted in float32
    np.testing.assert_array_equal(ours.numpy(), homo_warp_volume(t(src).bfloat16().float(), *(t(a) for a in rest)))


def test_homo_warp_is_the_wrapper_on_the_cpu(rng):
    """On CPU tensors the wrapper is the plain version, ``homo_warp``."""
    args = [t(a) for a in _setup(rng, "pose", B=2)]
    before = homo_warp_volume.launches
    ours = homo_warp_volume(*args).numpy()
    assert homo_warp_volume.launches == before
    np.testing.assert_array_equal(ours, homo_warp(*args).numpy())
    np.testing.assert_array_equal(ours, homo_warp_volume_reference(*args).numpy())


def test_plain_k4_sends_nonfinite_coordinates_off_the_map(rng):
    """A plane at depth 0 through a projection without translation gives
    0/0 coordinates: zeros, as K2 and the kernel make them."""
    src, proj, inv, _ = _setup(rng, "pose")
    proj[:, :3, 3] = 0.0
    out = homo_warp_volume(t(src), t(proj), t(inv), t(np.array([[0.0, 2.0]], np.float32)))
    assert torch.isfinite(out).all()
    assert (out[:, 0] == 0).all() and (out[:, 1] != 0).any()


@pytest.mark.parametrize("bad", ["feat_dim", "depth_dim", "dtype"])
def test_k4_rejects_bad_inputs(rng, bad):
    src, proj, inv, depths = (t(a) for a in _setup(rng, "pose"))
    if bad == "feat_dim":
        src = src[0]
    elif bad == "depth_dim":
        depths = depths[0]
    else:
        src = src.double()
    with pytest.raises((ValueError, TypeError)):
        homo_warp_volume(src, proj, inv, depths)
