"""Port parity: epipolar coefficients, hypotheses and sampling points

(robustmvd_tpu_torch/ops/epipolar.py vs robustmvd_tpu/ops/epipolar.py).
Same op order and true division, so float32 agreement is within 1e-6
relative; visibility masks must be equal."""

import numpy as np
import pytest

import jax.numpy as jnp

from robustmvd_tpu.ops import epipolar as jep
from robustmvd_tpu_torch.ops import epipolar as tep

from torch_port_helpers import K_REL, random_pose, t


def _problem(seed):
    rng = np.random.RandomState(seed)
    B = 2
    K_key = np.stack([K_REL, K_REL * np.float32(1.05)]).astype(np.float32)
    K_key[:, 2] = [0, 0, 1]
    K_src = (K_key + rng.randn(B, 3, 3).astype(np.float32) * 0.01 * np.array([[1, 0, 1], [0, 1, 1], [0, 0, 0]], np.float32)).astype(np.float32)
    T = np.stack([random_pose(rng) for _ in range(B)])
    return K_key, K_src, T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coeffs_and_points_match_jax(seed):
    K_key, K_src, T = _problem(seed)
    H, W, Hs, Ws = 6, 8, 5, 9
    jc = jep.make_epipolar_coeffs(jnp.asarray(K_key), jnp.asarray(K_src), jnp.asarray(T), H, W, Hs, Ws)
    tc = tep.make_epipolar_coeffs(t(K_key), t(K_src), t(T), H, W, Hs, Ws)
    np.testing.assert_allclose(tc.m.numpy(), np.asarray(jc.m), rtol=1e-6)
    uvk_ref = np.asarray(jc.uvk_inf)
    # rtol on every element; the atol only covers entries that cancel to ~0
    np.testing.assert_allclose(tc.uvk_inf.numpy(), uvk_ref, rtol=1e-6, atol=1e-6 * np.abs(uvk_ref).max())

    invd = np.asarray(jep.sampling_invdepths(0.4, 1000.0, 32))
    jus, jvs, jmask = jep.planesweep_points(jc, jnp.asarray(np.repeat(invd, 2, 0)))
    tus, tvs, tmask = tep.planesweep_points(tc, t(np.repeat(invd, 2, 0)))
    for ours, ref in ((tus, jus), (tvs, jvs)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6 * np.median(np.abs(ref)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_points_replace_nonfinite():
    """A key pixel whose ray is parallel to the source image plane gives
    +-inf / NaN coordinates; both packages replace them with +-1e9."""
    K = K_REL[None]
    T = np.eye(4, dtype=np.float32)[None]
    jc = jep.make_epipolar_coeffs(jnp.asarray(K), jnp.asarray(K), jnp.asarray(T), 4, 4)
    tc = tep.make_epipolar_coeffs(t(K), t(K), t(T), 4, 4)
    uvk = np.asarray(jc.uvk_inf).copy()
    uvk[0, 1, 2, 2] = 0.0  # k_h = 0 at d = 0: u, v = +-inf
    uvk[0, 2, 1] = 0.0  # 0 / 0 at d = 0: NaN
    jc = jep.EpipolarCoeffs(jnp.asarray(uvk), jc.m)
    tc = tep.EpipolarCoeffs(t(uvk), tc.m)
    invd = np.array([[0.0, 0.5]], np.float32)
    for ours, ref in zip(tep.planesweep_points(tc, t(invd)), jep.planesweep_points(jc, jnp.asarray(invd))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    us = tep.planesweep_points(tc, t(invd))[0].numpy()
    assert us[0, 0, 1, 2] == 1e9 and us[0, 0, 2, 1] == 1e9


@pytest.mark.parametrize("sampling_type,lo,hi,S", [
    ("linear_invdepth", 0.4, 1000.0, 256),
    ("linear_invdepth", 0.5, 100.0, 32),
    ("linear_depth", 2.0, 10.0, 5),
])
def test_sampling_invdepths_match_jax(sampling_type, lo, hi, S):
    ref = np.asarray(jep.sampling_invdepths(lo, hi, S, sampling_type))
    ours = tep.sampling_invdepths(lo, hi, S, sampling_type).numpy()
    assert ours.shape == ref.shape == (1, S)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
