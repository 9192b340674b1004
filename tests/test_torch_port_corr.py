"""Port parity: the plane-sweep correlation

(robustmvd_tpu_torch/ops/corr.py vs robustmvd_tpu/ops/corr.py).

- vs JAX ``impl="matmul"`` and ``impl="pallas"`` (the port's route: score
  matmul, bilinear sampling of the scores, ``_finish_corr`` masks): corr
  within rtol = atol = 1e-5 (fp32 sum order of the score product). Masks
  must agree; at most 0.01% may flip on an exact pixel boundary, where a
  1-ulp coordinate difference moves ``floor()``, and any flip is listed.
- vs the JAX default ``impl="pixelscan"``: corr within 5e-3 x max|corr|,
  the documented epipole tolerance of that formulation
  (robustmvd_tpu/models/robust_mvd.py:85-88).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from robustmvd_tpu.ops.corr import planesweep_correlation as jax_corr
from robustmvd_tpu_torch.ops.corr import planesweep_correlation

from torch_port_helpers import K_REL, random_pose, t

B, V, H, W, C, S = 1, 2, 6, 8, 16, 32


@pytest.fixture(scope="module", params=[0, 1])
def problem(request):
    rng = np.random.RandomState(request.param)
    feat_key = rng.randn(B, H, W, C).astype(np.float32)
    feat_src = rng.randn(B, V, H, W, C).astype(np.float32)
    K = np.tile(K_REL, (B, 1, 1))
    Ks = np.tile(K[:, None], (1, V, 1, 1))
    Ts = np.stack([np.stack([random_pose(rng) for _ in range(V)]) for _ in range(B)])
    args = (feat_key, feat_src, K, Ks, Ts)
    kw = dict(num_sampling_points=S, min_depth=0.5, max_depth=100.0)
    corr, mask, invd = planesweep_correlation(*(t(a) for a in args), **kw)
    return args, kw, corr.numpy(), mask.numpy(), invd.numpy()


def _jax(problem, impl):
    args, kw = problem[:2]
    corr, mask, invd = jax_corr(*(jnp.asarray(a) for a in args), impl=impl, **kw)
    return np.asarray(corr), np.asarray(mask), np.asarray(invd)


@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_corr_matches_jax_matmul_route(problem, impl):
    _, _, corr, mask, invd = problem
    jcorr, jmask, jinvd = _jax(problem, impl)
    assert corr.shape == jcorr.shape == (B, V, H, W, S)
    np.testing.assert_allclose(invd, jinvd, rtol=1e-6)
    flips = np.argwhere(mask != jmask)
    assert len(flips) <= 1e-4 * mask.size, f"mask flips at (b, v, y, x, s): {flips.tolist()}"
    same = mask == jmask
    np.testing.assert_allclose(corr[same], jcorr[same], rtol=1e-5, atol=1e-5)
    assert mask.mean() > 0.05  # the comparison is not vacuous


def test_corr_matches_jax_pixelscan(problem):
    _, _, corr, mask, _ = problem
    jcorr, jmask, _ = _jax(problem, "pixelscan")
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(corr, jcorr, rtol=0, atol=5e-3 * np.abs(jcorr).max())


def test_single_source_view_and_explicit_invdepths(problem):
    """One source view with explicit hypotheses gives that view's slice."""
    (feat_key, feat_src, K, Ks, Ts), _, corr, mask, invd = problem
    c1, m1, i1 = planesweep_correlation(
        t(feat_key), t(feat_src[:, 1:]), t(K), None, t(Ts[:, 1:]), invdepths=t(invd)
    )
    np.testing.assert_array_equal(i1.numpy(), invd)
    np.testing.assert_array_equal(m1.numpy()[:, 0], mask[:, 1])
    np.testing.assert_allclose(c1.numpy()[:, 0], corr[:, 1], rtol=1e-6, atol=1e-6)
