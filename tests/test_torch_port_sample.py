"""Port parity: K1, the plane-sweep score sampler.

The plain version (robustmvd_tpu_torch/ops/kernels/planesweep_sample.py),
which the wrapper runs for CPU tensors and which the CUDA kernel is held
against on the card, vs the TPU kernels run as the JAX package's tests run
them on the CPU (Pallas interpret mode):
- f32 scores vs ``planesweep_sample`` (v1): atol 1e-5 (sum order only);
- bf16 scores vs ``planesweep_sample_v2``: atol 1e-2 x max|scores|, the
  rounding of bf16 scores and row weights that both apply, where the order
  of the f32 sums may differ.
The CUDA kernel itself is tested on the card in test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robustmvd_tpu.ops.pallas.planesweep_sample import planesweep_sample as jax_v1
from robustmvd_tpu.ops.pallas.planesweep_sample_v2 import planesweep_sample_v2 as jax_v2
from robustmvd_tpu_torch.ops.kernels.planesweep_sample import (
    planesweep_sample,
    planesweep_sample_reference,
)

from torch_port_helpers import t

P, HS, WS, S = 40, 6, 8, 16


def _taps(seed):
    """Scores and taps with in-range, partly out-of-range, negative and
    +-1e9 (non-finite sentinel) indices."""
    rng = np.random.RandomState(seed)
    corr = rng.randn(P, HS, WS).astype(np.float32)
    y0 = rng.randint(-3, HS + 2, size=(P, S)).astype(np.int32)
    x0 = rng.randint(-3, WS + 2, size=(P, S)).astype(np.int32)
    y0[0, :4] = [-1, HS - 1, int(1e9), -int(1e9)]
    x0[1, :4] = [-1, WS - 1, int(1e9), -int(1e9)]
    y0[2, :2] = x0[2, :2] = int(1e9)
    wy = rng.rand(P, S).astype(np.float32)
    wx = rng.rand(P, S).astype(np.float32)
    return corr, y0, wy, x0, wx


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_matches_v1(seed):
    corr, y0, wy, x0, wx = _taps(seed)
    ref = np.asarray(jax_v1(*(jnp.asarray(a) for a in (corr, y0, wy, x0, wx))))
    ours = planesweep_sample_reference(t(corr), t(y0), t(wy), t(x0), t(wx)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    # the taps at +-1e9 and fully outside the image contribute exactly 0
    assert ours[2, 0] == ref[2, 0] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_bf16_matches_v2(seed):
    corr, y0, wy, x0, wx = _taps(seed)
    ref = np.asarray(jax_v2(*(jnp.asarray(a) for a in (corr, y0, wy, x0, wx))))
    ours = planesweep_sample_reference(t(corr).bfloat16(), t(y0), t(wy), t(x0), t(wx)).numpy()
    atol = 1e-2 * np.abs(corr).max()
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)
    # and it is the bf16 function, not the f32 one: v2's rounding of the
    # row weights shows up against the f32 result
    f32 = planesweep_sample_reference(t(corr), t(y0), t(wy), t(x0), t(wx)).numpy()
    assert np.abs(ours - ref).max() < np.abs(f32 - ref).max()


def test_wrapper_runs_plain_version_on_cpu():
    corr, y0, wy, x0, wx = _taps(3)
    before = planesweep_sample.launches
    out = planesweep_sample(t(corr), t(y0), t(wy), t(x0), t(wx))
    assert planesweep_sample.launches == before  # no kernel launched
    assert out.dtype == torch.float32 and out.shape == (P, S)
    np.testing.assert_array_equal(
        out.numpy(), planesweep_sample_reference(t(corr), t(y0), t(wy), t(x0), t(wx)).numpy()
    )


@pytest.mark.parametrize("bad", ["corr_dtype", "tap_dtype", "shape", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    corr, y0, wy, x0, wx = (t(a) for a in _taps(4))
    if bad == "corr_dtype":
        corr = corr.double()
    elif bad == "tap_dtype":
        y0 = y0.long()
    elif bad == "shape":
        wx = wx[:, :-1]
    else:
        corr = corr.reshape(P, HS * WS)
    with pytest.raises((TypeError, ValueError)):
        planesweep_sample(corr, y0, wy, x0, wx)
