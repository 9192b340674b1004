"""K3 (fused soft-argmin readout): the port's plain version vs JAX.

On the CPU the port's ``fused_soft_argmin`` runs its plain torch version.
The same numpy volumes go through the JAX TPU kernel in interpret mode
(``ops/pallas/softargmin.py::fused_soft_argmin``) and its jnp reference
(``fused_soft_argmin_reference``). Bounds: prob, expectation and entropy
atol 1e-5 (softmax and sums over D in another order), the expectation also
rtol 1e-6: it reaches D - 1, where float32's spacing is up to 1.5e-5, so
sums in another order differ by more than 1e-5 there; the window mass may
differ by more than 1e-5 on at most 1% of the pixels, where the expectation
lies within rounding of a window edge and the mask flips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustmvd_tpu.ops.pallas.softargmin import fused_soft_argmin as jax_fused_soft_argmin
from robustmvd_tpu.ops.pallas.softargmin import fused_soft_argmin_reference as jax_reference
from robustmvd_tpu_torch.ops.kernels import soft_argmin as k3

from torch_port_helpers import t


def _check(ours, ref):
    names = ("prob", "expectation", "entropy", "prob_map")
    for name, a, b, rtol in zip(names[:3], ours[:3], ref[:3], (0, 1e-6, 0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=rtol, err_msg=name)
    off = np.abs(ours[3].numpy() - np.asarray(ref[3])) > 1e-5
    assert off.mean() <= 0.01, off.mean()


# HW = 35 and 7 * 13 = 91: no multiple of the TPU kernel's 128- or 512-lane tile
@pytest.mark.parametrize("D,B,H,W", [(16, 2, 5, 7), (32, 1, 7, 13), (64, 2, 7, 13), (192, 1, 5, 7)])
@pytest.mark.parametrize("window", [1, 2])
def test_soft_argmin_matches_jax(rng, D, B, H, W, window):
    vol = (rng.randn(B, D, H, W) * 3).astype(np.float32)
    before = k3.fused_soft_argmin.launches
    ours = k3.fused_soft_argmin(t(vol), window=window)
    assert k3.fused_soft_argmin.launches == before  # the CPU runs the plain version
    assert [tuple(o.shape) for o in ours] == [(B, D, H, W)] + [(B, 1, H, W)] * 3
    _check(ours, jax_fused_soft_argmin(jnp.asarray(vol), window=window, tile=128, interpret=True))
    _check(ours, jax_reference(jnp.asarray(vol), window=window))


# D on each side of the CUDA kernel's register route (D in 16, 32, 64), at
# HW = 33: no multiple of 2 (its pixel pairs) or 4
@pytest.mark.parametrize("D", [8, 48, 96, 256])
@pytest.mark.parametrize("window", [1, 2])
def test_soft_argmin_off_the_register_route_matches_jax(rng, D, window):
    vol = (rng.randn(2, D, 3, 11) * 3).astype(np.float32)
    ours = k3.fused_soft_argmin(t(vol), window=window)
    assert [tuple(o.shape) for o in ours] == [(2, D, 3, 11)] + [(2, 1, 3, 11)] * 3
    _check(ours, jax_fused_soft_argmin(jnp.asarray(vol), window=window, tile=128, interpret=True))
    _check(ours, jax_reference(jnp.asarray(vol), window=window))


def test_soft_argmin_peaked_and_flat_columns(rng):
    """A one-hot column (entropy 0, all the mass in the window) and a flat
    one (entropy log D, expectation (D - 1) / 2)."""
    D = 16
    vol = np.zeros((1, D, 1, 2), np.float32)
    vol[0, 5, 0, 0] = 200.0
    prob, expectation, entropy, mass = k3.fused_soft_argmin(t(vol), window=2)
    np.testing.assert_allclose(expectation.numpy()[0, 0, 0], [5.0, (D - 1) / 2], atol=1e-5)
    np.testing.assert_allclose(entropy.numpy()[0, 0, 0], [0.0, np.log(D)], atol=1e-5)
    np.testing.assert_allclose(mass.numpy()[0, 0, 0], [1.0, 4 / D], atol=1e-6)  # |i - 7.5| <= 2: i = 6..9
    np.testing.assert_allclose(prob.numpy().sum(1), 1.0, atol=1e-6)


def test_soft_argmin_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        k3.fused_soft_argmin(torch.zeros(1, 4, 2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        k3.fused_soft_argmin(torch.zeros(4, 2, 2))
