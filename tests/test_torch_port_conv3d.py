"""K5 (3x3x3 stride-1 convolution) in the port vs the JAX package.

The port's plain version (``conv3d_banded_reference``, what the wrapper runs
on the CPU) takes the same numpy inputs as the JAX TPU kernel
``conv3d_banded_pallas`` (interpret mode on the CPU, as
``tests/test_conv3d_pallas.py`` runs it) and ``lax.conv_general_dilated``,
over that test's cases, with and without a bias added after the sum:
rtol = atol = 2e-5 (float32 sums over 27 * Cin taps in another order).
The NCDHW module (``ops/conv3d.py::Conv3d``, the family's layout) is held
against the NDHWC function and against ``nn.Conv3d`` at 1e-5.

The card computes K5 (Cout > 4) on TF32 tensor cores with the 3xTF32 split
(``csrc/conv3d_banded.cu``), which no CPU can run; its arithmetic is
rehearsed here in plain torch (:func:`_tf32x3_conv`, summing in the
kernel's order) and held against the plain version at 2e-5, chip_smoke.py's
K5 limit. These cases bound the arithmetic, not the kernel: they run no
kernel code, and the kernel itself is held against the plain version by
``tests/test_torch_port_cuda.py`` on the card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from robustmvd_tpu.ops.pallas.conv3d import conv3d_banded_pallas
from robustmvd_tpu_torch.ops.conv3d import CONV3D_IMPLS, Conv3d, conv3d_impl_of
from robustmvd_tpu_torch.ops.kernels.conv3d import conv3d_banded, conv3d_banded_reference

from torch_port_helpers import t

CASES = [  # (D, H, W, Cin, Cout, tile, block_d) of tests/test_conv3d_pallas.py
    (8, 6, 10, 8, 8, 4, 4),
    (5, 4, 7, 8, 1, 4, 4),
    (8, 6, 10, 32, 8, 2, 8),
    (4, 4, 5, 16, 16, 3, 2),
    (8, 6, 12, 8, 8, None, 8),
]


def _oracle(x, k):
    return jax.lax.conv_general_dilated(x, k, (1, 1, 1), ((1, 1),) * 3, dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_plain_k5_matches_jax_kernel_and_lax_conv(rng, case, with_bias):
    D, H, W, C, Co, tile, bd = case
    x = rng.randn(2, D, H, W, C).astype(np.float32)
    k = (rng.randn(3, 3, 3, C, Co) * 0.1).astype(np.float32)
    bias = rng.randn(Co).astype(np.float32) if with_bias else None
    want = np.asarray(_oracle(jnp.asarray(x), jnp.asarray(k)))
    kernel_out = np.asarray(conv3d_banded_pallas(jnp.asarray(x), jnp.asarray(k), tile, bd))
    if with_bias:  # the JAX blocks add the bias after the conv
        want, kernel_out = want + bias, kernel_out + bias
    ours = conv3d_banded(t(x), t(k), None if bias is None else t(bias)).numpy()
    assert ours.shape == want.shape == (2, D, H, W, Co)
    np.testing.assert_allclose(ours, kernel_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ours, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(ours, conv3d_banded_reference(t(x), t(k), None if bias is None else t(bias)))


@pytest.mark.parametrize("cin,cout", [(8, 5), (16, 1)])  # 16 -> 1: a score head
@pytest.mark.parametrize("bias", [False, True])
def test_module_on_ncdhw_matches_the_function_and_nn_conv3d(rng, cin, cout, bias):
    """The family blocks' NCDHW module: K5 through strides (no permute in
    the kernel), the same numbers as the NDHWC function and as cuDNN's
    ``nn.Conv3d`` with the same parameters."""
    torch.manual_seed(0)
    conv = Conv3d(cin, cout, bias=bias, impl="banded")
    plain = nn.Conv3d(cin, cout, 3, padding=1, bias=bias)
    plain.load_state_dict(conv.state_dict())
    x = t(rng.randn(2, cin, 6, 7, 9).astype(np.float32))
    with torch.no_grad():
        out = conv(x)
        ndhwc = conv3d_banded(x.movedim(1, -1), conv.weight.permute(2, 3, 4, 1, 0), conv.bias)
        lib = plain(x)
    assert out.shape == (2, cout, 6, 7, 9) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ndhwc.movedim(-1, 1).numpy())
    np.testing.assert_allclose(out.numpy(), lib.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", CONV3D_IMPLS)
@pytest.mark.parametrize("bias", [False, True])
def test_module_parameters_are_nn_conv3d(impl, bias):
    """``state_dict`` keys and shapes are nn.Conv3d's, so the weight bridge
    is the same for every lowering."""
    conv = Conv3d(4, 6, bias=bias, impl=impl)
    ref = nn.Conv3d(4, 6, 3, padding=1, bias=bias)
    assert {k: v.shape for k, v in conv.state_dict().items()} == {k: v.shape for k, v in ref.state_dict().items()}
    assert isinstance(conv, nn.Conv3d) and conv.impl == impl


def test_module_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown conv3d impl"):
        Conv3d(4, 4, impl="winograd")
    with pytest.raises(ValueError, match="unknown conv3d impl"):
        Conv3d(4, 4, impl="packed")  # a JAX name: create_model maps it


@pytest.mark.parametrize("name,impl", [("banded", "banded"), ("packed", "banded"), ("xla", "xla"), ("dz2d", "xla")])
def test_jax_conv3d_impl_names_map_to_the_two_lowerings(name, impl):
    """The JAX package's four names are two lowerings here: the packed dot
    is K5's, dz2d is the plain conv."""
    assert conv3d_impl_of(name) == impl
    with pytest.raises(ValueError, match="unknown conv3d impl"):
        conv3d_impl_of(name.upper())


def test_k5_gradients_match_lax_conv(rng):
    """The plain version differentiates like the JAX VJP (the XLA conv)."""
    x = rng.randn(1, 4, 4, 6, 8).astype(np.float32)
    k = (rng.randn(3, 3, 3, 8, 8) * 0.1).astype(np.float32)
    gx0, gk0 = jax.grad(lambda xx, kk: jnp.sum(_oracle(xx, kk) ** 2), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, kt = t(x).requires_grad_(), t(k).requires_grad_()
    (conv3d_banded(xt, kt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk0), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("x_shape,k_shape,b_shape", [
    ((2, 4, 4, 4), (3, 3, 3, 4, 2), None),  # 4D input
    ((1, 4, 4, 4, 3), (3, 3, 3, 4, 2), None),  # Cin mismatch
    ((1, 4, 4, 4, 4), (1, 3, 3, 4, 2), None),  # not 3x3x3
    ((1, 4, 4, 4, 4), (3, 3, 3, 4, 2), (3,)),  # bias size
])
def test_k5_rejects_bad_shapes(x_shape, k_shape, b_shape):
    with pytest.raises(ValueError):
        conv3d_banded(torch.zeros(x_shape), torch.zeros(k_shape), None if b_shape is None else torch.zeros(b_shape))


def _tf32(v):
    """``cvt.rna.tf32.f32`` on finite float32 values: 10 mantissa bits,
    ties away from zero, as float32."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32x3_conv(x, kernel, bias=None, passes=3):
    """K5's tensor-core arithmetic in plain torch, on NDHWC ``x`` and a DHWIO
    ``kernel``, in the kernel's order: for each 8-channel chunk (the k of
    one mma) and each dy, a partial over (dx, dz) of the products
    lo*hi + hi*lo + hi*hi of the split operands (hi = rna(v),
    lo = rna(v - hi); lo*lo dropped), or hi*hi alone with ``passes=1``
    (single-pass TF32), then added to the float32 sum. The tensor cores'
    truncating adds inside an mma are not modelled (an 8-channel product is
    a float32 matmul here)."""
    B, D, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.zeros((B, D, H, W, kernel.shape[4]))
    for c0, dy in itertools.product(range(0, C, 8), range(3)):
        part = torch.zeros_like(out)
        for dx, dz in itertools.product(range(3), repeat=2):
            a = xp[:, dz : dz + D, dy : dy + H, dx : dx + W, c0 : c0 + 8]
            b = kernel[dz, dy, dx, c0 : c0 + 8]
            a_hi, b_hi = _tf32(a), _tf32(b)
            a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
            terms = [a_lo @ b_hi, a_hi @ b_lo, a_hi @ b_hi] if passes == 3 else [a_hi @ b_hi]
            for term in terms:
                part = part + term
        out = out + part
    return out if bias is None else out + bias


def _unit_inputs(rng, cin, cout, shape=(1, 4, 5, 13)):
    """Unit-scale NDHWC input and a DHWIO kernel scaled by 1 / sqrt(27 Cin),
    as chip_smoke.py makes them; W = 13 is not a multiple of 8."""
    x = rng.randn(*shape, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    return t(x), t(k)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The emulated cvt.rna.tf32.f32 against a float64 rounding of the
    significand to 11 bits, on random values and on ties."""
    rng = np.random.RandomState(0)
    v = np.concatenate([rng.randn(10000) * 10.0 ** rng.randint(-6, 6, 10000),
                        [1 + 2.0**-11, 1 + 3 * 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12, 0.0]]).astype(np.float32)
    mant, exp = np.frexp(v.astype(np.float64))  # |mant| in [0.5, 1): 11 significant bits are mant * 2^11
    scaled = np.abs(mant) * 2.0**11
    want = np.sign(mant) * np.floor(scaled + 0.5) * 2.0 ** (exp - 11)
    np.testing.assert_array_equal(_tf32(t(v)).numpy(), want.astype(np.float32))
    assert _tf32(t(np.float32([1 + 2.0**-11]))).item() == 1 + 2.0**-10  # a tie goes away from zero


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cin,cout", [  # the channel pairs of chip_smoke.py's K5_CASES
    (16, 16), (32, 32), (64, 64),
    # mvsnet's prob head: the card runs Cout 1 on the CUDA cores, so this
    # case only bounds what the split would give at its Cin
    (8, 1),
    (8, 8), (16, 8),
], ids=lambda v: str(v))
def test_tf32x3_arithmetic_matches_plain_k5(rng, cin, cout, with_bias):
    x, k = _unit_inputs(rng, cin, cout)
    bias = t(rng.randn(cout).astype(np.float32)) if with_bias else None
    ours = _tf32x3_conv(x, k, bias)
    plain = conv3d_banded_reference(x, k, bias)
    assert ours.shape == plain.shape == (1, 4, 5, 13, cout)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=0, atol=2e-5)


def test_single_pass_tf32_misses_the_k5_limit():
    """Why three passes: one TF32 product per float32 product keeps ~11 bits
    of each operand and misses 2e-5 at Cin = 64 (by ~60x), where 3xTF32
    keeps inside it."""
    x, k = _unit_inputs(np.random.RandomState(5), 64, 64)
    plain = conv3d_banded_reference(x, k)
    one = float((_tf32x3_conv(x, k, passes=1) - plain).abs().max())
    three = float((_tf32x3_conv(x, k) - plain).abs().max())
    assert one > 2e-5 > three, (one, three)
