"""K5's bf16 form: the card kernel's arithmetic order, rehearsed on the CPU.

``csrc/conv3d_banded.cu::conv3d_banded_bf16`` cannot run here (no card, no
nvcc), so its order of operations is written out in plain torch
(:func:`_k5_bf16_emulated`) and held, on the same bf16 inputs, against the
port's plain version (``conv3d_banded_reference``, what the wrapper runs on
the CPU and what the card tests hold the kernel to) and against the JAX TPU
kernel ``conv3d_banded_pallas`` in interpret mode. The order:
- operands rounded to bf16 (the kernel cast once to bf16, as the TPU kernel
  casts its band matrix);
- Cin in chunks of 8 channels, zeros beyond Cin;
- in a chunk, the 27 taps ordered (dy, dx, dz) and paired into the k16 of
  14 mma (the last with a zero half); each mma a float32 product of 16
  values, the 14 summed in order into the chunk's float32 partial;
- the partials added with round-to-nearest float32 adds in chunk order; for
  Cout > 16 the kernel splits K across two warp groups (chunks 0, 2, 4, ...
  and 1, 3, 5, ...), each summing its own chunks, group 1's sum added to
  group 0's at the tile's end;
- the float32 bias added, one rounding to bf16.
The mma's own internal float32 additions (not rounded to nearest) are not
modelled. Tolerance, as the card tests and ``chip_smoke.py`` hold the
kernel: max |d| <= 2^-7 max |ref| (one bf16 step at the largest magnitude:
2^-8 for the rounding, 2^-8 for a sum on the other side of a rounding
boundary), on at most 2% of the values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robustmvd_tpu.ops.pallas.conv3d import conv3d_banded_pallas
from robustmvd_tpu_torch.ops.kernels import conv3d as conv3d_kernels
from robustmvd_tpu_torch.ops.kernels.conv3d import conv3d_banded, conv3d_banded_reference

from torch_port_helpers import t

BF16 = torch.bfloat16
LIMIT, FLIP_SHARE = 2.0**-7, 0.02
# slot s of a chunk is tap (dz, dy, dx) = (s % 3, s // 9, s // 3 % 3): (dy, dx, dz), dz fastest
TAPS = [(dz, dy, dx) for dy in range(3) for dx in range(3) for dz in range(3)]


def _k_groups(cout):
    """The warp groups the kernel splits K across: two on the tile for Cout
    > 16 (``bf::launch_mma``: ``Tile<8, 2, 1, 2, 2, 2>``), else one."""
    return 2 if cout > 16 else 1


def _k5_bf16_emulated(x, kernel, bias=None):
    """K5 bf16's arithmetic in the kernel's order (the module docstring), on
    NDHWC ``x`` and a DHWIO ``kernel``; returns bf16."""
    B, D, H, W, C = x.shape
    cout, pad = kernel.shape[4], -C % 8
    xp = F.pad(x.to(BF16).float(), (0, pad, 1, 1, 1, 1, 1, 1))
    k = F.pad(kernel.to(BF16).float(), (0, 0, 0, pad))
    sums = [torch.zeros((B, D, H, W, cout)) for _ in range(_k_groups(cout))]
    for c in range((C + pad) // 8):
        ch = slice(8 * c, 8 * c + 8)
        part = torch.zeros((B, D, H, W, cout))
        for step in range(14):  # taps 2 step and 2 step + 1: a k16 of 8 channels each; step 13 has one
            pair = TAPS[2 * step : 2 * step + 2]
            a = torch.cat([xp[:, dz : dz + D, dy : dy + H, dx : dx + W, ch] for dz, dy, dx in pair], -1)
            b = torch.cat([k[dz, dy, dx, ch] for dz, dy, dx in pair], 0)
            part = part + a @ b
        sums[c % len(sums)] = sums[c % len(sums)] + part
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    if bias is not None:
        out = out + bias.float()
    return out.to(BF16)


def _close(ours, ref):
    ours, ref = ours.float(), ref.float()
    diff = (ours - ref).abs()
    assert diff.max() <= LIMIT * ref.abs().max(), (float(diff.max()), float(ref.abs().max()))
    assert (diff > 0).float().mean() <= FLIP_SHARE, float((diff > 0).float().mean())


def test_tap_pairs_cover_every_tap_once():
    """The 14 k16 steps hold the 27 taps once each, the last step half."""
    steps = [TAPS[2 * s : 2 * s + 2] for s in range(14)]
    assert sorted(tap for step in steps for tap in step) == sorted(
        (dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3))
    assert [len(step) for step in steps] == [2] * 13 + [1]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cin,cout", [(8, 8), (16, 8), (16, 16), (32, 32), (64, 64)], ids=lambda v: str(v))
def test_k5_bf16_order_matches_plain_version_and_jax(rng, cin, cout, with_bias):
    """The kernel's order against the plain version (with and without a
    bias) and the JAX kernel (without) on the same bf16 inputs, a
    (1, 4, 5, 13) volume: W = 13 is not a multiple of 8."""
    x = rng.randn(1, 4, 5, 13, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32) if with_bias else None
    xb = t(x).to(BF16)
    ours = _k5_bf16_emulated(xb, t(k), None if bias is None else t(bias))
    assert ours.dtype == BF16
    plain = conv3d_banded_reference(xb, t(k), None if bias is None else t(bias))
    _close(ours, plain)
    assert torch.equal(conv3d_banded(xb, t(k), None if bias is None else t(bias)), plain)  # the wrapper on the CPU
    if bias is None:  # the TPU kernel takes no bias (the JAX blocks add it after the conv, rounded again)
        ref = conv3d_banded_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), interpret=True)
        _close(ours, torch.from_numpy(np.asarray(ref, np.float32)))


def test_k5_bf16_order_keeps_cin_beyond_chunks_zero(rng):
    """A Cin that is not a multiple of 8 (12): the chunk's missing channels
    are zeros in both operands, so the order still matches the plain
    version."""
    x = t(rng.randn(1, 3, 4, 9, 12).astype(np.float32)).to(BF16)
    k = t((rng.randn(3, 3, 3, 12, 16) / np.sqrt(27 * 12)).astype(np.float32))
    _close(_k5_bf16_emulated(x, k), conv3d_banded_reference(x, k))


def test_bf16_weight_layout_is_kept_while_the_weight_is_unchanged():
    """The wrapper keeps nothing between calls: a kernel already in the bf16
    form's layout (Cin a multiple of 8) is read as it is, any other is laid
    out anew on each call, so an update of the weight, also one through
    ``.data`` that leaves its version alone, is seen. The layout is the bf16
    rounding of the weight by (dz, dy, dx, o, i), Cin padded with zeros to a
    multiple of 8."""
    weight = torch.nn.Parameter(torch.randn(8, 12, 3, 3, 3))
    first = conv3d_kernels._bf16_weights(weight.permute(2, 3, 4, 1, 0))
    assert first.shape == (3, 3, 3, 12, 8) and first.stride()[3:] == (1, 16)
    assert torch.equal(first, weight.permute(2, 3, 4, 1, 0).to(BF16))
    assert not first._base.permute(0, 1, 2, 4, 3)[:, :, :, 12:].any()
    # padded: the wrapper cannot vouch for the padding of a view, so it lays it out again
    assert conv3d_kernels._bf16_weights(first) is not first
    laid = conv3d_kernels.conv3d_banded_bf16_weights(torch.randn(3, 3, 3, 16, 8))
    assert conv3d_kernels._bf16_weights(laid) is laid
    with torch.no_grad():
        weight.mul_(2)
    assert torch.equal(conv3d_kernels._bf16_weights(weight.permute(2, 3, 4, 1, 0)), first.float().mul(2).to(BF16))
    weight.data.copy_(torch.ones(8, 12, 3, 3, 3))
    assert (conv3d_kernels._bf16_weights(weight.permute(2, 3, 4, 1, 0)) == 1).all()
