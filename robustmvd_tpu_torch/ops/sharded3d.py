"""The MVSNet family's 3D layers on a slab of hypotheses: D sharded over the
mesh's hyp axis.

JAX shards the family's cost volumes over the hyp axis with a GSPMD
annotation (``constrain(volume, "data", "hyp")``, e.g.
``robustmvd_tpu/models/mvsnet.py:219``), and XLA partitions the 3D U-Nets
over D with halo exchanges. Torch has no partitioner: this module writes
that partition out. Under a mesh with a hyp axis (``parallel/context.py``)
every (B, C, D, h, w) volume of the family's regularisers is held as each
rank's contiguous share of its D planes (``share(D, hyp)``), and every 3D
layer takes the rank's share of its input, with the input's global D
(``total``), and returns the rank's share of its output, ``share(D_out,
hyp)``: the shares of each level follow from its own D, not from halving
the level above, so no D need divide by the axis' size or a power of 2.

Each layer works out the input planes its output share reads (its window,
clipped to the volume), fetches the planes beyond its own share from the
ranks that hold them (``parallel/collectives.py::fetch_window``), runs the
layer's own convolution on the window and keeps its share:

- stride-1 3x3x3 pad-1 (``ops/conv3d.py::Conv3d``, K5 or cuDNN):
  :func:`conv3d_same`. The window is the share and one plane on each side,
  clipped; the layer's own forward (its D padding included) runs on it, and
  the first and last output planes are dropped where the window stops at a
  slab edge, as their zero padding stands for planes that exist. Where the
  window meets the volume's edge, that padding is the volume's own.
- any other convolution (``ops/layers.py::Conv3d``: stride 2, 1x1):
  :func:`conv3d`. Output plane j reads input planes s j - p .. s j - p + k
  - 1; the window of the share's planes is padded with zero planes only
  where it passes the volume's edge, and the convolution runs with no D
  padding.
- transposed (``ops/layers.py::ConvTranspose3d``): :func:`conv_transpose3d`.
  Input plane i adds into output planes i s - p + t, t < k; the window is the
  inputs that reach the share, the transposed convolution runs on it with
  the layer's own padding, and the share is cropped from its output. (With
  no D padding cuDNN's float32 transposed convolution takes another
  algorithm on the card and sums in another order.)

The models take their slab of the hypotheses with :func:`hypothesis_slab`
and gather the single-channel scores over hyp before a readout with
:func:`gather_scores`.

A rank whose output share is empty still joins the fetch and its backward
(``collectives.tie``). Outside a mesh, or with a hyp axis of one, no layer
comes here: each is its unsharded layer.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..parallel.collectives import all_gather, fetch_window, tie
from ..parallel.context import hyp_group, share, shares


def hypothesis_slab(depth_num):
    """(lo, hi) of this rank's slab of ``depth_num`` hypotheses: all of them
    without a hyp axis. Every rank needs at least one: raises otherwise."""
    axis = hyp_group()
    if axis is not None and depth_num < axis.size:
        raise ValueError(f"{depth_num} hypotheses do not give each of the hyp axis' {axis.size} ranks one")
    return share(depth_num, axis)


def gather_scores(scores, depth_num):
    """(N, D, h, w) scores from every rank's slab (N, slab, h, w) under a hyp
    axis: each readout sees the whole D. The gather is exact, so the
    softmax over D and the window around its expectation read what the
    unsharded model reads (JAX lowers the softmax to a max+sum psum)."""
    axis = hyp_group()
    return scores if axis is None else all_gather(scores, 1, depth_num, axis)


def global_depth(x, total):
    """The global D of a volume of which ``x`` (B, C, D, h, w) holds this
    rank's share: ``total`` if given; else, where no hyp axis shards D,
    ``x``'s own. Under a hyp axis the share alone does not tell it: raises."""
    if total is not None:
        return total
    if hyp_group() is not None:
        raise ValueError("a D-sharded 3D layer needs its input's global D (total=) under a hyp axis")
    return x.shape[2]


def _empty(window, channels, size, dtype):
    """The (B, channels, 0, *size) output of a rank with no output planes,
    tied to its window (and so to the fetch) for the backward."""
    return tie(window.new_zeros((window.shape[0], channels, 0, *size), dtype=dtype), window)


def conv3d_same(layer, x, total, axis):
    """``layer`` (a 3x3x3 stride-1 pad-1 convolution; its ``dense`` forward
    runs on the whole D) on this rank's share of ``total`` planes."""
    total = global_depth(x, total)
    owned = shares(total, axis.size)
    windows = [(max(s - 1, 0), min(e + 1, total)) if e > s else (s, s) for s, e in owned]
    window = fetch_window(x, 2, total, windows, axis)
    s, e = owned[axis.rank]
    if e == s:
        return _empty(window, layer.out_channels, x.shape[3:], layer.compute_dtype)
    return layer.dense(window).narrow(2, s - windows[axis.rank][0], e - s)


def conv_depth(layer, total):
    """D of a convolution's output for an input of ``total`` planes."""
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    return (total + 2 * p - k) // s + 1


def conv3d(layer, x, total, axis):
    """``layer`` (``ops/layers.py::Conv3d``) on this rank's share of
    ``total`` planes."""
    total = global_depth(x, total)
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    outs = shares(conv_depth(layer, total), axis.size)
    reads = [(s * o0 - p, s * (o1 - 1) - p + k) if o1 > o0 else (0, 0) for o0, o1 in outs]
    windows = [(max(a, 0), min(b, total)) for a, b in reads]
    window = fetch_window(x, 2, total, windows, axis)
    xw, weight, bias = layer.cast(window)
    o0, o1 = outs[axis.rank]
    if o1 == o0:
        size = [(n + 2 * pp - kk) // ss + 1
                for n, kk, ss, pp in zip(x.shape[3:], layer.kernel_size[1:], layer.stride[1:], layer.padding[1:])]
        return _empty(xw, layer.out_channels, size, xw.dtype)
    (a, b), (wa, wb) = reads[axis.rank], windows[axis.rank]
    xw = F.pad(xw, (0, 0, 0, 0, wa - a, b - wb))  # zero planes only beyond the volume's edges
    return F.conv3d(xw, weight, bias, layer.stride, (0, *layer.padding[1:]), layer.dilation, layer.groups)


def conv_transpose_depth(layer, total):
    """D of a transposed convolution's output for an input of ``total`` planes."""
    k, s, p, op = layer.kernel_size[0], layer.stride[0], layer.padding[0], layer.output_padding[0]
    return (total - 1) * s - 2 * p + k + op


def conv_transpose3d(layer, x, total, axis):
    """``layer`` (``ops/layers.py::ConvTranspose3d``) on this rank's share
    of ``total`` planes."""
    total = global_depth(x, total)
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    outs = shares(conv_transpose_depth(layer, total), axis.size)
    # input i adds into outputs i s - p + t (t < k): the inputs that reach [o0, o1)
    windows = [(max(-((k - 1 - o0 - p) // s), 0), min((o1 - 1 + p) // s + 1, total)) if o1 > o0 else (0, 0)
               for o0, o1 in outs]
    window = fetch_window(x, 2, total, windows, axis)
    xw, weight, bias = layer.cast(window)
    o0, o1 = outs[axis.rank]
    if o1 == o0:
        size = [(n - 1) * ss - 2 * pp + kk + op for n, kk, ss, pp, op in
                zip(x.shape[3:], layer.kernel_size[1:], layer.stride[1:], layer.padding[1:],
                    layer.output_padding[1:])]
        return _empty(xw, layer.out_channels, size, xw.dtype)
    a = windows[axis.rank][0]
    if windows[axis.rank][1] <= a:
        raise ValueError(f"output planes {o0}..{o1 - 1} of a transposed convolution read no input plane")
    # the layer's own padding: its output plane m is the volume's plane m + a s (padding drops as many planes
    # at the front of both), and the call differs from the unsharded one in D alone
    y = F.conv_transpose3d(xw, weight, bias, layer.stride, layer.padding, layer.output_padding, layer.groups,
                           layer.dilation)
    start = o0 - a * s
    if start < 0 or start + o1 - o0 > y.shape[2]:
        raise ValueError(f"output planes {o0}..{o1 - 1} lie beyond the window's {y.shape[2]} (kernel {k}, "
                         f"stride {s}, padding {p})")
    return y.narrow(2, start, o1 - o0)
