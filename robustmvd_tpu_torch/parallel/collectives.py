"""Differentiable collectives over one mesh axis: the collectives that JAX's
GSPMD partitioner inserts where a sharded model reduces, gathers or
exchanges halos (``robustmvd_tpu/parallel/context.py::constrain``), written
out for torch.

All three are built on the sum-all-reduce, which every backend takes for
CUDA tensors (gloo too, which runs several ranks on one card) and which
takes uneven shares for free. An all-gather is the all-reduce of a
zero-filled buffer of the full size that holds the rank's own slice: it
moves the axis' size times the bytes of a gather (PERF.md §7). A window
fetch (:func:`fetch_window`, the halo exchange of the D-sharded 3D layers,
``ops/sharded3d.py``) is the all-reduce of a buffer with one slot per rank
that holds only the planes each rank's window lacks.

Gradients are the exact adjoints across the ranks: the all-reduce's backward
is the all-reduce of the incoming gradients, the all-gather's the sum over
the ranks of the gradients of the rank's own slice, the window fetch's the
sum over the ranks of the gradients of the planes the rank lent (every
rank joins it, its window read or not). When every rank computes
the same loss and the ranks' parameter gradients are then averaged over the
whole mesh (``DistributedDataParallel``'s mean), every rank holds the
gradient of the unsharded model.

The sums run in float32 whatever the input's dtype (a bf16 input is cast up
and the result cast back, so a gathered bf16 tensor is exact). A tensor with
no elements is given back without a collective: its shape is the same on
every rank of the group, so all of them skip it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .context import shares


class _Tie(torch.autograd.Function):
    """``x`` itself, with ``others`` tied into its graph: they get zero
    gradients. A collective whose result a rank does not read is still
    reached by that rank's backward, so every rank of the group joins the
    collective's adjoint, in the same order."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device) for shape, dtype, device in ctx.others))


def tie(x, *others):
    """``x``, its backward also reaching ``others`` (with zero gradients)."""
    return _Tie.apply(x, *others)


def _summed(x, group):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def all_reduce_sum(x, axis):
    """The sum of ``x`` over the ranks of ``axis`` (an ``AxisGroup``)."""
    if x.numel() == 0:
        return x
    return _AllReduceSum.apply(x.float(), axis.group).to(x.dtype)


def all_gather(x, dim, total, axis):
    """The concatenation along ``dim`` of every rank's ``x``, each rank
    holding its contiguous share (``context.shares``) of ``total`` items of
    that dimension; the shares may be uneven or empty."""
    lo, hi = shares(total, axis.size)[axis.rank]
    if x.shape[dim] != hi - lo:
        raise ValueError(f"rank {axis.rank} of {axis.size} holds {x.shape[dim]} of {total} items along dim {dim}, "
                         f"its share is {hi - lo}")
    before, after = list(x.shape), list(x.shape)
    before[dim], after[dim] = lo, total - hi
    return all_reduce_sum(torch.cat([x.new_zeros(before), x, x.new_zeros(after)], dim), axis)


def fetch_window(x, dim, total, windows, axis):
    """Planes ``windows[rank]`` = [a, b) of a dimension of ``total`` planes
    (0 <= a, b <= total) of which each rank of ``axis`` holds its contiguous
    share (``context.shares``) in ``x``: the halo exchange of a D-sharded
    layer. ``windows`` lists every rank's window, the same list on every rank
    (a function of the shapes alone), so each rank knows what each other one
    lacks: the planes of its window beyond its own share, at most one run
    before it and one after. Each rank writes the planes of its share that
    another rank lacks into that rank's slot of a zero-filled buffer of
    (axis size, most planes lacked) planes; one all-reduce; each rank reads
    its slot. Its backward is the adjoint, the same exchange the other way
    round: each owner sums the gradients of the planes it lent. Uneven and
    empty shares and windows need nothing more; with no plane lacked
    anywhere there is no collective."""
    owned = shares(total, axis.size)
    lo, hi = owned[axis.rank]
    if x.shape[dim] != hi - lo:
        raise ValueError(f"rank {axis.rank} of {axis.size} holds {x.shape[dim]} of {total} planes along dim {dim}, "
                         f"its share is {hi - lo}")

    def lacked(r):
        (a, b), (s, e) = windows[r], owned[r]
        if not 0 <= a <= total or not 0 <= b <= total:
            raise ValueError(f"window {windows[r]} of rank {r} is not within the {total} planes")
        return [(p, q) for p, q in ((a, min(b, s)), (max(a, e), b)) if q > p]

    gaps = [lacked(r) for r in range(axis.size)]
    width = max(sum(q - p for p, q in g) for g in gaps)
    a, b = windows[axis.rank]
    own_a, own_b = max(a, lo), min(b, hi)
    pieces = [(own_a, x.narrow(dim, own_a - lo, own_b - own_a))] if own_b > own_a else []
    got = None
    if width:
        shape = list(x.shape)
        shape[dim] = axis.size * width
        buf = x.new_zeros(shape)
        for r, gap in enumerate(gaps):
            at = r * width
            for p, q in gap:
                s, e = max(p, lo), min(q, hi)
                if e > s and r != axis.rank:
                    buf.narrow(dim, at + s - p, e - s).copy_(x.narrow(dim, s - lo, e - s))
                at += q - p
        if x.requires_grad and not buf.requires_grad:  # lends nothing: its backward joins all the same
            buf = tie(buf, x)
        got = all_reduce_sum(buf, axis)
        at = axis.rank * width
        for p, q in gaps[axis.rank]:
            pieces.append((p, got.narrow(dim, at, q - p)))
            at += q - p
    pieces.sort(key=lambda piece: piece[0])
    window = torch.cat([t for _, t in pieces], dim) if pieces else x.narrow(dim, 0, 0)
    # every rank's backward reaches the all-reduce and the input, whether its window reads them or not
    if got is not None and not gaps[axis.rank]:
        window = tie(window, got)
    if own_b <= own_a:
        window = tie(window, x)
    return window
