"""Differentiable collectives over one mesh axis: the collectives that JAX's
GSPMD partitioner inserts where a sharded model reduces or gathers
(``robustmvd_tpu/parallel/context.py::constrain``), written out for torch.

Both are built on the sum-all-reduce, which every backend takes for CUDA
tensors (gloo too, which runs several ranks on one card) and which takes
uneven shares for free. An all-gather is the all-reduce of a zero-filled
buffer of the full size that holds the rank's own slice: it moves the axis'
size times the bytes of a gather (PERF.md §7).

Gradients are the exact adjoints across the ranks: the all-reduce's backward
is the all-reduce of the incoming gradients, the all-gather's the sum over
the ranks of the gradients of the rank's own slice. When every rank computes
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
