"""Differentiable collectives of the training mesh: Megatron's conjugate
pairs over an ``AxisGroup`` (``parallel/group.py``).  The reference has no
counterpart: XLA transposes its collectives when ``jax.grad`` differentiates
a sharded program; here autograd needs each collective's adjoint spelt out.

- ``copy_to``: identity forward, all-reduce backward.  Placed where a
  replicated activation enters a computation the axis splits (the input of
  a column-parallel product, of an expert-parallel MLP): each rank's
  gradient of that input is a part, and their sum is the whole.
- ``reduce_from``: all-reduce forward, identity backward.  Placed where the
  ranks' parts become a replicated activation again (after a row-parallel
  product, a vocab-sharded lookup, the expert combine).
- ``gather_from``: all-gather forward along ``dim``, the rank's slice of
  the gradient backward (the vocab-parallel logits).
- ``gather_summed``: all-gather forward along ``dim``, the rank's slice of
  the gradient summed over the axis backward (the keys and values of every
  sp rank, when the rank's queries attend over them densely).

The collectives run through ``AxisGroup``: NCCL on tensors of the rank's
card, gloo through host copies, or, for the sums of ranks that share one
card, CUDA IPC (``AxisGroup.all_reduce``; ``AxisGroup.sum`` leaves its
input as it is).  Each result is a tensor of its own.
``TrainGroup`` wraps an ``AxisGroup`` so that the model's ``all_reduce`` and
``all_gather`` calls (``models/llama.py``) become ``reduce_from`` and
``gather_from``."""

from __future__ import annotations

import torch


def _sum(group, x: torch.Tensor) -> torch.Tensor:
    return group.sum(x)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(ctx.group, grad), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(group, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group.all_gather(x.contiguous(), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return grad.narrow(ctx.dim, g.rank * ctx.n, ctx.n).contiguous(), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group.all_gather(x.contiguous(), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        whole = _sum(g, grad)
        return whole.narrow(ctx.dim, g.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (None: as it is)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(group, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passed through."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(group, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient's slice of this rank passed back."""
    if group is None:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim())


def gather_summed(group, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; this
    rank's slice of the gradient summed over the ranks passed back (each
    rank's use of the whole is a part of the gradient)."""
    return _GatherSummed.apply(x, group, dim % x.dim())


class TrainGroup:
    """An ``AxisGroup`` as the model sees it while it trains: ``rank`` and
    ``size`` as the group's, ``all_reduce`` as ``reduce_from``,
    ``all_gather`` as ``gather_from``; ``axis`` is the group itself, for
    collectives outside autograd."""

    def __init__(self, axis):
        self.axis = axis
        self.rank, self.size = axis.rank, axis.size

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(self.axis, x)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return gather_from(self.axis, x, dim)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(self.axis, x)
