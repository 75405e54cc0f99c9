"""Collectives with gradients, for Megatron-style tensor parallelism.

Every rank of the ``model`` group computes the same scalar loss. A tensor
is either replicated (the same value on every rank, and every rank's
autograd sees all of its uses, so its local gradient is complete) or
split (each rank holds its own part). The three crossings:

- ``copy_to(x)``: replicated -> used by split work (a column-parallel
  matmul, a head slice). Identity forward; the gradient each rank sees is
  its part's only, so the backward all-reduces it.
- ``reduce_from(x)``: partial sums -> replicated (after a row-parallel
  matmul, the vocab-parallel embedding). All-reduce forward; identity
  backward.
- ``gather_from(x)``: last-dim blocks -> replicated (vocab-parallel
  logits, projections whose heads do not divide the axis). All-gather
  forward; the backward keeps this rank's block of the gradient.

``reduce_from`` over the ``data`` group sums a statistic of the whole
batch (the MoE aux loss' token means): its identity backward sends the
gradient to each rank's own tokens, and the data-parallel sum of the
gradients adds them up.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.index, ctx.width = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFrom.apply(x, group)
