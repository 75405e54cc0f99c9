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

Serving runs under ``torch.inference_mode`` and needs none of that: its
helpers (``all_reduce_``, ``all_gather_last``, ``broadcast_``) are the
plain collectives, in place where they can be, with no copy that a CUDA
graph would have to hold. Each adds one to ``SERVING_CALLS``, which a
capture reads to count the collectives inside a graph.
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



# ------------------------------------------------------------------ serving

SERVING_CALLS = {"count": 0}   # serving collectives called (captures read it)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``, in place; returns ``x``."""
    SERVING_CALLS["count"] += 1
    dist.all_reduce(x, group=group)
    return x


# the one-tensor all-gather: torch 2.13 names it all_gather_single and
# deprecates all_gather_into_tensor (a FutureWarning on every call); older
# releases have only all_gather_into_tensor. Same signature.
_all_gather_one = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along the last dim, in rank order
    (vocab-split logits; projections cut mid-head). One all-gather into one
    tensor, then a permute on this rank."""
    SERVING_CALLS["count"] += 1
    n = dist.get_world_size(group)
    width = x.shape[-1]
    flat = x.reshape(-1, width).contiguous()
    out = torch.empty((n * flat.shape[0], width), dtype=x.dtype, device=x.device)
    _all_gather_one(out, flat, group=group)
    out = out.reshape(n, flat.shape[0], width).permute(1, 0, 2)
    return out.reshape(*x.shape[:-1], n * width)


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place."""
    SERVING_CALLS["count"] += 1
    dist.broadcast(x, src=src, group=group)
    return x
