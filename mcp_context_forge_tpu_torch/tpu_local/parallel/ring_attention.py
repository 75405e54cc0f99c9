"""Sequence/context parallelism over ``torch.distributed``: ring attention
and Ulysses all-to-all.

Long-context prefill beyond one card's memory: the sequence dim is split
over a mesh axis (one block of S/n positions per rank) and attention runs
either as

- **ring attention**: K/V blocks (and their padding mask) rotate around
  the ranks with ``batch_isend_irecv`` while each rank keeps its Q block;
  online-softmax stats (running max, denominator, accumulator) merge per
  hop, so the full S×S score matrix never materializes;
- **Ulysses**: ``all_to_all_single`` reshards sequence -> heads so every
  rank computes full-sequence attention for its head slice, then reshards
  back.

``ring_attention_sharded``/``ulysses_attention_sharded`` are the per-rank
bodies (local blocks in, local block out); ``make_ring_attention`` /
``make_ulysses_attention`` take full tensors, run this rank's block and
return the full output on every rank, as the JAX package's ``shard_map``
wrappers do. Plain PyTorch on either device: the scores run in f32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .mesh import axis_group

NEG_INF = -1e30


def _block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int, k_offset: int, causal: bool,
                     k_valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (q block × k block) partial attention with un-normalized stats.

    q: [B,Sq,H,hd]; k/v: [B,Sk,KV,hd] (GQA: expanded locally, so rotated
    blocks stay KV-wide on the wire); k_valid: [B,Sk] bool (padding mask).
    Returns (acc [B,Sq,H,hd], row_max [B,Sq,H,1], row_sum [B,Sq,H,1])."""
    hd = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where((k_pos <= q_pos)[None, None], scores, NEG_INF)
    if k_valid is not None:
        scores = torch.where(k_valid[:, None, None, :], scores, NEG_INF)
    row_max = scores.amax(dim=-1, keepdim=True)                     # [B,H,Sq,1]
    probs = torch.exp(scores - row_max)
    # fully-masked rows: row_max == NEG_INF -> they contribute nothing
    probs = torch.where(row_max > NEG_INF / 2, probs, 0.0)
    row_sum = probs.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return acc, row_max.transpose(1, 2), row_sum.transpose(1, 2)


def _merge(acc_a, max_a, sum_a, acc_b, max_b, sum_b):
    """Merge two un-normalized online-softmax partials."""
    new_max = torch.maximum(max_a, max_b)
    scale_a = torch.exp(max_a - new_max)
    scale_b = torch.exp(max_b - new_max)
    return (acc_a * scale_a + acc_b * scale_b, new_max,
            sum_a * scale_a + sum_b * scale_b)


def _rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Send each tensor to the next rank of the group and receive the
    previous rank's: one all-to-all per tensor whose only non-empty splits
    are those two (ranks named within ``group``, so an engine's private
    groups serve as a ``DeviceMesh``'s do)."""
    n, idx = dist.get_world_size(group), group.rank()
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    received = []
    for t in tensors:
        flat = t.contiguous().reshape(-1)
        send, recv = [0] * n, [0] * n
        send[nxt] = recv[prv] = flat.numel()
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, recv, send, group=group)
        received.append(out.view_as(t))
    return received


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group, causal: bool = True,
                           k_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-rank body, sequence split over ``group``. q/k/v: local blocks
    [B, S_local, H|KV, hd]; k_valid: [B, S_local] padding mask rotating
    with k/v."""
    n, idx = dist.get_world_size(group), group.rank()
    S_local = q.shape[1]
    q_offset = idx * S_local
    if k_valid is None:
        k_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    # step 0: the local block needs no communication
    acc, row_max, row_sum = _block_attention(q, k, v, q_offset, idx * S_local,
                                             causal, k_valid)
    k_blk, v_blk, valid_blk = k, v, k_valid.to(torch.uint8)   # bytes on the wire
    for step in range(n - 1):
        # rotate first, then consume: exactly n-1 hops (a last rotation's
        # block would be discarded)
        k_blk, v_blk, valid_blk = _rotate([k_blk, v_blk, valid_blk], group)
        src = (idx - (step + 1)) % n
        blk = _block_attention(q, k_blk, v_blk, q_offset, src * S_local, causal,
                               valid_blk.bool())
        acc, row_max, row_sum = _merge(acc, row_max, row_sum, *blk)
    return (acc / torch.clamp(row_sum, min=1e-30)).to(q.dtype)


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/n, H, hd] -> [B, S, H/n, hd]: head group j goes to rank j, the
    sequence blocks arrive in rank order (JAX's tiled all_to_all with
    split_axis=2, concat_axis=1)."""
    n = dist.get_world_size(group)
    B, Sl, H, hd = x.shape
    send = x.reshape(B, Sl, n, H // n, hd).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)                          # [n (seq block), B, Sl, H/n, hd]
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, n * Sl, H // n, hd)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/n, hd] -> [B, S/n, H, hd], the inverse of ``_seq_to_heads``."""
    n = dist.get_world_size(group)
    B, S, Hl, hd = x.shape
    send = x.reshape(B, n, S // n, Hl, hd).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)                          # [n (head group), B, S/n, H/n, hd]
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hl, hd)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              group, causal: bool = True,
                              k_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Ulysses body (sequence split over ``group``): all-to-all seq->heads,
    full-sequence attention per head slice, all-to-all back. Requires
    H % n == 0 and KV % n == 0 (GQA k/v reshard at KV width, then expand
    on this rank)."""
    n = dist.get_world_size(group)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"ulysses needs heads {q.shape[2]} and kv heads "
                         f"{k.shape[2]} divisible by the axis size {n}")
    q_full = _seq_to_heads(q, group)
    k_full = _seq_to_heads(k, group)
    v_full = _seq_to_heads(v, group)
    group_size = q_full.shape[2] // k_full.shape[2]
    if group_size > 1:  # expand GQA heads locally, after the transfer
        k_full = k_full.repeat_interleave(group_size, dim=2)
        v_full = v_full.repeat_interleave(group_size, dim=2)
    hd = q_full.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q_full.float(),
                          k_full.float()) / math.sqrt(hd)
    if causal:
        S = q_full.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores, NEG_INF)
    if k_valid is not None:
        # every rank needs the full-sequence padding mask
        valid_full = _gather_seq(k_valid, group)
        scores = torch.where(valid_full[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_full.float())
    return _heads_to_seq(out.to(q.dtype), group)


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's block along dim 1, in rank order."""
    n = dist.get_world_size(group)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire.contiguous(), group=group)
    out = torch.cat(parts, dim=1)
    return out.bool() if x.dtype == torch.bool else out


def _sequence_parallel(body, mesh, axis_name: str, causal: bool):
    group, idx, n = axis_group(mesh, axis_name)

    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
        S = q.shape[1]
        if S % n:
            raise ValueError(f"sequence {S} does not split over {n} ranks")
        block = slice(idx * (S // n), (idx + 1) * (S // n))
        out = body(q[:, block].contiguous(), k[:, block].contiguous(),
                   v[:, block].contiguous(), group, causal,
                   valid[:, block].contiguous())
        return _gather_seq(out, group)

    return run


def make_ring_attention(mesh, axis_name: str = "model", causal: bool = True):
    """Ring attention over ``mesh``'s ``axis_name``: full q/k/v [B,S,H|KV,hd]
    and valid [B,S] in, this rank's sequence block computed, the full
    output [B,S,H,hd] out on every rank. k/v may be GQA (KV < H):
    expansion happens per rank, not on the wire."""
    return _sequence_parallel(ring_attention_sharded, mesh, axis_name, causal)


def make_ulysses_attention(mesh, axis_name: str = "model", causal: bool = True):
    """Signature: (q, k, v, valid), like ``make_ring_attention``."""
    return _sequence_parallel(ulysses_attention_sharded, mesh, axis_name, causal)
