"""Attention over the paged KV pool: decode (one query token per row) and
chunk (S query tokens per row, causal by absolute position).

Each function has a plain PyTorch version (``*_ref``: gather the row's
pages, masked softmax in f32), which CPU tensors run, and a wrapper of a
hand-written CUDA kernel (``csrc/paged_decode_attention.cu``,
``csrc/paged_chunk_attention.cu``) for CUDA tensors. The kernels walk only
the pages a row uses, loading the block table themselves.

Layouts are the JAX package's: q [B, KV, G, hd] (decode) or
[B, S, KV, G, hd] (chunk); pages [num_pages, page, KV, hd]; block tables
[B, P] int32; seq_lens [B] and q_positions [B, S] int32.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """[num_pages, page, KV, hd] x [B, P] -> [B, P*page, KV, hd] f32."""
    B, P = block_tables.shape
    rows = pages[block_tables.long()]  # [B, P, page, KV, hd]
    return rows.reshape(B, P * pages.shape[1], *pages.shape[2:]).float()


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens):
    """Plain version of the decode kernel: keys c < seq_lens[b] attend; a
    row with seq_len 0 gives zeros (as the kernel does)."""
    hd = q.shape[-1]
    keys = _gather_pages(k_pages, block_tables)
    values = _gather_pages(v_pages, block_tables)
    scores = torch.einsum("bkgh,bckh->bkgc", q.float(), keys) / math.sqrt(hd)
    cache_pos = torch.arange(keys.shape[1], device=q.device)
    valid = cache_pos[None, :] < seq_lens[:, None]                 # [B, C]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    out = torch.einsum("bkgc,bckh->bkgh", torch.softmax(scores, dim=-1),
                       values)
    out = torch.where((seq_lens > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_chunk_attention_ref(q, k_pages, v_pages, block_tables,
                              q_positions):
    """Plain version of the chunk kernel: cache position c attends iff
    c <= q_positions[b, s]; padding rows (position -1) come out finite."""
    hd = q.shape[-1]
    keys = _gather_pages(k_pages, block_tables)
    values = _gather_pages(v_pages, block_tables)
    scores = torch.einsum("bskgh,bckh->bkgsc", q.float(), keys) / math.sqrt(hd)
    cache_pos = torch.arange(keys.shape[1], device=q.device)
    ok = cache_pos[None, None, :] <= q_positions[:, :, None]      # [B, S, C]
    scores = torch.where(ok[:, None, None], scores, NEG_INF)
    out = torch.einsum("bkgsc,bckh->bskgh", torch.softmax(scores, dim=-1),
                       values)
    return out.to(q.dtype)


def _check_pages(name: str, k_pages, v_pages, KV: int, hd: int) -> None:
    if (k_pages.dim() != 4 or k_pages.shape[2:] != (KV, hd)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"{name}: pages must be [num_pages, page, {KV}, {hd}]"
                         f", got k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """q: [B, KV, G, hd] -> [B, KV, G, hd]. CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens)
    name = "paged_decode_attention"
    B, KV, G, hd = q.shape
    _build.check_head_dim(name, hd)
    _check_pages(name, k_pages, v_pages, KV, hd)
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError(f"{name}: block_tables must be [B, P] and seq_lens "
                         f"[B] for B={B}")
    dtype = _build.check_inputs(
        name, {"q": q, "k_pages": k_pages, "v_pages": v_pages},
        {"block_tables": block_tables, "seq_lens": seq_lens})
    out = torch.empty_like(q)
    fn = _build.kernel_fn(name, "mcf_paged_decode_attention",
                          [_build.PTR] * 6 + [_build.INT] * 7 + [_build.PTR])
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, KV, G, hd, k_pages.shape[1], block_tables.shape[1], dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          q_positions: torch.Tensor) -> torch.Tensor:
    """q: [B, S, KV, G, hd] -> [B, S, KV, G, hd]. CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, k_pages, v_pages, block_tables,
                                         q_positions)
    name = "paged_chunk_attention"
    B, S, KV, G, hd = q.shape
    _build.check_head_dim(name, hd)
    _check_pages(name, k_pages, v_pages, KV, hd)
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or q_positions.shape != (B, S):
        raise ValueError(f"{name}: block_tables must be [B, P] and "
                         f"q_positions [B, S] for B={B}, S={S}")
    dtype = _build.check_inputs(
        name, {"q": q, "k_pages": k_pages, "v_pages": v_pages},
        {"block_tables": block_tables, "q_positions": q_positions})
    out = torch.empty_like(q)
    fn = _build.kernel_fn(name, "mcf_paged_chunk_attention",
                          [_build.PTR] * 6 + [_build.INT] * 8 + [_build.PTR])
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            B, S, KV, G, hd, k_pages.shape[1], block_tables.shape[1], dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0
