"""Attention over the paged KV pool: decode (one query token per row) and
chunk (S query tokens per row, causal by absolute position).

Each function has a plain PyTorch version (``*_ref``: gather the row's
pages, masked softmax in f32), which CPU tensors run, and wrappers of
hand-written CUDA kernels for CUDA tensors. The kernels walk only the pages
a row uses, loading the block table themselves.

The decode kernel splits each row's key walk across CTAs (flash-decoding):
``decode_split_plan`` picks whole-page splits on the host, one launch
writes each split's f32 partials (m, l, o) to a workspace and a second
combines them in a fixed order. ``decode_partials_ref`` and
``decode_combine_ref`` are the plain model of that arithmetic.

The chunk kernels: ``chunk_route`` picks one by query dtype, head dim and
page size. bf16 queries at hd 64 or 128 over pages of a multiple of 64
take ``csrc/paged_chunk_attention_tc.cu`` (wgmma tiles, K/V pages by TMA;
``paged_chunk_attention_tc``/``_tc_q8``); everything else takes the
mma.sync kernel of ``csrc/paged_chunk_attention_mma.cu``
(``paged_chunk_attention_mma``/``_mma_q8``: key tiles of 64 keys, 32 at
hd 256, each key looked up through the block table, so any page size).
``chunk_tiles_ref`` is the plain model of that walk. Each carries its own
launch count; ``paged_chunk_attention``/``_q8`` only dispatch.

Pages are bf16/f32, or int8 with per-(page, kv-head) scales ``k_scales`` /
``v_scales`` [num_pages, KV] in the query's dtype (one layer's slice of the
pool's scales). Int8 pages run their own kernels (``mcf_*_q8``; wrappers
``paged_decode_attention_q8`` and ``paged_chunk_attention_{tc,mma}_q8``
behind ``paged_chunk_attention_q8``, each with its own launch count). The
decode kernel factors each page's scales out of its sums; both chunk
kernels widen the int8 values exactly (to bf16, or f32 for f32 queries)
and multiply S by each key's K scale and P by its V scale in f32. The
plain versions dequantize in f32 inside the gather (``k * k_scale``, as
the Pallas kernels do).

Layouts are the JAX package's: q [B, KV, G, hd] (decode) or
[B, S, KV, G, hd] (chunk); pages [num_pages, page, KV, hd]; block tables
[B, P] int32; seq_lens [B] and q_positions [B, S] int32.

``kv_offset``: the pages may hold more KV heads than q has groups (a
tensor-parallel rank's query heads over a replicated pool, where the KV
heads do not split over the ranks); q's group j then reads the pool's
head ``kv_offset + j``. The kernels take the pool's head count and the
offset and index the whole pool, so no strided view of it is made.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from . import _build, count_launch
from .attention import TC_HEAD_DIMS

NEG_INF = -1e30
LOG2E = 1.4426950408889634
DECODE_MAX_G = 16   # query heads per KV head the decode kernel holds


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                  scales: torch.Tensor | None = None) -> torch.Tensor:
    """[num_pages, page, KV, hd] x [B, P] -> [B, P*page, KV, hd] f32; int8
    pages are multiplied by their page's scale ([num_pages, KV]) in f32."""
    B, P = block_tables.shape
    rows = pages[block_tables.long()].float()  # [B, P, page, KV, hd]
    if scales is not None:
        rows = rows * scales[block_tables.long()].float()[:, :, None, :, None]
    return rows.reshape(B, P * pages.shape[1], *pages.shape[2:])


def kv_window(q_kv: int, k_pages, v_pages, k_scales, v_scales,
              kv_offset: int) -> tuple:
    """The pool's heads [kv_offset, kv_offset + q_kv) (and their scales), as
    the plain versions read them; raises when the window leaves the pool."""
    pool_kv = k_pages.shape[-2]
    if kv_offset < 0 or kv_offset + q_kv > pool_kv:
        raise ValueError(f"kv heads [{kv_offset}, {kv_offset + q_kv}) are not in a "
                         f"pool of {pool_kv}")
    if q_kv == pool_kv:
        return k_pages, v_pages, k_scales, v_scales
    window = slice(kv_offset, kv_offset + q_kv)
    return (k_pages[..., window, :], v_pages[..., window, :],
            None if k_scales is None else k_scales[..., window],
            None if v_scales is None else v_scales[..., window])


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens,
                               k_scales=None, v_scales=None, kv_offset=0):
    """Plain version of the decode kernels: keys c < seq_lens[b] attend; a
    row with seq_len 0 gives zeros (as the kernels do)."""
    k_pages, v_pages, k_scales, v_scales = kv_window(
        q.shape[1], k_pages, v_pages, k_scales, v_scales, kv_offset)
    hd = q.shape[-1]
    keys = _gather_pages(k_pages, block_tables, k_scales)
    values = _gather_pages(v_pages, block_tables, v_scales)
    scores = torch.einsum("bkgh,bckh->bkgc", q.float(), keys) / math.sqrt(hd)
    cache_pos = torch.arange(keys.shape[1], device=q.device)
    valid = cache_pos[None, :] < seq_lens[:, None]                 # [B, C]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    out = torch.einsum("bkgc,bckh->bkgh", torch.softmax(scores, dim=-1),
                       values)
    out = torch.where((seq_lens > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_chunk_attention_ref(q, k_pages, v_pages, block_tables,
                              q_positions, k_scales=None, v_scales=None, kv_offset=0):
    """Plain version of the chunk kernels: cache position c attends iff
    c <= q_positions[b, s]; padding rows (position -1) come out finite."""
    k_pages, v_pages, k_scales, v_scales = kv_window(
        q.shape[2], k_pages, v_pages, k_scales, v_scales, kv_offset)
    hd = q.shape[-1]
    keys = _gather_pages(k_pages, block_tables, k_scales)
    values = _gather_pages(v_pages, block_tables, v_scales)
    scores = torch.einsum("bskgh,bckh->bkgsc", q.float(), keys) / math.sqrt(hd)
    cache_pos = torch.arange(keys.shape[1], device=q.device)
    ok = cache_pos[None, None, :] <= q_positions[:, :, None]      # [B, S, C]
    scores = torch.where(ok[:, None, None], scores, NEG_INF)
    out = torch.einsum("bkgsc,bckh->bskgh", torch.softmax(scores, dim=-1),
                       values)
    return out.to(q.dtype)


def chunk_tile_keys(hd: int) -> int:
    """Keys per tile of the mma.sync chunk kernel: 64, and 32 at its
    hd-256 template (hd > 128), where the O accumulator leaves room for
    less."""
    return 32 if hd > 128 else 64


def chunk_tiles_ref(q, k_pages, v_pages, block_tables, q_positions,
                    k_scales=None, v_scales=None):
    """Plain model of the mma.sync chunk kernel's walk: key tiles of
    ``chunk_tile_keys(hd)`` keys up to the largest position, each key
    gathered from row c % page of page block_tables[b, c // page], scores
    in base 2 (int8 pages: times each key's K scale), masked by position,
    and an online softmax across the tiles (running max and sum; the
    probabilities times each key's V scale for P V). Padding rows
    (position -1) see every key masked and come out finite."""
    B, S, KV, G, hd = q.shape
    page, P = k_pages.shape[1], block_tables.shape[1]
    tk = chunk_tile_keys(hd)
    n_keys = min(int(q_positions.max()) + 1, P * page)
    qf = q.float().permute(0, 2, 3, 1, 4)                        # [B, KV, G, S, hd]
    m = torch.full((B, KV, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G, S), device=q.device)
    o = torch.zeros((B, KV, G, S, hd), device=q.device)
    scale = LOG2E / math.sqrt(hd)
    for c0 in range(0, n_keys, tk):
        c = torch.arange(c0, c0 + tk, device=q.device)
        live = c < n_keys
        idx = block_tables[:, torch.clamp(c // page, max=P - 1)].long()  # [B, tk]
        keys = k_pages[idx, c % page].float()                    # [B, tk, KV, hd]
        values = v_pages[idx, c % page].float()
        keys = torch.where(live[None, :, None, None], keys, 0.0)
        values = torch.where(live[None, :, None, None], values, 0.0)
        s = torch.einsum("bkgsh,bckh->bkgsc", qf, keys) * scale
        if k_scales is not None:
            ks = torch.where(live[None, :, None], k_scales[idx].float(), 0.0)
            s = s * ks.permute(0, 2, 1)[:, :, None, None, :]
        ok = c[None, None, :] <= q_positions[:, :, None]         # [B, S, tk]
        s = torch.where(ok[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        if v_scales is not None:
            vs = torch.where(live[None, :, None], v_scales[idx].float(), 0.0)
            p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
        o = o * corr[..., None] + torch.einsum("bkgsc,bckh->bkgsh", p, values)
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


DECODE_CTAS_PER_SM = 4   # more splits shorten the longest walk; past ~4 the
                         # CTAs that exit at once and the combine cost more


def decode_split_plan(P: int, B: int, KV: int, sms: int) -> tuple[int, int]:
    """(pages per split, splits) for the decode kernel's grid (splits, KV,
    B): each split is a run of whole table slots, enough splits for
    DECODE_CTAS_PER_SM CTAs per SM where the table has the slots (one slot
    per split at most), and none past the table
    (splits * pps >= P > (splits - 1) * pps)."""
    if min(P, B, KV, sms) < 1:
        raise ValueError(f"decode_split_plan needs P, B, KV, sms >= 1, got "
                         f"{P}, {B}, {KV}, {sms}")
    want = -(-DECODE_CTAS_PER_SM * sms // (B * KV))
    pps = max(1, P // want)
    return pps, -(-P // pps)


def decode_partials_ref(q, k_pages, v_pages, block_tables, seq_lens, pps,
                        k_scales=None, v_scales=None):
    """Plain model of the decode kernel's split launch: for split i over
    table slots [i*pps, (i+1)*pps), the f32 partials over its keys
    c < seq_len: m (base-2 units: max of q.k * log2(e) / sqrt(hd)), l (sum
    of 2^(s - m)) and o (sum of 2^(s - m) v). Int8 pages multiply each
    page's q.k sums by its K scale and its P @ V sums by its V scale, as
    the kernel does. A split holding no key gives m = -1e30, l = 0, o = 0.
    Returns ml [B, KV, splits, G, 2] and o [B, KV, splits, G, hd]."""
    B, KV, G, hd = q.shape
    P, page = block_tables.shape[1], k_pages.shape[1]
    idx = block_tables.long()
    keys = k_pages[idx].float()                       # [B, P, page, KV, hd]
    values = v_pages[idx].float()
    ones = torch.ones((B, P, KV), device=q.device)
    ks = ones if k_scales is None else k_scales[idx].float()   # [B, P, KV]
    vs = ones if v_scales is None else v_scales[idx].float()
    scores = torch.einsum("bkgh,bpckh->bkgpc", q.float(), keys)
    scores = scores * (ks.permute(0, 2, 1)[:, :, None, :, None]
                       * (LOG2E / math.sqrt(hd)))
    pos = torch.arange(P * page, device=q.device).reshape(P, page)
    valid = pos[None] < seq_lens[:, None, None]       # [B, P, page]
    ml, outs = [], []
    for start in range(0, P, pps):
        sl = slice(start, min(start + pps, P))
        ok = valid[:, sl][:, None, None]              # [B, 1, 1, n, page]
        s = scores[..., sl, :]
        m = torch.where(ok, s, NEG_INF).amax((-2, -1))  # [B, KV, G]
        p = torch.where(ok, torch.exp2(s - m[..., None, None]), 0.0)
        pv = torch.einsum("bkgpc,bpckh->bkgph", p, values[:, sl])
        pv = pv * vs[:, sl].permute(0, 2, 1)[:, :, None, :, None]
        ml.append(torch.stack([m, p.sum((-2, -1))], -1))
        outs.append(pv.sum(-2))
    return torch.stack(ml, 2), torch.stack(outs, 2)


def decode_combine_ref(ml, o, seq_lens, page_size, pps, P):
    """Plain model of the combine launch: over the row's active splits (the
    first ceil(ceil(seq_len / page) / pps)), M = max m_i and
    out = sum 2^(m_i - M) o_i / sum 2^(m_i - M) l_i; zeros where the
    denominator is 0 (seq_len 0). Returns f32 [B, KV, G, hd]."""
    pages = -(-seq_lens.long().clamp(max=P * page_size) // page_size)
    active = -(-pages // pps)                                       # [B]
    keep = (torch.arange(ml.shape[2], device=ml.device)[None]
            < active[:, None])[:, None, :, None]                     # [B,1,S,1]
    m = torch.where(keep, ml[..., 0], NEG_INF)
    w = torch.where(keep, torch.exp2(m - m.amax(2, keepdim=True)), 0.0)
    den = (w * ml[..., 1]).sum(2)
    num = (w[..., None] * o).sum(2)
    return torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None],
                       0.0)


def _checked(name: str, q: torch.Tensor, k_pages: torch.Tensor,
             v_pages: torch.Tensor, k_scales, v_scales, KV: int, hd: int,
             ints: dict, kv_offset: int = 0) -> tuple[list[int], int]:
    """Validate a kernel's tensors (pages of any head count that holds q's
    KV groups from ``kv_offset`` on); returns the data pointers of q, the
    pages and (int8) the scales, and the dtype code."""
    _build.check_head_dim(name, hd)
    pool_kv = k_pages.shape[2] if k_pages.dim() == 4 else -1
    if (k_pages.dim() != 4 or k_pages.shape[3] != hd or kv_offset < 0
            or kv_offset + KV > pool_kv or v_pages.shape != k_pages.shape):
        raise ValueError(f"{name}: pages must be [num_pages, page, >= "
                         f"{kv_offset + KV}, {hd}], got k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}")
    pages = {"k_pages": k_pages, "v_pages": v_pages}
    if k_scales is None:
        dtype = _build.check_inputs(name, {"q": q, **pages}, ints)
        return [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()], dtype
    want = (k_pages.shape[0], pool_kv)
    if k_scales.shape != want or v_scales.shape != want:
        raise ValueError(f"{name}: scales must be {list(want)}, got k "
                         f"{tuple(k_scales.shape)}, v {tuple(v_scales.shape)}")
    dtype = _build.check_inputs(name, {"q": q}, ints, int8=pages,
                                scales={"k_scales": k_scales,
                                        "v_scales": v_scales})
    return [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr()], dtype


def _check_scale_pair(k_scales, v_scales) -> None:
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, k_scales=None,
                           v_scales=None, kv_offset: int = 0) -> torch.Tensor:
    """q: [B, KV, G, hd] -> [B, KV, G, hd]. With scales, int8 pages go to
    ``paged_decode_attention_q8``. CPU tensors run the plain version; CUDA
    tensors launch the kernel (or raise)."""
    _check_scale_pair(k_scales, v_scales)
    if k_scales is not None:
        return paged_decode_attention_q8(q, k_pages, v_pages, block_tables,
                                         seq_lens, k_scales, v_scales, kv_offset)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens, kv_offset=kv_offset)
    out, _ = _decode_launch("paged_decode_attention",
                            "mcf_paged_decode_attention", q, k_pages, v_pages,
                            block_tables, seq_lens, None, None, kv_offset)
    count_launch(paged_decode_attention)
    return out


def paged_decode_attention_q8(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_tables: torch.Tensor,
                              seq_lens: torch.Tensor, k_scales: torch.Tensor,
                              v_scales: torch.Tensor, kv_offset: int = 0) -> torch.Tensor:
    """Decode attention over int8 pages with [num_pages, KV] scales."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens, k_scales, v_scales, kv_offset)
    out, _ = _decode_launch("paged_decode_attention_q8",
                            "mcf_paged_decode_attention_q8", q, k_pages,
                            v_pages, block_tables, seq_lens, k_scales,
                            v_scales, kv_offset)
    count_launch(paged_decode_attention_q8)
    return out


@dataclasses.dataclass
class DecodeWorkspace:
    """The split launch's partials: ml [B, KV, splits, G, 2] (m, l) and
    o [B, KV, splits, G, hd], f32, with the plan that produced them."""
    ml: torch.Tensor
    o: torch.Tensor
    page_size: int
    P: int
    pps: int


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_launch(name, symbol, q, k_pages, v_pages, block_tables, seq_lens,
                   k_scales, v_scales, kv_offset: int = 0
                   ) -> tuple[torch.Tensor, DecodeWorkspace]:
    """Both launches (split, combine) of one decode call; returns the output
    and the workspace that holds the partials."""
    B, KV, G, hd = q.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError(f"{name}: block_tables must be [B, P] and seq_lens "
                         f"[B] for B={B}")
    if G > DECODE_MAX_G:
        raise ValueError(f"{name}: at most {DECODE_MAX_G} query heads per KV "
                         f"head, got {G}")
    if hd * k_pages.element_size() % 16:
        raise ValueError(f"{name}: a key's {hd} elements must fill whole "
                         f"16-byte chunks (int8 pages need hd % 16 == 0)")
    ptrs, dtype = _checked(name, q, k_pages, v_pages, k_scales, v_scales, KV,
                           hd, {"block_tables": block_tables,
                                "seq_lens": seq_lens}, kv_offset)
    P, page = block_tables.shape[1], k_pages.shape[1]
    pps, splits = decode_split_plan(P, B, KV, _sm_count(q.device.index or 0))
    ws = DecodeWorkspace(
        torch.empty((B, KV, splits, G, 2), dtype=torch.float32, device=q.device),
        torch.empty((B, KV, splits, G, hd), dtype=torch.float32, device=q.device),
        page, P, pps)
    out = torch.empty_like(q)
    fn = _build.kernel_fn("paged_decode_attention", symbol,
                          [_build.PTR] * (len(ptrs) + 5) + [_build.INT] * 11
                          + [_build.PTR])
    rc = fn(*ptrs, block_tables.data_ptr(), seq_lens.data_ptr(),
            ws.ml.data_ptr(), ws.o.data_ptr(), out.data_ptr(), B, KV, G, hd,
            page, P, pps, splits, k_pages.shape[2], kv_offset, dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    return out, ws


def paged_decode_combine(ws: DecodeWorkspace, seq_lens: torch.Tensor,
                         out: torch.Tensor) -> torch.Tensor:
    """The combine launch alone, over the partials in ``ws``, into ``out``
    ([B, KV, G, hd], the query's dtype). Not a decode launch of its own: a
    caller that rewrites partials (a planted fault) recombines with it."""
    name = "paged_decode_combine"
    B, KV, splits, G, hd = ws.o.shape
    dtype = _build.check_inputs(name, {"out": out}, {"seq_lens": seq_lens})
    if out.shape != (B, KV, G, hd) or seq_lens.shape != (B,):
        raise ValueError(f"{name}: out must be {[B, KV, G, hd]} and seq_lens "
                         f"[{B}]")
    fn = _build.kernel_fn("paged_decode_attention", "mcf_paged_decode_combine",
                          [_build.PTR] * 4 + [_build.INT] * 9 + [_build.PTR])
    rc = fn(seq_lens.data_ptr(), ws.ml.data_ptr(), ws.o.data_ptr(),
            out.data_ptr(), B, KV, G, hd, ws.page_size, ws.P, ws.pps, splits,
            dtype, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, name)
    return out


CHUNK_TC_PAGE = 64   # the tensor-core kernel's key tile: pages hold whole tiles


def chunk_route(q_dtype: torch.dtype, hd: int, page_size: int) -> str:
    """Which chunk kernel a CUDA call takes: ``"tc"`` (wgmma) for bf16
    queries at hd 64 or 128 over pages of a multiple of 64 tokens,
    ``"mma"`` (mma.sync) otherwise. A static choice, never a
    reaction to a failed build or launch."""
    return ("tc" if q_dtype == torch.bfloat16 and hd in TC_HEAD_DIMS
            and page_size % CHUNK_TC_PAGE == 0 else "mma")


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          q_positions: torch.Tensor, k_scales=None,
                          v_scales=None, kv_offset: int = 0) -> torch.Tensor:
    """q: [B, S, KV, G, hd] -> [B, S, KV, G, hd]. With scales, int8 pages
    go to ``paged_chunk_attention_q8``. CPU tensors run the plain version;
    CUDA tensors launch the kernel ``chunk_route`` names (or raise)."""
    _check_scale_pair(k_scales, v_scales)
    if k_scales is not None:
        return paged_chunk_attention_q8(q, k_pages, v_pages, block_tables,
                                        q_positions, k_scales, v_scales, kv_offset)
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, k_pages, v_pages, block_tables,
                                         q_positions, kv_offset=kv_offset)
    kernel = (paged_chunk_attention_tc
              if chunk_route(q.dtype, q.shape[-1], k_pages.shape[1]) == "tc"
              else paged_chunk_attention_mma)
    return kernel(q, k_pages, v_pages, block_tables, q_positions, kv_offset=kv_offset)


def paged_chunk_attention_q8(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_tables: torch.Tensor,
                             q_positions: torch.Tensor, k_scales: torch.Tensor,
                             v_scales: torch.Tensor, kv_offset: int = 0) -> torch.Tensor:
    """Chunk attention over int8 pages with [num_pages, KV] scales."""
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, k_pages, v_pages, block_tables,
                                         q_positions, k_scales, v_scales, kv_offset)
    kernel = (paged_chunk_attention_tc_q8
              if chunk_route(q.dtype, q.shape[-1], k_pages.shape[1]) == "tc"
              else paged_chunk_attention_mma_q8)
    return kernel(q, k_pages, v_pages, block_tables, q_positions, k_scales,
                  v_scales, kv_offset=kv_offset)


def _check_tc(name: str, q: torch.Tensor, k_pages: torch.Tensor) -> None:
    if chunk_route(q.dtype, q.shape[-1], k_pages.shape[1]) != "tc":
        raise ValueError(
            f"{name} takes bf16 queries at hd {TC_HEAD_DIMS} over pages "
            f"of a multiple of {CHUNK_TC_PAGE}, got {q.dtype} at hd "
            f"{q.shape[-1]}, page {k_pages.shape[1]}")


def paged_chunk_attention_tc(q, k_pages, v_pages, block_tables,
                             q_positions, kv_offset: int = 0) -> torch.Tensor:
    """The tensor-core kernel over bf16 pages (CUDA tensors)."""
    _check_tc("paged_chunk_attention_tc", q, k_pages)
    out = _chunk_launch("paged_chunk_attention_tc",
                        "mcf_paged_chunk_attention_tc", q, k_pages, v_pages,
                        block_tables, q_positions, None, None, kv_offset)
    count_launch(paged_chunk_attention_tc)
    return out


def paged_chunk_attention_tc_q8(q, k_pages, v_pages, block_tables,
                                q_positions, k_scales,
                                v_scales, kv_offset: int = 0) -> torch.Tensor:
    """The tensor-core kernel over int8 pages (CUDA tensors)."""
    _check_tc("paged_chunk_attention_tc_q8", q, k_pages)
    out = _chunk_launch("paged_chunk_attention_tc",
                        "mcf_paged_chunk_attention_tc_q8", q, k_pages,
                        v_pages, block_tables, q_positions, k_scales, v_scales,
                        kv_offset)
    count_launch(paged_chunk_attention_tc_q8)
    return out


def paged_chunk_attention_mma(q, k_pages, v_pages, block_tables,
                              q_positions, kv_offset: int = 0) -> torch.Tensor:
    """The mma.sync kernel over bf16/f32 pages (CUDA tensors)."""
    out = _chunk_launch("paged_chunk_attention_mma",
                        "mcf_paged_chunk_attention_mma", q, k_pages, v_pages,
                        block_tables, q_positions, None, None, kv_offset)
    count_launch(paged_chunk_attention_mma)
    return out


def paged_chunk_attention_mma_q8(q, k_pages, v_pages, block_tables,
                                 q_positions, k_scales,
                                 v_scales, kv_offset: int = 0) -> torch.Tensor:
    """The mma.sync kernel over int8 pages (CUDA tensors; hd % 16 == 0,
    whole 16-byte chunks of int8 keys)."""
    if q.shape[-1] % 16:
        raise ValueError(f"paged_chunk_attention_mma_q8: int8 pages need "
                         f"hd % 16 == 0, got {q.shape[-1]}")
    out = _chunk_launch("paged_chunk_attention_mma",
                        "mcf_paged_chunk_attention_mma_q8", q, k_pages,
                        v_pages, block_tables, q_positions, k_scales, v_scales,
                        kv_offset)
    count_launch(paged_chunk_attention_mma_q8)
    return out


def _chunk_launch(lib, symbol, q, k_pages, v_pages, block_tables,
                  q_positions, k_scales, v_scales, kv_offset: int = 0) -> torch.Tensor:
    """One chunk launch of library ``lib``; the tensor-core entries also
    take the pool's page count (their TMA maps span the layer's pool);
    every entry takes the pool's head count and ``kv_offset``."""
    B, S, KV, G, hd = q.shape
    name = symbol.removeprefix("mcf_")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or q_positions.shape != (B, S):
        raise ValueError(f"{name}: block_tables must be [B, P] and "
                         f"q_positions [B, S] for B={B}, S={S}")
    ptrs, dtype = _checked(name, q, k_pages, v_pages, k_scales, v_scales, KV,
                           hd, {"block_tables": block_tables,
                                "q_positions": q_positions}, kv_offset)
    ints = [B, S, KV, G, hd, k_pages.shape[1], block_tables.shape[1]]
    if lib == "paged_chunk_attention_tc":
        ints.append(k_pages.shape[0])
    ints += [k_pages.shape[2], kv_offset]
    out = torch.empty_like(q)
    fn = _build.kernel_fn(lib, symbol,
                          [_build.PTR] * (len(ptrs) + 3)
                          + [_build.INT] * (len(ints) + 1) + [_build.PTR])
    rc = fn(*ptrs, block_tables.data_ptr(), q_positions.data_ptr(),
            out.data_ptr(), *ints, dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    return out


paged_decode_attention.launches = 0
paged_decode_attention_q8.launches = 0
paged_chunk_attention_tc.launches = 0
paged_chunk_attention_tc_q8.launches = 0
paged_chunk_attention_mma.launches = 0
paged_chunk_attention_mma_q8.launches = 0
