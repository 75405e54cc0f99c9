"""The int8 KV-page writers, K and V of one layer per launch: one token per
row (``kv_quant_store_decode``) and a [B, S] span per row
(``kv_quant_store_span``).

Each launches a hand-written kernel of ``csrc/kv_quant_store.cu`` on CUDA
tensors and runs its plain model (``*_ref``) on CPU tensors. Both compute
what the plain writers (``kv.paged_cache.write_decode_kv_plain`` and
``write_prefill_kv_plain``, the JAX package's ``_quant_store``) compute,
bit for bit on every page but the trash page 0, in the kernel's own order.

The decode writer, one (row, KV head, K|V) at a time:

1. the row's page and offset from its block-table row (an invalid row
   writes page 0 at offset 0; a position past the table takes its last
   column);
2. the token's scale: max|x| / 127 in f32 (a true division), rounded to
   the scale dtype;
3. the page's new scale: the token's at offset 0 (a new tenancy resets
   the page), else the max of the page's old scale and the token's;
4. at an offset past 0 whose scale grew, the page's resident values of
   that head requantized by s_old / max(s_new, 1e-8) in f32, rounded half
   to even and saturated at +-127 (a ratio of exactly 1 leaves them as
   they are, so it is skipped);
5. the token quantized under the new scale, which is stored.

The span writer, one (row, page the row's span touches, KV head, K|V) at a
time: a row's valid columns form one run c0..c0+n-1 at positions
p0..p0+n-1 (how prefill, chunk rounds, prefix-hit suffixes and the
speculative verify pack them); each page of the run takes steps 2-5 over
its tokens at once: the page's new scale is the max of its tokens' scales
(and of its old scale when the run enters it mid-page, where only the
run's first page can start), the first page is requantized when the run
starts mid-page, and the tokens are quantized under the settled scale.
Invalid tokens write nothing, and columns past the block table are not
written.

Two live rows never write the same page, so no two CTAs meet outside
page 0, where the contents are don't-care.
"""

from __future__ import annotations

import torch

from . import _build, count_launch
from ..quantize import KV_SCALE_EPS, kv_int8_scale, kv_quantize


def kv_quant_store_decode_ref(k_pages, v_pages, k_scales, v_scales, k, v,
                              block_tables, slot_ids, positions,
                              valid=None) -> None:
    """Plain model of the kernel, in place: pages [N, page, KV, hd] int8,
    scales [N, KV], k/v [B, KV, hd] in the scales' dtype, block_tables
    [slots, P], slot_ids/positions [B], valid [B] bool or None."""
    B, KV, _ = k.shape
    page_size, P = k_pages.shape[1], block_tables.shape[1]
    for b in range(B):
        live = valid is None or bool(valid[b])
        page = offset = 0
        if live:
            pos = int(positions[b])
            page = int(block_tables[int(slot_ids[b]), min(pos // page_size, P - 1)])
            offset = pos % page_size
        for pages, scales, vals in ((k_pages, k_scales, k), (v_pages, v_scales, v)):
            for h in range(KV):
                x = vals[b, h].float()
                tok = kv_int8_scale(x.abs().amax()).to(scales.dtype)
                s_old = scales[page, h].clone()
                s_new = tok if offset == 0 else torch.maximum(s_old, tok)
                if offset > 0:
                    ratio = s_old.float() / torch.clamp(s_new.float(), min=KV_SCALE_EPS)
                    if ratio != 1.0:
                        resident = pages[page, :, h].float()
                        pages[page, :, h] = torch.round(resident * ratio).clamp(
                            -127.0, 127.0).to(torch.int8)
                pages[page, offset, h] = kv_quantize(x, s_new)
                scales[page, h] = s_new


def kv_quant_store_decode(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k_scales: torch.Tensor, v_scales: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          block_tables: torch.Tensor, slot_ids: torch.Tensor,
                          positions: torch.Tensor,
                          valid: torch.Tensor | None = None) -> None:
    """Write one token per row of one layer into int8 pages, in place.
    CPU tensors run the plain model; CUDA tensors launch the kernel (or
    raise)."""
    if k_pages.device.type == "cpu":
        kv_quant_store_decode_ref(k_pages, v_pages, k_scales, v_scales, k, v,
                                  block_tables, slot_ids, positions, valid)
        return
    name = "kv_quant_store_decode"
    N, page_size, KV, hd = k_pages.shape
    B = k.shape[0]
    _build.check_head_dim(name, hd)
    if (v_pages.shape != k_pages.shape or k.shape != (B, KV, hd)
            or v.shape != k.shape):
        raise ValueError(f"{name}: pages must be [N, page, KV, hd] and k/v "
                         f"[B, KV, hd], got pages {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k_scales.shape != (N, KV) or v_scales.shape != (N, KV):
        raise ValueError(f"{name}: scales must be [{N}, {KV}], got "
                         f"{tuple(k_scales.shape)}, {tuple(v_scales.shape)}")
    if (block_tables.dim() != 2 or slot_ids.shape != (B,)
            or positions.shape != (B,)):
        raise ValueError(f"{name}: block_tables must be [slots, P] and "
                         f"slot_ids/positions [{B}]")
    ints = {"block_tables": block_tables,
            "slot_ids": slot_ids.to(torch.int32),
            "positions": positions.to(torch.int32)}
    if valid is not None:
        if valid.shape != (B,):
            raise ValueError(f"{name}: valid must be [{B}]")
        ints["valid"] = valid
    k, v = k.contiguous(), v.contiguous()
    dtype = _build.check_inputs(name, {"k": k, "v": v}, ints,
                                int8={"k_pages": k_pages, "v_pages": v_pages},
                                scales={"k_scales": k_scales,
                                        "v_scales": v_scales})
    fn = _build.kernel_fn("kv_quant_store", "mcf_kv_quant_store_decode",
                          [_build.PTR] * 10 + [_build.INT] * 6 + [_build.PTR])
    rc = fn(k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_tables.data_ptr(), ints["slot_ids"].data_ptr(),
            ints["positions"].data_ptr(),
            valid.data_ptr() if valid is not None else None,
            B, KV, hd, page_size, block_tables.shape[1], dtype,
            torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(rc, name)
    count_launch(kv_quant_store_decode)


kv_quant_store_decode.launches = 0


def span_pages(S: int, page_size: int) -> int:
    """Pages a run of S tokens can touch (it may start at a page's last
    offset): the span kernel's grid columns per row."""
    return (S + 2 * page_size - 2) // page_size


def kv_quant_store_span_ref(k_pages, v_pages, k_scales, v_scales, k, v,
                            block_tables, slot_ids, positions, valid) -> None:
    """Plain model of the span kernel, in place: pages [N, page, KV, hd]
    int8, scales [N, KV], k/v [B, S, KV, hd] in the scales' dtype,
    block_tables [slots, P], slot_ids [B], positions/valid [B, S]."""
    B, S, KV, _ = k.shape
    page_size, P = k_pages.shape[1], block_tables.shape[1]
    for b in range(B):
        cols = torch.nonzero(valid[b]).flatten()
        if cols.numel() == 0:
            continue
        c0, n = int(cols[0]), cols.numel()
        p0 = int(positions[b, c0])
        for j in range(span_pages(S, page_size)):
            col = p0 // page_size + j
            lo, hi = max(p0, col * page_size), min(p0 + n, (col + 1) * page_size)
            if lo >= hi or col >= P:
                continue
            page = int(block_tables[int(slot_ids[b]), col])
            fresh = lo % page_size == 0
            tokens = slice(c0 + lo - p0, c0 + hi - p0)
            rows = slice(lo % page_size, lo % page_size + hi - lo)
            for pages, scales, vals in ((k_pages, k_scales, k), (v_pages, v_scales, v)):
                for h in range(KV):
                    x = vals[b, tokens, h].float()                   # [n, hd]
                    tok = kv_int8_scale(x.abs().amax(-1)).to(scales.dtype).amax()
                    s_old = scales[page, h].clone()
                    s_new = tok if fresh else torch.maximum(s_old, tok)
                    if j == 0 and not fresh:
                        ratio = s_old.float() / torch.clamp(s_new.float(), min=KV_SCALE_EPS)
                        if ratio != 1.0:
                            resident = pages[page, :, h].float()
                            pages[page, :, h] = torch.round(resident * ratio).clamp(
                                -127.0, 127.0).to(torch.int8)
                    pages[page, rows, h] = kv_quantize(x, s_new)
                    scales[page, h] = s_new


def kv_quant_store_span(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_scales: torch.Tensor, v_scales: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        block_tables: torch.Tensor, slot_ids: torch.Tensor,
                        positions: torch.Tensor, valid: torch.Tensor) -> None:
    """Write a [B, S] block of one layer into int8 pages, in place: each
    row's valid columns one run at consecutive positions. CPU tensors run
    the plain model; CUDA tensors launch the kernel (or raise)."""
    if k_pages.device.type == "cpu":
        kv_quant_store_span_ref(k_pages, v_pages, k_scales, v_scales, k, v,
                                block_tables, slot_ids, positions, valid)
        return
    name = "kv_quant_store_span"
    N, page_size, KV, hd = k_pages.shape
    B, S = positions.shape
    _build.check_head_dim(name, hd)
    if (v_pages.shape != k_pages.shape or k.shape != (B, S, KV, hd)
            or v.shape != k.shape):
        raise ValueError(f"{name}: pages must be [N, page, KV, hd] and k/v "
                         f"[B, S, KV, hd], got pages {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k_scales.shape != (N, KV) or v_scales.shape != (N, KV):
        raise ValueError(f"{name}: scales must be [{N}, {KV}], got "
                         f"{tuple(k_scales.shape)}, {tuple(v_scales.shape)}")
    if (block_tables.dim() != 2 or slot_ids.shape != (B,)
            or valid.shape != (B, S)):
        raise ValueError(f"{name}: block_tables must be [slots, P], "
                         f"slot_ids [{B}] and valid [{B}, {S}]")
    ints = {"block_tables": block_tables,
            "slot_ids": slot_ids.to(torch.int32),
            "positions": positions.to(torch.int32).contiguous(),
            "valid": valid.contiguous()}
    k, v = k.contiguous(), v.contiguous()
    dtype = _build.check_inputs(name, {"k": k, "v": v}, ints,
                                int8={"k_pages": k_pages, "v_pages": v_pages},
                                scales={"k_scales": k_scales,
                                        "v_scales": v_scales})
    fn = _build.kernel_fn("kv_quant_store", "mcf_kv_quant_store_span",
                          [_build.PTR] * 10 + [_build.INT] * 7 + [_build.PTR])
    rc = fn(k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_tables.data_ptr(), ints["slot_ids"].data_ptr(),
            ints["positions"].data_ptr(), ints["valid"].data_ptr(),
            B, S, KV, hd, page_size, block_tables.shape[1], dtype,
            torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(rc, name)
    count_launch(kv_quant_store_span)


kv_quant_store_span.launches = 0
