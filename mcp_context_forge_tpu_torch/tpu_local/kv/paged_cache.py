"""Paged KV cache in device memory.

A fixed pool of pages [L, num_pages, page_size, KV, hd] and a block table
[slots, max_pages_per_slot] int32 that maps decode slots to pages, so cache
memory scales with tokens in use, not slots x max context. Page 0 is the
trash page: masked and padding writes land there.

Unlike the JAX package's functional state, the writers here update the
pages IN PLACE (``index_put_``) and return the same state object: copying
the pool per layer per step would double the bytes the step moves.

Int8 storage (``quant="int8"``): pages hold int8 values plus per-(layer,
page, kv-head) scales [L, num_pages, KV] in the compute dtype, which halves
the pool's bytes per token. Scales are RUNNING MAXIMA over a page's
tenancy: a write at offset 0 begins a new tenancy and resets the page's
scale; later appends grow it and requantize the page's resident values, so
every live value dequantizes under the scale it is stored under. Each
row's valid positions within one call must form one contiguous ascending
span (true of prefill, chunk and suffix prefill, and decode): then only
the page under each row's first written token can hold earlier tokens of
that row, and only it is requantized. The arithmetic is the JAX writers',
step for step (``_quant_store``). On the card, both writers of an int8
pool are one hand-written kernel per layer (``ops.kv_write``: a decode
token per row, or a [B, S] span per row); CPU tensors keep
``_quant_store`` (``write_decode_kv_plain``, ``write_prefill_kv_plain``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.configs import LlamaConfig
from ..ops.kv_write import kv_quant_store_decode, kv_quant_store_span
from ..quantize import KV_SCALE_EPS, kv_dequantize, kv_int8_scale, kv_quantize
from .prefix_index import ROOT_HASH, chain_hash
from .tiers import TIERS


@dataclass
class PagedKVState:
    k_pages: torch.Tensor        # [L, num_pages, page_size, KV, hd]
    v_pages: torch.Tensor        # [L, num_pages, page_size, KV, hd]
    block_tables: torch.Tensor   # [slots, max_pages_per_slot] int32 (0 = unassigned)
    # int8 pools only: dequant scales [L, num_pages, KV] in the compute dtype
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None


def _check_quant(quant: str) -> None:
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported KV quant mode {quant!r}")


def init_kv_state(config: LlamaConfig, num_pages: int, page_size: int,
                  max_slots: int, max_pages_per_slot: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cuda",
                  quant: str = "", kv_heads: int | None = None) -> PagedKVState:
    """A zeroed pool. ``quant="int8"`` stores int8 pages with scales in
    ``dtype``; otherwise pages are ``dtype``. ``kv_heads``: the heads this
    pool holds (a tensor-parallel rank's shard of them, ``kv_pages_spec``);
    by default all of the config's."""
    _check_quant(quant)
    kv_heads = config.n_kv_heads if kv_heads is None else kv_heads
    shape = (config.n_layers, num_pages, page_size, kv_heads, config.head_dim)
    page_dtype = torch.int8 if quant else dtype
    state = PagedKVState(
        k_pages=torch.zeros(shape, dtype=page_dtype, device=device),
        v_pages=torch.zeros(shape, dtype=page_dtype, device=device),
        block_tables=torch.zeros((max_slots, max_pages_per_slot),
                                 dtype=torch.int32, device=device))
    if quant:
        scale_shape = (config.n_layers, num_pages, kv_heads)
        state.k_scales = torch.zeros(scale_shape, dtype=dtype, device=device)
        state.v_scales = torch.zeros(scale_shape, dtype=dtype, device=device)
    return state


def kv_page_bytes(config: LlamaConfig, page_size: int,
                  dtype: torch.dtype = torch.bfloat16, quant: str = "") -> int:
    """Device bytes ONE page (K and V, all layers) costs: int8 values plus
    the per-(layer, head) scale sliver under ``quant="int8"``."""
    _check_quant(quant)
    elems = (2 * config.n_layers * page_size * config.n_kv_heads
             * config.head_dim)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if quant:
        return elems + 2 * config.n_layers * config.n_kv_heads * itemsize
    return elems * itemsize


def num_pages_for_budget(config: LlamaConfig, page_size: int,
                         budget_bytes: int,
                         dtype: torch.dtype = torch.bfloat16,
                         quant: str = "") -> int:
    """Pages a fixed device byte budget holds (about twice as many under
    int8 as under bf16)."""
    return max(2, int(budget_bytes
                      // kv_page_bytes(config, page_size, dtype, quant)))


def _quant_store(pages: torch.Tensor, scales: torch.Tensor,
                 values: torch.Tensor, flat_pages: torch.Tensor,
                 flat_offset: torch.Tensor, first_pages: torch.Tensor,
                 first_mask: torch.Tensor) -> None:
    """Quantize ``values`` [N, KV, hd] into one layer's int8 ``pages``
    [num_pages, page, KV, hd] under running-max ``scales`` [num_pages, KV],
    in place. ``first_pages``/``first_mask`` [R]: the page under each row's
    first written token, masked to rows whose span starts mid-page (the
    only pages that can hold earlier tokens of the spans being written).

    The order is the JAX writer's: read the old scales, reset the scales of
    pages written at offset 0 (a new tenancy), take the running max of
    this call's tokens (each token's scale cast to the scale dtype first),
    requantize the first pages' resident values by s_old / s_new, then
    write the new tokens under the settled scales. Only page 0 (the trash
    page) ever sees duplicate indices."""
    KV = scales.shape[1]
    safe_first = torch.where(first_mask, first_pages, 0)
    s_old = scales[safe_first].float()                       # [R, KV] (a copy)
    scales[torch.where(flat_offset == 0, flat_pages, 0)] = 0
    amax = values.float().abs().amax(dim=-1)                 # [N, KV]
    tok_scale = kv_int8_scale(amax).to(scales.dtype)
    scales.scatter_reduce_(0, flat_pages[:, None].expand(-1, KV), tok_scale,
                           "amax", include_self=True)
    resident = pages[safe_first]                             # [R, page, KV, hd]
    s_new = scales[safe_first].float()
    ratio = s_old / torch.clamp(s_new, min=KV_SCALE_EPS)
    requant = torch.round(resident.float() * ratio[:, None, :, None])
    requant = requant.clamp(-127.0, 127.0).to(torch.int8)
    requant = torch.where(first_mask[:, None, None, None], requant, resident)
    pages.index_put_((safe_first,), requant)
    s_final = scales[flat_pages][..., None].float()          # [N, KV, 1]
    pages.index_put_((flat_pages, flat_offset), kv_quantize(values, s_final))


def write_prefill_kv(kv: PagedKVState, layer: int, k: torch.Tensor,
                     v: torch.Tensor, slot_ids: torch.Tensor,
                     positions: torch.Tensor,
                     valid: torch.Tensor) -> PagedKVState:
    """Scatter a [B,S] block of K/V into pages, in place (quantizing under
    int8; each row's valid entries must be one run of columns at
    consecutive positions, as every caller packs them).

    k/v: [B,S,KV,hd]; slot_ids: [B]; positions: [B,S] (>= 0); valid:
    [B,S] bool — invalid entries go to page 0, offset 0 (the int8 kernel
    writes nothing for them). An int8 pool on the card takes the span
    writer kernel, K and V of the layer in one launch; everything else
    runs ``write_prefill_kv_plain``."""
    if kv.quantized and kv.k_pages.is_cuda:
        kv_quant_store_span(kv.k_pages[layer], kv.v_pages[layer],
                            kv.k_scales[layer], kv.v_scales[layer], k, v,
                            kv.block_tables, slot_ids, positions, valid)
        return kv
    return write_prefill_kv_plain(kv, layer, k, v, slot_ids, positions, valid)


def write_prefill_kv_plain(kv: PagedKVState, layer: int, k: torch.Tensor,
                           v: torch.Tensor, slot_ids: torch.Tensor,
                           positions: torch.Tensor,
                           valid: torch.Tensor) -> PagedKVState:
    """The plain PyTorch prefill writer (``_quant_store`` on int8 pools),
    on any device: what CPU tensors run and what the span kernel is held
    to."""
    B, S = positions.shape
    page_size = kv.page_size
    rows = kv.block_tables[slot_ids.long()]                       # [B, P]
    pages = torch.gather(rows, 1, (positions // page_size).long())
    pages = torch.where(valid, pages, 0).long()                   # [B, S]
    offset = torch.where(valid, positions % page_size, 0).long()
    k_flat = k.reshape(B * S, *k.shape[2:])
    v_flat = v.reshape(B * S, *v.shape[2:])
    if kv.quantized:
        # the page under each row's first valid token (a row with none
        # picks column 0, which is masked), as JAX's argmax over ``valid``
        cols = torch.arange(S, device=valid.device)
        first = torch.where(valid, cols, S).amin(dim=1, keepdim=True) % S
        first_pages = torch.gather(pages, 1, first)[:, 0]
        first_mask = (torch.gather(valid, 1, first)[:, 0]
                      & (torch.gather(offset, 1, first)[:, 0] > 0))
        for pool, scales, vals in ((kv.k_pages, kv.k_scales, k_flat),
                                   (kv.v_pages, kv.v_scales, v_flat)):
            _quant_store(pool[layer], scales[layer], vals, pages.reshape(-1),
                         offset.reshape(-1), first_pages, first_mask)
        return kv
    index = (pages.reshape(-1), offset.reshape(-1))
    dtype = kv.k_pages.dtype
    kv.k_pages[layer].index_put_(index, k_flat.to(dtype))
    kv.v_pages[layer].index_put_(index, v_flat.to(dtype))
    return kv


def write_decode_kv(kv: PagedKVState, layer: int, k: torch.Tensor,
                    v: torch.Tensor, slot_ids: torch.Tensor,
                    positions: torch.Tensor,
                    valid: torch.Tensor | None = None) -> PagedKVState:
    """Scatter one token per slot, in place. k/v: [B,KV,hd]; positions: [B];
    valid: [B] bool — False rows write to the trash page. A position past
    the block table takes its last column, as the JAX package's gather
    clamps (only a row the page pool has already ended writes there). An
    int8 pool on the card takes the fused writer kernel, K and V of the
    layer in one launch; everything else runs ``write_decode_kv_plain``."""
    if kv.quantized and kv.k_pages.is_cuda:
        kv_quant_store_decode(kv.k_pages[layer], kv.v_pages[layer],
                              kv.k_scales[layer], kv.v_scales[layer], k, v,
                              kv.block_tables, slot_ids, positions, valid)
        return kv
    return write_decode_kv_plain(kv, layer, k, v, slot_ids, positions, valid)


def write_decode_kv_plain(kv: PagedKVState, layer: int, k: torch.Tensor,
                          v: torch.Tensor, slot_ids: torch.Tensor,
                          positions: torch.Tensor,
                          valid: torch.Tensor | None = None) -> PagedKVState:
    """The plain PyTorch decode writer (``_quant_store`` on int8 pools),
    on any device: what CPU tensors run and what the fused kernel is held
    to."""
    page_size = kv.page_size
    rows = kv.block_tables[slot_ids.long()]                       # [B, P]
    col = (positions // page_size).clamp(max=rows.shape[1] - 1)
    pages = torch.gather(rows, 1, col[:, None].long())[:, 0]
    offset = positions % page_size
    if valid is not None:
        pages = torch.where(valid, pages, 0)
        offset = torch.where(valid, offset, 0)
    pages, offset = pages.long(), offset.long()
    if kv.quantized:
        # a one-token span: the written page is its own first page, and
        # holds earlier tokens of the row when the offset is past 0
        first_mask = offset > 0
        if valid is not None:
            first_mask = first_mask & valid
        for pool, scales, vals in ((kv.k_pages, kv.k_scales, k),
                                   (kv.v_pages, kv.v_scales, v)):
            _quant_store(pool[layer], scales[layer], vals, pages, offset,
                         pages, first_mask)
        return kv
    kv.k_pages[layer].index_put_((pages, offset), k.to(kv.k_pages.dtype))
    kv.v_pages[layer].index_put_((pages, offset), v.to(kv.v_pages.dtype))
    return kv


def gather_kv(kv: PagedKVState, layer: int, slot_ids: torch.Tensor,
              ctx_pages: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize each slot's context: -> ([B, C, KV, hd], [B, C, KV, hd])
    with C = ctx_pages * page_size (default: the full table width). The
    plain attention path uses it; the kernels read the pages in place.
    Int8 pools dequantize per page into the scales' dtype (the compute
    dtype), as the JAX gather does."""
    rows = kv.block_tables[slot_ids.long()]
    if ctx_pages is not None:
        rows = rows[:, :ctx_pages]
    rows = rows.long()
    k = kv.k_pages[layer][rows]                                   # [B,P,page,KV,hd]
    v = kv.v_pages[layer][rows]
    if kv.quantized:
        dtype = kv.k_scales.dtype
        k = kv_dequantize(k, kv.k_scales[layer][rows][:, :, None, :, None],
                          dtype)
        v = kv_dequantize(v, kv.v_scales[layer][rows][:, :, None, :, None],
                          dtype)
    B, P, page, KV, hd = k.shape
    return k.reshape(B, P * page, KV, hd), v.reshape(B, P * page, KV, hd)


class PrefixEvictionPolicy:
    """Eviction order over the ref==0 resident prefix pages: LRU by LAST
    MATCH. A page leaves the policy when a match re-references it and
    re-enters at the MRU end when its last reference drops, so the victim
    is always the resident page whose prefix went unmatched the longest."""

    def __init__(self) -> None:
        self._order: dict[int, None] = {}

    def add(self, page: int) -> None:
        """(Re-)admit a ref==0 resident page at the MRU end."""
        self._order.pop(page, None)
        self._order[page] = None

    def discard(self, page: int) -> None:
        self._order.pop(page, None)

    def pop(self, page: int, default=None):
        return self._order.pop(page, default)

    def victim(self) -> int | None:
        """The LRU-by-last-match page, or None when nothing is evictable."""
        return next(iter(self._order)) if self._order else None

    def __contains__(self, page: int) -> bool:
        return page in self._order

    def __len__(self) -> int:
        return len(self._order)

    def __iter__(self):
        return iter(self._order)


class PageAllocator:
    """Host-side page bookkeeping: refcounted free list + per-slot
    assignment + prefix cache.

    Page 0 is reserved (trash). The device block table is refreshed from
    ``tables()`` whenever assignments change.

    Prefix cache: FULL pages of prompt tokens are registered under a
    chained key (parent_key, page_tokens), so a later prompt sharing the
    prefix reuses the resident pages and only its suffix is prefilled.
    Pages are refcounted across slots; cached pages whose refcount drops to
    0 stay resident under the eviction policy until allocation pressure
    reclaims them. A matched page is immutable by construction — matches
    cover only positions strictly before the new prompt's last token, and
    decode writes start at the prompt's end.

    Tiers (``tiers.py``, ``prefix_index.py``): with a
    :class:`~.tiers.TierClient` wired (``tiers``), pages are also keyed by
    their chain hash (``prefix_index.chain_hash``), eviction SPILLS a
    reclaimed prefix page's bytes to the host/disk/object store instead
    of dropping them, and ``probe_prefix``/``match_prefix`` walk on past
    the resident chain by RESTORING tier-resident pages into freshly taken
    pages (fetch-on-miss). Restored pages register into the local cache
    and count toward ``prefix_hit_tokens`` where resident hits do, split
    by source tier in ``tier_hits``/``tier_hit_tokens``. Without tiers the
    walks stay hash-free: the default engine pays no sha256 per page."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_slot: int, tiers=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.tiers = tiers                              # TierClient | None
        self._free = list(range(num_pages - 1, 0, -1))  # page 0 reserved
        self._slots: dict[int, list[int]] = {}
        self._ref: dict[int, int] = {}                  # page -> live refs
        self._cached: dict[tuple, int] = {}             # chain key -> page
        self._page_key: dict[int, tuple] = {}           # page -> chain key
        self._page_hash: dict[int, tuple[bytes, bytes]] = {}  # page -> (hash, parent)
        self._lru = PrefixEvictionPolicy()              # ref==0 resident pages
        # the source tier of a restored page until a successful allocate
        # consumes the hit: the per-tier split of prefix_hit_tokens
        self._restored_tier: dict[int, str] = {}
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.tier_hits = dict.fromkeys(TIERS, 0)
        self.tier_hit_tokens = dict.fromkeys(TIERS, 0)
        self.peak_pages_in_use = 0
        # rows whose page list changed since tables() was last read: steady
        # decode leaves this empty and the engine skips the table upload
        self._dirty: set[int] = set()
        self._table = np.zeros((max_slots, max_pages_per_slot), dtype=np.int32)

    @property
    def dirty(self) -> bool:
        """True iff some block-table row changed since the last tables()."""
        return bool(self._dirty)

    def dirty_rows(self) -> list[int]:
        """The block-table rows changed since the last tables()."""
        return sorted(self._dirty)

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    def avg_slot_pages(self) -> int:
        """Average page footprint of the active slots (the typical
        admission cost); max_pages_per_slot when none is active."""
        if not self._slots:
            return self.max_pages_per_slot
        total = sum(len(pages) for pages in self._slots.values())
        return max(1, total // len(self._slots))

    def slot_pages(self, slot: int) -> int:
        """Pages one slot holds."""
        return len(self._slots.get(slot, ()))

    def _track_peak(self) -> None:
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def _take_page(self) -> int:
        """A writable page: prefer truly free, else reclaim the eviction
        policy's victim (dropping its prefix-cache registration). With
        tiers wired the victim's bytes SPILL on the way out."""
        if self._free:
            return self._free.pop()
        page = self._lru.victim()
        if page is None:  # callers gate on free_pages; this is a bug trap
            raise RuntimeError("page pool exhausted with nothing evictable")
        self._lru.discard(page)
        key = self._page_key.pop(page, None)
        if key is not None and self._cached.get(key) == page:
            del self._cached[key]
            self._evict_page(page, key)
        self._page_hash.pop(page, None)
        self._restored_tier.pop(page, None)
        return page

    def _evict_page(self, page: int, key: tuple) -> None:
        """Spill instead of drop: hand the evicted page's bytes to the
        tier store (the device read runs on the calling dispatch thread,
        before the page's new tenant can write it) and move its index
        residency from HBM to the tier."""
        tiers = self.tiers
        if tiers is None:
            return
        hashed = self._page_hash.get(page)
        if hashed is not None:
            key_hash, parent = hashed
            tiers.spill(key_hash, parent, key[1], page)
            tiers.unpublish_hbm(key_hash)

    def _release_page(self, page: int) -> None:
        current = self._ref.get(page, 1)
        self._ref[page] = current - 1
        if self._ref[page] > 0:
            return
        del self._ref[page]
        if page in self._page_key:       # registered prefix page: keep warm
            self._lru.add(page)
        else:
            self._free.append(page)

    # ------------------------------------------------------------ prefix cache

    def _chain_keys(self, prompt_ids: list[int], full: bool = False):
        """Chain keys of the prompt's full pages, in depth order: the
        MATCHABLE pages by default (a match never covers the last token),
        or every full page with ``full=True`` (the registration walk)."""
        if full:
            max_pages = len(prompt_ids) // self.page_size
        else:
            max_pages = max(0, (len(prompt_ids) - 1) // self.page_size)
        key: tuple = ()
        for i in range(max_pages):
            key = (key, tuple(prompt_ids[i * self.page_size:
                                         (i + 1) * self.page_size]))
            yield key

    def _chain_steps(self, prompt_ids: list[int], full: bool = False):
        """``(key, key_hash, parent_hash, chunk)`` per page of the
        ``_chain_keys`` walk: the hashes are ``prefix_index.chain_hash``,
        the one chain identity the allocator, the tier store and a pool
        index share."""
        parent = ROOT_HASH
        for key in self._chain_keys(prompt_ids, full):
            chunk = key[1]
            key_hash = chain_hash(parent, chunk)
            yield key, key_hash, parent, chunk
            parent = key_hash

    def _walk_prefix(self, prompt_ids: list[int]) -> list[int]:
        """Pages of the longest cached full-page prefix."""
        pages: list[int] = []
        for key in self._chain_keys(prompt_ids):
            page = self._cached.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def probe_prefix(self, prompt_ids: list[int]) -> int:
        """Read-only: tokens a match WOULD cover. Takes no references. With
        tiers wired the walk continues past the resident chain through
        tier-resident pages, capped at the restore capacity (free plus
        evictable pages): a probe must never promise a history the match
        cannot restore, or admission would re-probe the same prompt
        forever."""
        if self.tiers is None or not self.tiers.active:
            return len(self._walk_prefix(prompt_ids)) * self.page_size
        n = 0
        restorable = self.free_pages
        for key, key_hash, _parent, _chunk in self._chain_steps(prompt_ids):
            page = self._cached.get(key)
            if page is not None:
                if page in self._lru:
                    # matching pins a ref==0 resident page, which takes one
                    # unit of the capacity restores draw from
                    restorable -= 1
                n += 1
            elif restorable > 0 and self.tiers.probe(key_hash):
                n += 1
                restorable -= 1
            else:
                break
        return n * self.page_size

    def match_prefix(self, prompt_ids: list[int]) -> tuple[int, list[int]]:
        """Longest cached full-page prefix of ``prompt_ids``: returns
        (n_tokens_matched, pages) and takes a REFERENCE on every matched
        page (the caller assigns them to a slot or calls release_prefix).
        With tiers wired, chain pages missing from the pool but held by
        the store are RESTORED here (fetch-on-miss): a page is taken
        (evicting, and so spilling, colder pages if need be), the verified
        payload is written into it, and it registers into the local cache.
        A failed restore (payload gone, a hash collision, no page) ends the
        match at the pages already secured."""
        if self.tiers is None:  # the hash-free walk of the tier-less default
            pages = self._walk_prefix(prompt_ids)
            for page in pages:
                self._ref[page] = self._ref.get(page, 0) + 1
                self._lru.pop(page, None)
            self._track_peak()
            return len(pages) * self.page_size, pages
        tiered = self.tiers.active
        pages: list[int] = []
        for key, key_hash, parent, chunk in self._chain_steps(prompt_ids):
            page = self._cached.get(key)
            if page is not None:
                self._ref[page] = self._ref.get(page, 0) + 1
                self._lru.pop(page, None)
                pages.append(page)
                continue
            if not tiered or not (self._free or len(self._lru)):
                break
            if not self.tiers.probe(key_hash):
                break
            page = self._take_page()
            tier = self.tiers.restore(key_hash, parent, chunk, page)
            if tier is None:
                self._free.append(page)   # a miss or a collision: hand it back
                break
            self._ref[page] = 1
            self._cached[key] = page
            self._page_key[page] = key
            self._page_hash[page] = (key_hash, parent)
            self._restored_tier[page] = tier
            self.tiers.publish_hbm(key_hash)
            pages.append(page)
        self._track_peak()
        return len(pages) * self.page_size, pages

    def release_prefix(self, pages: list[int]) -> None:
        """Drop the references taken by match_prefix (request not admitted)."""
        for page in reversed(pages):
            self._release_page(page)

    def spill_resident_prefix(self) -> int:
        """Spill on drain: push every ref==0 registered prefix page through
        the tier spill path before this pool is torn down, so a rebuilt
        engine (or a pool sibling) restores the prefix corpus on a miss
        instead of prefilling it again. Pages in use are untouched, and
        the spilled pages stay resident (a copy, not an eviction). Returns
        the pages now in the store (chains already spilled count)."""
        tiers = self.tiers
        if tiers is None or not tiers.active:
            return 0
        spilled = 0
        for page in list(self._lru):
            key = self._page_key.get(page)
            hashed = self._page_hash.get(page)
            if key is None or hashed is None:
                continue
            key_hash, parent = hashed
            if tiers.spill(key_hash, parent, key[1], page):
                spilled += 1
        return spilled

    def spill_chain(self, prompt_ids: list[int]) -> int:
        """Copy one prompt's registered chain pages (every full page: what
        a continuation of the prompt can match) into the tier store, the
        seam of a prefill -> decode migration. The pages stay resident and
        referenced. Dispatch thread only (device reads). Returns the pages
        now in the store."""
        tiers = self.tiers
        if tiers is None or not tiers.active:
            return 0
        spilled = 0
        for key, key_hash, parent, chunk in self._chain_steps(prompt_ids, full=True):
            page = self._cached.get(key)
            if page is None:
                break  # an unregistered depth: nothing deeper can verify
            if tiers.spill(key_hash, parent, chunk, page):
                spilled += 1
        return spilled

    def register_prefix(self, slot: int, prompt_ids: list[int]) -> None:
        """Register the slot's full prompt pages for future reuse (with
        tiers, under their chain hashes too, published as resident here).
        First registration of a chain key wins; later identical pages stay
        private and simply free when their slot does."""
        pages = self._slots.get(slot, [])
        if self.tiers is None:
            steps = ((key, None, None, None)
                     for key in self._chain_keys(prompt_ids, full=True))
        else:
            steps = self._chain_steps(prompt_ids, full=True)
        for i, (key, key_hash, parent, _chunk) in enumerate(steps):
            if i >= len(pages):
                break
            page = pages[i]
            if key not in self._cached and page not in self._page_key:
                self._cached[key] = page
                self._page_key[page] = key
                if key_hash is not None:
                    self._page_hash[page] = (key_hash, parent)
                    self.tiers.publish_hbm(key_hash)

    # -------------------------------------------------------------- slot pages

    def allocate_slot(self, slot: int, n_tokens: int,
                      prefix_pages: list[int] | None = None) -> bool:
        """Assign pages for a sequence of n_tokens to ``slot``; the first
        ``prefix_pages`` (already referenced via match_prefix) are shared."""
        shared = prefix_pages or []
        needed = self.pages_needed(n_tokens)
        fresh = needed - len(shared)
        if (fresh > len(self._free) + len(self._lru)
                or needed > self.max_pages_per_slot or fresh < 0):
            return False
        if shared:  # hits are counted when the match is CONSUMED
            self.prefix_hits += 1
            self.prefix_hit_tokens += len(shared) * self.page_size
            for page in shared:
                # the same consume event, split by tier: a restored page
                # carries its source tier until first consumed
                tier = self._restored_tier.pop(page, "hbm")
                self.tier_hits[tier] += 1
                self.tier_hit_tokens[tier] += self.page_size
        pages = list(shared)
        for _ in range(fresh):
            page = self._take_page()
            self._ref[page] = self._ref.get(page, 0) + 1
            pages.append(page)
        self._slots[slot] = pages
        self._dirty.add(slot)
        self._track_peak()
        return True

    def grow_slot(self, slot: int, n_tokens: int) -> int:
        """Best-effort growth toward ``n_tokens`` total capacity; returns
        the slot's token capacity (pages * page_size) after growth."""
        pages = self._slots.get(slot)
        missing = pages is None
        if missing:
            pages = []
        needed = self.pages_needed(n_tokens)
        grew = False
        while len(pages) < needed:
            if not (self._free or self._lru) \
                    or len(pages) >= self.max_pages_per_slot:
                break
            page = self._take_page()
            self._ref[page] = self._ref.get(page, 0) + 1
            pages.append(page)
            grew = True
        if grew:
            if missing:
                self._slots[slot] = pages
            self._dirty.add(slot)
            self._track_peak()
        return len(pages) * self.page_size

    def pregrant_block(self, slot: int, n_ctx: int, k: int) -> int:
        """Grant the pages of a K-token decode super-step in one call;
        returns the usable token budget (0..k). ``n_ctx`` counts the row's
        tokens including the input token at position n_ctx - 1, whose KV
        this dispatch writes; the last of the k sampled tokens is written
        only as the next dispatch's input, so the capacity needed is
        n_ctx + k - 1 tokens."""
        if k <= 0:
            return 0
        capacity = self.grow_slot(slot, n_ctx + k - 1)
        return max(0, min(k, capacity - (n_ctx - 1)))

    def move_slot(self, old: int, new: int) -> None:
        """Reassign a slot's pages to a free slot id (compaction): pages
        are slot-agnostic, so only the mapping and two table rows move."""
        if new in self._slots:
            raise RuntimeError(f"move_slot: slot {new} is occupied")
        if old in self._slots:
            self._slots[new] = self._slots.pop(old)
            self._dirty.add(old)
            self._dirty.add(new)

    def free_slot(self, slot: int) -> None:
        pages = self._slots.pop(slot, [])
        if pages:
            self._dirty.add(slot)
        for page in reversed(pages):
            self._release_page(page)

    def tables(self, pin: bool = False) -> torch.Tensor:
        """The block table as a fresh CPU int32 tensor, in page-locked
        memory with ``pin`` (so a non-blocking upload can read it while the
        host goes on; the caching host allocator keeps the block until the
        copy is done). Only dirty rows are rebuilt in the cached host
        table; reading clears the dirty set."""
        for slot in self._dirty:
            row = self._table[slot]
            row[:] = 0
            pages = self._slots.get(slot)
            if pages:
                row[:len(pages)] = pages
        self._dirty.clear()
        table = torch.from_numpy(self._table)
        return table.pin_memory() if pin else table.clone()
