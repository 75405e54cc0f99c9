from .paged_cache import (PageAllocator, PagedKVState, PrefixEvictionPolicy,
                          gather_kv, init_kv_state, kv_page_bytes,
                          num_pages_for_budget, write_decode_kv,
                          write_prefill_kv)
from .prefix_index import PrefixIndex, chain_hash, chain_hashes
from .tiers import SpilledPage, TierClient, TieredPageStore

__all__ = ["PageAllocator", "PagedKVState", "PrefixEvictionPolicy",
           "gather_kv", "init_kv_state", "kv_page_bytes",
           "num_pages_for_budget", "write_decode_kv", "write_prefill_kv",
           "PrefixIndex", "chain_hash", "chain_hashes",
           "SpilledPage", "TierClient", "TieredPageStore"]
