"""Attention, grouped experts and the int8 KV writers: the hand-written
CUDA kernels (``csrc/``), their wrappers and their plain PyTorch versions."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

_local = threading.local()


def count_launch(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel: in its ``launches``, or,
    while this thread is inside ``capturing()``, in that block's own
    counts. Graph captures count there, so that a capture never moves the
    counts that another engine's thread in the process adds to (a pool's
    replica serving while its sibling is rebuilt)."""
    counts = getattr(_local, "counts", None)
    if counts is None:
        wrapper.launches += 1
    else:
        counts[wrapper.__name__] = counts.get(wrapper.__name__, 0) + 1


#: the key under which ``capturing()`` counts the serving collectives
COLLECTIVES = "collectives"


def count_collective(counter: dict[str, int]) -> None:
    """Count one serving collective (``parallel.collectives``): in
    ``counter["count"]``, or, inside ``capturing()``, under that block's
    ``COLLECTIVES`` (so that a capture counts its own graph's collectives,
    whatever another engine's thread calls meanwhile)."""
    counts = getattr(_local, "counts", None)
    if counts is None:
        counter["count"] += 1
    else:
        counts[COLLECTIVES] = counts.get(COLLECTIVES, 0) + 1


@contextlib.contextmanager
def capturing() -> Iterator[dict[str, int]]:
    """Launches on this thread inside the block count in the dict it
    yields (by wrapper name), not in the wrappers' ``launches``; so do the
    serving collectives (under ``COLLECTIVES``)."""
    previous = getattr(_local, "counts", None)
    _local.counts = counts = {}
    try:
        yield counts
    finally:
        _local.counts = previous


def kernel_wrappers() -> dict:
    """Every kernel's wrapper by name; each carries its ``launches``
    count (one per launch of its kernel)."""
    from . import attention, grouped_moe, kv_write, paged_attention
    return {"flash_attention_tc": attention.flash_attention_tc,
            "flash_attention_mma": attention.flash_attention_mma,
            "paged_chunk_attention_tc": paged_attention.paged_chunk_attention_tc,
            "paged_chunk_attention_tc_q8": paged_attention.paged_chunk_attention_tc_q8,
            "paged_chunk_attention_mma": paged_attention.paged_chunk_attention_mma,
            "paged_chunk_attention_mma_q8": paged_attention.paged_chunk_attention_mma_q8,
            "paged_decode_attention": paged_attention.paged_decode_attention,
            "paged_decode_attention_q8": paged_attention.paged_decode_attention_q8,
            "expert_blocks_tc": grouped_moe.expert_blocks_tc,
            "expert_blocks_tc_q8": grouped_moe.expert_blocks_tc_q8,
            "expert_blocks_wmma": grouped_moe.expert_blocks_wmma,
            "expert_blocks_wmma_q8": grouped_moe.expert_blocks_wmma_q8,
            "kv_quant_store_decode": kv_write.kv_quant_store_decode,
            "kv_quant_store_span": kv_write.kv_quant_store_span}
