"""Attention, grouped experts and the int8 KV writers: the hand-written
CUDA kernels (``csrc/``), their wrappers and their plain PyTorch versions."""


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
