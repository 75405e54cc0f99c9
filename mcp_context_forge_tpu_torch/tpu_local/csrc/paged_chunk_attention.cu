// Multi-query attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py,
// paged_chunk_attention_pallas (kernel body _chunk_kernel), bf16/f32 pages
// (the int8-page variant is not ported yet). The JAX engine reaches it from
// models/llama.py prefill_with_history: the suffix prefill of a prefix-cache
// hit.
//
// What bounds it: at serving widths the KV pages a row walks (history plus
// the chunk just written) are read once per KV head and serve all S*G query
// rows of the group, so for long histories the bytes of the pages bound it;
// a 128-query chunk over a short history is closer to FLOP-bound. This first
// version stages each key tile in shared memory once per CTA (all G heads of
// a KV group share it), loads the block table itself (there is no scalar
// prefetch on this card) and walks pages only up to the tile's largest query
// position. Tensor-core tiles and split-K come later.
//
// Semantics: cache position c is attended iff c <= q_positions[b, s];
// q_positions = -1 marks a padding row, whose output is finite and unread.
#include "attention_tile.cuh"

extern "C" int mcf_paged_chunk_attention(const void* q, const void* k_pages,
                                         const void* v_pages, const void* tables,
                                         const void* q_positions, void* out,
                                         int B, int S, int KV, int G, int hd,
                                         int page_size, int P, int dtype,
                                         void* stream) {
  mcf::AttnParams p{};
  p.q = q;
  p.out = out;
  p.k = k_pages;
  p.v = v_pages;
  p.tables = static_cast<const int32_t*>(tables);
  p.q_pos = static_cast<const int32_t*>(q_positions);
  p.B = B;
  p.S = S;
  p.KV = KV;
  p.G = G;
  p.hd = hd;
  p.page_size = page_size;
  p.P = P;
  p.scale = 1.0f / sqrtf((float)hd);
  return mcf::launch_attn_dtype<256, 32, true>(p, dtype,
                                               static_cast<cudaStream_t>(stream));
}
