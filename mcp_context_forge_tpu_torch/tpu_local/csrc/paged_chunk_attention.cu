// Multi-query attention over a paged KV pool on the FMA tile engine, for
// Hopper (sm_90a): the cases the tensor-core kernel
// (paged_chunk_attention_tc.cu: bf16 queries at hd 64/128, page_size a
// multiple of 64) does not take, which are f32 queries and pages, and bf16
// at other head dims or page sizes; ops/paged_attention.py chunk_route
// chooses.
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148,
// paged_chunk_attention_pallas (kernel body _chunk_kernel): bf16/f32 pages
// in mcf_paged_chunk_attention; int8 pages with per-(page, kv head) scales
// (the quantized=True body, paged_attention.py:111-113) in
// mcf_paged_chunk_attention_q8. The JAX engine reaches it from
// models/llama.py prefill_with_history: the suffix prefill of a prefix-cache
// hit and every round of a chunked prefill.
//
// What bounds it: at serving widths the KV pages a row walks (history plus
// the chunk just written) are read once per KV head and serve all S*G query
// rows of the group, so a short chunk over a long history is bound by the
// pages' bytes; a 512-query chunk over thousands of keys is FLOP-bound.
// This version stages each key tile in shared memory once per CTA (all G
// heads of a KV group share it), loads the block table itself (there is no
// scalar prefetch on this card) and walks pages only up to the tile's
// largest query position. Int8 pages are read 8 values per 8-byte load and
// multiplied by their page's scale in f32 as they are staged. Its FMAs are
// not the tensor cores: a redesign of these cases is still to come.
//
// Semantics: cache position c is attended iff c <= q_positions[b, s];
// q_positions = -1 marks a padding row, whose output is finite and unread.
#include "attention_tile.cuh"

namespace {

template <bool Q8>
int chunk(const void* q, const void* k_pages, const void* v_pages,
          const void* k_scales, const void* v_scales, const void* tables,
          const void* q_positions, void* out, int B, int S, int KV, int G,
          int hd, int page_size, int P, int dtype, void* stream) {
  mcf::AttnParams p{};
  p.q = q;
  p.out = out;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mcf::launch_attn_dtype<256, 32, Q8>(p, dtype, s);
}

}  // namespace

extern "C" int mcf_paged_chunk_attention(const void* q, const void* k_pages,
                                         const void* v_pages, const void* tables,
                                         const void* q_positions, void* out,
                                         int B, int S, int KV, int G, int hd,
                                         int page_size, int P, int dtype,
                                         void* stream) {
  return chunk<false>(q, k_pages, v_pages, nullptr, nullptr, tables, q_positions, out, B,
                      S, KV, G, hd, page_size, P, dtype, stream);
}

// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148 with
// k_scales/v_scales (int8 pages). k_scales, v_scales: [N, KV] in dtype.
extern "C" int mcf_paged_chunk_attention_q8(const void* q, const void* k_pages,
                                            const void* v_pages, const void* k_scales,
                                            const void* v_scales, const void* tables,
                                            const void* q_positions, void* out,
                                            int B, int S, int KV, int G, int hd,
                                            int page_size, int P, int dtype,
                                            void* stream) {
  return chunk<true>(q, k_pages, v_pages, k_scales, v_scales, tables, q_positions, out,
                     B, S, KV, G, hd, page_size, P, dtype, stream);
}
