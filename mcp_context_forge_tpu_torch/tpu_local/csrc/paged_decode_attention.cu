// Single-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:199,
// paged_decode_attention_pallas (kernel body _kernel): bf16/f32 pages in
// mcf_paged_decode_attention; int8 pages with per-(page, kv head) scales
// (the quantized=True body, paged_attention.py:59-61) in
// mcf_paged_decode_attention_q8. The JAX engine runs it for every decoded
// token from models/llama.py decode_step.
//
// What bounds it: HBM bytes. Each row reads seq_len * KV * hd keys and as
// many values, and does 4*hd FLOPs per key and query head: G = 4 query heads
// per KV head at Llama-3-8B is about 2 FLOPs per byte of bf16 (4 of int8),
// far below the ~295 at which the tensor cores would become the limit.
// Int8 pages halve those bytes; the kernel reads 8 values with one 8-byte
// load and multiplies them by the page's scale in f32 as it stages them.
// This first version gives one CTA of 64 threads to each (row, KV head): it
// stages 64-key tiles of K and V once for all G query heads of the group,
// resolving pages through the block table itself, and walks only the
// ceil(seq_len / 64) tiles the row holds. At max_batch 8 and 8 KV heads that
// is 64 CTAs on 132 SMs, so the card is under-filled; splitting the key walk
// across CTAs (flash-decoding) is the redesign's first job.
//
// Semantics: keys c < seq_lens[b] are attended; a row with seq_len 0 walks
// no tile and writes zeros (its running sum stays 0 and is floored at 1e-30).
#include "attention_tile.cuh"

namespace {

template <bool Q8>
int decode(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* seq_lens, void* out, int B, int KV, int G, int hd,
           int page_size, int P, int dtype, void* stream) {
  mcf::AttnParams p{};
  p.q = q;
  p.out = out;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.tables = static_cast<const int32_t*>(tables);
  p.seq_lens = static_cast<const int32_t*>(seq_lens);
  p.B = B;
  p.S = 1;
  p.KV = KV;
  p.G = G;
  p.hd = hd;
  p.page_size = page_size;
  p.P = P;
  p.scale = 1.0f / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mcf::launch_attn_dtype<64, 64, true, Q8>(p, dtype, s);
}

}  // namespace

extern "C" int mcf_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* tables,
                                          const void* seq_lens, void* out, int B,
                                          int KV, int G, int hd, int page_size,
                                          int P, int dtype, void* stream) {
  return decode<false>(q, k_pages, v_pages, nullptr, nullptr, tables, seq_lens, out, B,
                       KV, G, hd, page_size, P, dtype, stream);
}

// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:199 with
// k_scales/v_scales (int8 pages). k_scales, v_scales: [N, KV] in dtype.
extern "C" int mcf_paged_decode_attention_q8(const void* q, const void* k_pages,
                                             const void* v_pages, const void* k_scales,
                                             const void* v_scales, const void* tables,
                                             const void* seq_lens, void* out, int B,
                                             int KV, int G, int hd, int page_size,
                                             int P, int dtype, void* stream) {
  return decode<true>(q, k_pages, v_pages, k_scales, v_scales, tables, seq_lens, out, B,
                      KV, G, hd, page_size, P, dtype, stream);
}
