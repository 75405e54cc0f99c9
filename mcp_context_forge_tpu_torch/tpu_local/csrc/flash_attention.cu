// Causal prefill attention with a key-validity mask, for Hopper (sm_90a).
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/attention.py,
// flash_attention_pallas (kernel body _flash_kernel), which the JAX engine
// reaches from models/llama.py prefill through causal_attention.
//
// What bounds it: FLOPs grow as S^2 (4*hd per attended (query, key) pair and
// head) against bytes growing as S; at Llama-3-8B's 32 query / 8 KV heads
// the FLOP bound passes the byte bound near S = 740, so the 2048 bucket is
// FLOP-bound and the 512 bucket is just on the byte side.
// This kernel runs the FLOPs on the f32 FMA pipes (no tensor cores) and
// keeps the S x S scores out of device memory: each CTA walks key tiles up
// to its causal frontier only, staging K/V once for all G query heads of a
// KV group (the JAX kernel repeated K/V to H heads before the call). It
// serves f32 inputs and the head dims the tensor-core kernel
// (flash_attention_tc.cu: bf16 at hd 64 and 128) does not take; the
// wrapper's flash_route chooses by dtype and hd.
//
// Semantics: out[b, s, h] = softmax_c(q.k_c / sqrt(hd)) @ v over keys
// c <= s with valid[b, c]; masked scores are -1e30, so a padding row stays
// finite. Any S (the ragged edge is masked), any hd <= 256 divisible by 8.
#include "attention_tile.cuh"

extern "C" int mcf_flash_attention(const void* q, const void* k, const void* v,
                                   const void* valid, void* out, int B, int S,
                                   int H, int KV, int hd, int dtype,
                                   void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  mcf::AttnParams p{};
  p.q = q;
  p.out = out;
  p.k = k;
  p.v = v;
  p.key_valid = static_cast<const uint8_t*>(valid);
  p.B = B;
  p.S = S;
  p.KV = KV;
  p.G = H / KV;
  p.hd = hd;
  p.Sk = S;
  p.scale = 1.0f / sqrtf((float)hd);
  return mcf::launch_attn_dtype<256, 32, false>(p, dtype,
                                                static_cast<cudaStream_t>(stream));
}
