// Multi-query attention over a paged KV pool on Hopper's tensor cores
// (sm_90a): bf16 queries at head dims 64 and 128, on bf16 pages or on int8
// pages with one scale per (page, KV head); page_size a multiple of 64.
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148,
// paged_chunk_attention_pallas (kernel body _chunk_kernel): bf16 pages in
// mcf_paged_chunk_attention_tc, int8 pages (the quantized=True body,
// paged_attention.py:111-113) in mcf_paged_chunk_attention_tc_q8. The JAX
// engine reaches it from models/llama.py prefill_with_history: the suffix
// prefill of a prefix-cache hit and every round of a chunked prefill. f32
// pages, other head dims and other page sizes take the mma.sync kernel
// (paged_chunk_attention_mma.cu); ops/paged_attention.py chunk_route chooses.
//
// What bounds it: a 2048-query round over thousands of cached keys is
// FLOP-bound (4*hd per attended (query, key) pair and head against 1 or 2
// bytes per key element read once per KV head); a short suffix over a long
// history is bound by the pages' bytes. The design is the flash kernel's
// (attention_tc.cuh, shared with flash_attention_tc.cu):
//   - one CTA owns 128 query rows r = s*G + g of one (batch row, KV head)
//     in two consumer warpgroups; Q goes once into 128-byte-swizzled shared
//     memory; S = Q K^T and O += P V run as wgmma m64nNk16, P fed from
//     registers, V read MN-major;
//   - K/V tiles of 64 keys come from the pages by TMA: a 4-D tensor map
//     over one layer's pool [N, page, KV, hd] whose page coordinate is read
//     from the block table, which the CTA loads into shared memory itself
//     (there is no scalar prefetch on this card); a page of 128 is two
//     tiles; the same four-stage mbarrier ring as the flash kernel;
//   - int8 pages: TMA brings the int8 tile into a staging ring; all 256
//     threads widen it to bf16 (exact: |v| <= 127) into the swizzled
//     operand layout, double-buffered, one CTA barrier per tile (the
//     widening overlaps the previous tile's P V). The tile's page K scale
//     multiplies S in f32 before the softmax, and its V scale multiplies P
//     in f32 before P is rounded to bf16; the scales are never folded into
//     bf16 K/V, which would round the dequantized values the plain version
//     keeps in f32;
//   - causality by position: a CTA walks tiles up to max(q_positions) + 1
//     over its rows; tiles below the least position need no mask, and
//     tiles past the frontier are not read;
//   - the CTAs with the longest walks launch first: every CTA ranks the
//     batch rows by their largest position and takes the work of its rank,
//     the last query blocks of the longest row first.
//
// Semantics: cache position c is attended iff c <= q_positions[b, s];
// q_positions = -1 marks a padding row, whose output is finite and unread.
#include "attention_tc.cuh"

namespace {

using namespace tc;

struct ChunkParams {
  const __nv_bfloat16* q;          // [B, S, KV*G, hd]
  __nv_bfloat16* out;              // [B, S, KV*G, hd]
  const int32_t* tables;           // [B, P]
  const int32_t* q_pos;            // [B, S], -1 = padding
  const __nv_bfloat16* k_scales;   // int8 pages: [N, KV]
  const __nv_bfloat16* v_scales;
  int B, S, KV, G, page_size, P;
  float scale_log2;                // log2(e) / sqrt(hd)
};

// Shared memory, from a 1024-byte-aligned base: Q; the TMA ring (bf16:
// STAGES x {K, V} swizzled operands; int8: STAGES x {K, V} [TK][HD] int8);
// int8 only: two widened bf16 {K, V} operand buffers; the ring's barriers
// and release counts; scratch for the CTA's reductions; then the walked
// pages (int8: and their K and V scales in f32) and each batch row's
// largest position.
template <int HD, bool Q8>
struct Layout {
  using T = Tiles<HD>;
  static constexpr int kRaw = 2 * TK * HD;  // one int8 stage
  static constexpr int kRing = Q8 ? STAGES * kRaw : STAGES * T::kStage;
  static constexpr int kOps = Q8 ? 2 * T::kStage : 0;
  static constexpr int kBars = T::kQ + kRing + kOps;
  static constexpr int kMisc = kBars + 64;
  static constexpr int kPages = kMisc + 128;
  static size_t bytes(int P, int B) {
    return 1024 + kPages + (size_t)P * 4 * (Q8 ? 3 : 1) + (size_t)B * 4;
  }
};

// The int8 K and V of tile t into its staging stage.
template <int HD, bool Q8>
__device__ __forceinline__ void load_raw(const Ring& ring, int t) {
  using L = Layout<HD, Q8>;
  const int st = t % STAGES;
  int row, outer;
  ring.coords(t, row, outer);
  const uint32_t bar = ring.bar_full + 8 * st;
  mbar_expect_tx(bar, L::kRaw);
  const uint32_t dst = ring.tiles + st * L::kRaw;
  tma_load_4d(dst, ring.tm_k, bar, 0, ring.kvh, row, outer);
  tma_load_4d(dst + TK * HD, ring.tm_v, bar, 0, ring.kvh, row, outer);
}

// int8 K and V [TK][HD] at ``raw`` widened to bf16 operands at ``ops`` (K,
// then V one Tiles<HD>::kTile later), 128-byte swizzled as TMA would have
// written them; one 8-value chunk per step of each thread.
template <int HD>
__device__ __forceinline__ void widen_tile(const unsigned char* raw, unsigned char* ops) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < 2 * TK * CH; i += NT) {
    const int kv = i / (TK * CH), j = i - kv * (TK * CH);
    const int r = j / CH, c = j - r * CH;
    const uint2 v8 = *reinterpret_cast<const uint2*>(raw + kv * TK * HD + r * HD + c * 8);
    const int8_t* x = reinterpret_cast<const int8_t*>(&v8);
    const uint4 w = make_uint4(pack_bf16((float)x[0], (float)x[1]),
                               pack_bf16((float)x[2], (float)x[3]),
                               pack_bf16((float)x[4], (float)x[5]),
                               pack_bf16((float)x[6], (float)x[7]));
    *reinterpret_cast<uint4*>(ops + kv * Tiles<HD>::kTile + (c / 8) * SLAB + r * 128 +
                              (((c % 8) ^ (r % 8)) << 4)) = w;
  }
}

// The int8 key walk: per tile, wait for its int8 stage, widen it into the
// operand buffer of its parity, let the previous tile's P V finish, meet
// the other warpgroup at the CTA barrier (the stage is then free for tile
// t + STAGES), and run S, the softmax with the page's scales, and P V.
template <int HD>
__device__ __forceinline__ void key_walk_q8(float (&o)[HD / 2], RowState& st, int n_tiles,
                                            uint32_t q_base, const Ring& ring,
                                            unsigned char* raw_base, unsigned char* ops_base,
                                            uint32_t ops_u32, const float* ks, const float* vs,
                                            int page_size, float scale_log2) {
  using L = Layout<HD, true>;
  using T = Tiles<HD>;
  float s[TK / 2];
  for (int t = 0; t < n_tiles; ++t) {
    const int stg = t % STAGES;
    mbar_wait(ring.bar_full + 8 * stg, (t / STAGES) & 1);
    widen_tile<HD>(raw_base + stg * L::kRaw, ops_base + (t % 2) * T::kStage);
    wgmma_wait<0>();  // P V of tile t - 1
    fence_regs(o);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0 && t + STAGES < n_tiles) load_raw<HD, true>(ring, t + STAGES);

    const uint32_t k_tile = ops_u32 + (t % 2) * T::kStage;
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) s[i] = 0.f;
    issue_scores<HD>(s, q_base, k_tile);
    wgmma_wait<0>();
    fence_regs(s);
    const int pg = (t * TK) / page_size;
    float mx0, mx1, corr0, corr1;
    mask_scores<false>(s, st, t, nullptr, scale_log2 * ks[pg], mx0, mx1);
    uint32_t pa[TK / 16][4];
    softmax_tile(s, st, mx0, mx1, vs[pg], pa, corr0, corr1);
    rescale<HD>(o, corr0, corr1);
    issue_pv<HD>(o, pa, k_tile + T::kTile);
  }
  wgmma_wait<0>();
  fence_regs(o);
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(NT, 1)
    chunk_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, ChunkParams p) {
  using L = Layout<HD, Q8>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::kBars;  // [STAGES] x 8 bytes
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + L::kBars + 8 * STAGES);
  int* misc = reinterpret_cast<int*>(smem + L::kMisc);  // [0] row, [2 + 2w] warp max/min
  int* pages = reinterpret_cast<int*>(smem + L::kPages);
  float* ks = reinterpret_cast<float*>(pages + p.P);
  float* vs = ks + p.P;
  int* row_max = Q8 ? reinterpret_cast<int*>(vs + p.P) : reinterpret_cast<int*>(ks);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S, G = p.G, KV = p.KV, H = KV * G, R = S * G;
  const int QB = (R + BM - 1) / BM;

  // the longest walks first: rank the batch rows by their largest position
  for (int b = warp; b < p.B; b += NT / 32) {
    int m = -1;
    for (int s = lane; s < S; s += 32) m = max(m, p.q_pos[(long long)b * S + s]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, sh));
    if (lane == 0) row_max[b] = m;
  }
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      released[st] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int rank = blockIdx.x / (QB * KV), rem = blockIdx.x % (QB * KV);
  const int qb = QB - 1 - rem / KV, kvh = rem % KV;
  for (int b = tid; b < p.B; b += NT) {
    const int mb = row_max[b];
    int rk = 0;
    for (int b2 = 0; b2 < p.B; ++b2) {
      const int m2 = row_max[b2];
      rk += (m2 > mb) || (m2 == mb && b2 < b);
    }
    if (rk == rank) misc[0] = b;
  }
  __syncthreads();
  const int b = misc[0];
  const int r0 = qb * BM;

  // the block's largest position (its causal frontier) and least real one
  {
    int hi = -1, lo = 0x7fffffff;
    if (tid < BM && r0 + tid < R) {
      const int pos = p.q_pos[(long long)b * S + (r0 + tid) / G];
      hi = pos;
      if (pos >= 0) lo = pos;
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) {
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, sh));
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, sh));
    }
    if (lane == 0 && warp < BM / 32) {
      misc[2 + 2 * warp] = hi;
      misc[3 + 2 * warp] = lo;
    }
  }
  __syncthreads();
  int pos_hi = -1, pos_lo = 0x7fffffff;
#pragma unroll
  for (int w = 0; w < BM / 32; ++w) {
    pos_hi = max(pos_hi, misc[2 + 2 * w]);
    pos_lo = min(pos_lo, misc[3 + 2 * w]);
  }
  const int n_keys = min(pos_hi + 1, p.P * p.page_size);
  const int n_tiles = n_keys > 0 ? (n_keys + TK - 1) / TK : 0;
  const int n_pages = n_keys > 0 ? (n_keys + p.page_size - 1) / p.page_size : 0;

  for (int i = tid; i < n_pages; i += NT) {
    const int page = p.tables[(long long)b * p.P + i];
    pages[i] = page;
    if (Q8) {
      ks[i] = __bfloat162float(p.k_scales[(long long)page * KV + kvh]);
      vs[i] = __bfloat162float(p.v_scales[(long long)page * KV + kvh]);
    }
  }
  load_q<HD>(smem, p.q, b, S, H, G, kvh, r0);
  // Q was written through the generic proxy; wgmma reads through the async one
  fence_proxy_async();
  __syncthreads();

  const Ring ring{&tm_k, &tm_v, base + Tiles<HD>::kQ, bar_full, released, kvh, b, pages,
                  p.page_size};
  if (tid == 0) {  // the first stages; the rest are refilled as they are released
    for (int t = 0; t < min(n_tiles, STAGES); ++t) {
      if (Q8) load_raw<HD, Q8>(ring, t);
      else load_tile<HD>(ring, t);
    }
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the block; this
  // thread holds rows lr and lr + 8 of the accumulator fragments, columns
  // j*8 + col + {0, 1}
  const int wg = tid / 128;
  const int lr = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  auto row_pos = [&](int r) {
    const int gr = r0 + r;
    return gr < R ? p.q_pos[(long long)b * S + gr / G] : -1;
  };
  RowState st{kNegInf, kNegInf, 0.f, 0.f, row_pos(lr), row_pos(lr + 8), (lane % 4) * 2, pos_lo};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const uint32_t q_base = base + wg * 64 * 128;
  if constexpr (Q8) {
    const uint32_t ops = base + Tiles<HD>::kQ + L::kRing;
    key_walk_q8<HD>(o, st, n_tiles, q_base, ring, smem + Tiles<HD>::kQ,
                    smem + Tiles<HD>::kQ + L::kRing, ops, ks, vs, p.page_size, p.scale_log2);
  } else {
    key_walk<HD, false>(o, st, n_tiles, q_base, ring, nullptr, p.scale_log2);
  }
  store_rows<HD>(o, st, p.out, b, S, H, G, kvh, r0, lr);
}

template <int HD, bool Q8>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
           const void* v_scales, const void* tables, const void* q_positions, void* out, int B,
           int S, int KV, int G, int page_size, int P, int num_pages, cudaStream_t stream) {
  // one layer's pool [N, page, KV, hd]: bf16 boxes of 64 columns x TK rows
  // (swizzled operands), int8 boxes of the whole head x TK rows (staged)
  CUtensorMap tm_k, tm_v;
  const int box0 = Q8 ? HD : 64;
  if (!map_4d(&tm_k, k_pages, Q8, num_pages, page_size, KV, HD, box0) ||
      !map_4d(&tm_v, v_pages, Q8, num_pages, page_size, KV, HD, box0))
    return (int)cudaErrorInvalidValue;
  ChunkParams p{static_cast<const __nv_bfloat16*>(q),
                static_cast<__nv_bfloat16*>(out),
                static_cast<const int32_t*>(tables),
                static_cast<const int32_t*>(q_positions),
                static_cast<const __nv_bfloat16*>(k_scales),
                static_cast<const __nv_bfloat16*>(v_scales),
                B, S, KV, G, page_size, P,
                1.4426950408889634f / sqrtf((float)HD)};
  const size_t smem = Layout<HD, Q8>::bytes(P, B);
  cudaError_t err = cudaFuncSetAttribute(chunk_tc_kernel<HD, Q8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)B * KV * ((S * G + BM - 1) / BM);
  chunk_tc_kernel<HD, Q8><<<(unsigned)ctas, NT, smem, stream>>>(tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

template <bool Q8>
int chunk(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
          const void* v_scales, const void* tables, const void* q_positions, void* out, int B,
          int S, int KV, int G, int hd, int page_size, int P, int num_pages, int dtype,
          void* stream) {
  if (dtype != 0 || KV <= 0 || G <= 0 || P <= 0 || num_pages <= 0 || page_size <= 0 ||
      page_size % TK != 0)
    return (int)cudaErrorInvalidValue;
  if (Q8 && (k_scales == nullptr || v_scales == nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, Q8>(q, k_pages, v_pages, k_scales, v_scales, tables, q_positions, out, B,
                           S, KV, G, page_size, P, num_pages, s);
  if (hd == 64)
    return launch<64, Q8>(q, k_pages, v_pages, k_scales, v_scales, tables, q_positions, out, B,
                          S, KV, G, page_size, P, num_pages, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: [B, S, KV, G, hd] bf16; pages: [num_pages, page_size, KV, hd]
// bf16; tables: [B, P] int32; q_positions: [B, S] int32. hd 64 or 128,
// page_size a multiple of 64; dtype is the wrappers' code, bf16 (0) only.
extern "C" int mcf_paged_chunk_attention_tc(const void* q, const void* k_pages,
                                            const void* v_pages, const void* tables,
                                            const void* q_positions, void* out, int B, int S,
                                            int KV, int G, int hd, int page_size, int P,
                                            int num_pages, int dtype, void* stream) {
  return chunk<false>(q, k_pages, v_pages, nullptr, nullptr, tables, q_positions, out, B, S, KV,
                      G, hd, page_size, P, num_pages, dtype, stream);
}

// The same over int8 pages; k_scales, v_scales: [num_pages, KV] bf16.
extern "C" int mcf_paged_chunk_attention_tc_q8(const void* q, const void* k_pages,
                                               const void* v_pages, const void* k_scales,
                                               const void* v_scales, const void* tables,
                                               const void* q_positions, void* out, int B, int S,
                                               int KV, int G, int hd, int page_size, int P,
                                               int num_pages, int dtype, void* stream) {
  return chunk<true>(q, k_pages, v_pages, k_scales, v_scales, tables, q_positions, out, B, S,
                     KV, G, hd, page_size, P, num_pages, dtype, stream);
}
