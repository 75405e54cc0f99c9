// Multi-query attention over a paged KV pool on warp-level tensor-core
// tiles (mma.sync, sm_90a): the cases the wgmma kernel
// (paged_chunk_attention_tc.cu: bf16 queries at hd 64/128, page_size a
// multiple of 64) does not take, which are f32 queries and pages, bf16 at
// other head dims (gemma-2b's 256, the tiny configs' 16 and 32), and page
// sizes that are not a multiple of 64; ops/paged_attention.py chunk_route
// chooses.
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148,
// paged_chunk_attention_pallas (kernel body _chunk_kernel): bf16/f32 pages
// in mcf_paged_chunk_attention_mma; int8 pages with per-(page, kv head)
// scales (the quantized=True body, paged_attention.py:111-113) in
// mcf_paged_chunk_attention_mma_q8. The JAX engine reaches it from
// models/llama.py prefill_with_history: the suffix prefill of a prefix-cache
// hit and every round of a chunked prefill.
//
// What bounds it: a long chunk over thousands of cached keys is FLOP-bound
// (4*hd per attended (query, key) pair and head); a short suffix over a
// long history is bound by the pages' bytes. The design is the mma.sync
// flash kernel's (attention_mma.cuh, shared with flash_attention_mma.cu):
// four warps of 16 query rows r = s*G + g of one (batch row, KV head) to a
// CTA, so all G heads of a KV group share each staged key tile; tiles of
// 64 keys (32 at hd 256) by cp.async into a double buffer; bf16 as
// m16n8k16, f32 as 3xTF32 m16n8k8. It adds:
//   - key lookup through the block table: key c of the row is row
//     c % page_size of page tables[b, c / page_size], looked up per key as
//     the tile is staged, so any page size works; the CTA copies the pages
//     it walks into shared memory once (there is no scalar prefetch on this
//     card);
//   - causality by position: cache position c is attended iff
//     c <= q_positions[b, s]. A CTA walks tiles up to its largest position,
//     a warp masks only tiles past its least real position, and the CTAs
//     with the longest walks launch first (every CTA ranks the batch rows by
//     their largest position and takes the work of its rank);
//   - int8 pages: cp.async brings the int8 tile into a staging double
//     buffer; the CTA widens it (exact: |v| <= 127) into the tile the
//     fragments read, in the query's type. Each key's page K scale
//     multiplies its scores in f32 before the softmax and its V scale its
//     probabilities in f32 before P V (the sum takes them unscaled), so the
//     dequantized values are never rounded to bf16.
//
// Semantics: cache position c is attended iff c <= q_positions[b, s];
// q_positions = -1 marks a padding row, whose output is finite and unread.
#include "attention_mma.cuh"

namespace {

using namespace mma;

template <typename T>
struct ChunkParams {
  const T* q;               // [B, S, KV*G, hd]
  T* out;                   // [B, S, KV*G, hd]
  const void* k;            // pages [N, page, KV, hd] in T, or int8
  const void* v;
  const T* k_scales;        // int8 pages: [N, KV]
  const T* v_scales;
  const int32_t* tables;    // [B, P]
  const int32_t* q_pos;     // [B, S], -1 = padding
  int B, S, KV, G, hd, page_size, P;
  float scale_log2;         // log2(e) / sqrt(hd)
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 8 int8 values -> T at ``dst`` (16-byte aligned), exactly
__device__ __forceinline__ void widen8(uint2 v8, __nv_bfloat16* dst) {
  const int8_t* x = reinterpret_cast<const int8_t*>(&v8);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16((float)x[0], (float)x[1]), pack_bf16((float)x[2], (float)x[3]),
                 pack_bf16((float)x[4], (float)x[5]), pack_bf16((float)x[6], (float)x[7]));
}
__device__ __forceinline__ void widen8(uint2 v8, float* dst) {
  const int8_t* x = reinterpret_cast<const int8_t*>(&v8);
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// Shared memory (16-byte aligned pieces): Q [kRows][LD]; K, V tiles: two
// buffers each of [TKM][LD] (bf16/f32 pages: cp.async targets; int8 pages:
// one widened tile each, after the int8 staging buffers [2][2][TKM][HD]);
// int8 only: each walked key's K and V scale, and each walked page's; then
// the walked pages, each batch row's largest position and the CTA's
// reductions.
template <typename T, int HD, bool Q8>
struct Layout {
  using C = Cfg<T, HD>;
  static constexpr int kTile = C::TKM * C::LD * (int)sizeof(T);
  static constexpr int kQ = kRows * C::LD * (int)sizeof(T);
  static constexpr int kKV = kQ + (Q8 ? 2 : 4) * kTile;           // K, V tiles
  static constexpr int kRaw = Q8 ? 2 * 2 * C::TKM * HD : 0;        // int8 staging
  static constexpr int kKeyScales = kKV + kRaw;                    // [2][TKM] f32
  static constexpr int kPages = kKeyScales + (Q8 ? 2 * C::TKM * 4 : 0);
  static size_t bytes(int P, int B) {
    return (size_t)kPages + (size_t)P * 4 * (Q8 ? 3 : 1) + (size_t)B * 4 + 64;
  }
};

template <typename T, int HD, bool Q8>
__global__ void __launch_bounds__(32 * kWarps) chunk_mma_kernel(ChunkParams<T> p) {
  using C = Cfg<T, HD>;
  using L = Layout<T, HD, Q8>;
  constexpr int TKM = C::TKM, NB = TKM / 8, NT = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L::kQ);
  T* Vs = reinterpret_cast<T*>(smem + L::kQ + (Q8 ? 1 : 2) * L::kTile);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + L::kKV);       // [2 bufs][K, V][TKM][HD]
  float* key_ks = reinterpret_cast<float*>(smem + L::kKeyScales);  // [TKM]
  float* key_vs = key_ks + TKM;
  int* pages = reinterpret_cast<int*>(smem + L::kPages);
  float* page_ks = reinterpret_cast<float*>(pages + p.P);
  float* page_vs = page_ks + p.P;
  int* row_max = Q8 ? reinterpret_cast<int*>(page_vs + p.P) : reinterpret_cast<int*>(page_ks);
  int* misc = row_max + p.B;  // [0] batch row, [1 + w] warp maxima

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S, G = p.G, KV = p.KV, H = KV * G, R = S * G, hd = p.hd;
  const int page_size = p.page_size;
  const int QB = (R + kRows - 1) / kRows;

  // the longest walks first: rank the batch rows by their largest position
  for (int b = warp; b < p.B; b += kWarps) {
    int m = -1;
    for (int s = lane; s < S; s += 32) m = max(m, p.q_pos[(long long)b * S + s]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, sh));
    if (lane == 0) row_max[b] = m;
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
  const int r0 = qb * kRows;

  // this thread: rows g and g + 8 of its warp's 16, accumulator columns
  // nb*8 + 2*tg + {0, 1}; the warp's least real position (keys up to it
  // need no mask) and the CTA's largest (its frontier)
  const int g = lane / 4, tg = lane % 4;
  const int wr = warp * 16;
  auto row_pos = [&](int r) {
    const int gr = r0 + r;
    return gr < R ? p.q_pos[(long long)b * S + gr / G] : -1;
  };
  const int pos0 = row_pos(wr + g), pos1 = row_pos(wr + g + 8);
  int pos_first = min(pos0 >= 0 ? pos0 : 0x7fffffff, pos1 >= 0 ? pos1 : 0x7fffffff);
  int pos_hi = max(pos0, pos1);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    pos_first = min(pos_first, __shfl_xor_sync(0xffffffffu, pos_first, sh));
    pos_hi = max(pos_hi, __shfl_xor_sync(0xffffffffu, pos_hi, sh));
  }
  if (lane == 0) misc[1 + warp] = pos_hi;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) pos_hi = max(pos_hi, misc[1 + w]);
  const int n_keys = min(pos_hi + 1, p.P * page_size);
  const int n_tiles = n_keys > 0 ? (n_keys + TKM - 1) / TKM : 0;
  const int n_pages = n_keys > 0 ? (n_keys + page_size - 1) / page_size : 0;

  for (int i = tid; i < n_pages; i += NT) {
    const int page = p.tables[(long long)b * p.P + i];
    pages[i] = page;
    if (Q8) {
      page_ks[i] = to_f32(p.k_scales[(long long)page * KV + kvh]);
      page_vs[i] = to_f32(p.v_scales[(long long)page * KV + kvh]);
    }
  }
  __syncthreads();

  // K and V of tile t, key by key through the block table, into buffer
  // ``buf``: T rows of LD (bf16/f32 pages) or int8 rows of HD (staging);
  // keys past the frontier read zeros
  auto load_kv = [&](int t, int buf) {
    constexpr int EPC = Q8 ? 16 : C::EPC;   // elements per 16-byte chunk
    constexpr int CPR = HD / EPC;
    for (int i = tid; i < TKM * CPR; i += NT) {
      const int j = i / CPR, col = (i % CPR) * EPC;
      const int c = t * TKM + j;
      const bool ok = c < n_keys && col < hd;
      long long off = 0;
      if (ok) {
        const int slot = c / page_size;
        off = (((long long)pages[slot] * page_size + (c - slot * page_size)) * KV + kvh) * hd + col;
      }
      if constexpr (Q8) {
        int8_t* kd = raw + buf * 2 * TKM * HD;
        cp_async16(smem_u32(kd + j * HD + col), static_cast<const int8_t*>(p.k) + off, ok);
        cp_async16(smem_u32(kd + TKM * HD + j * HD + col), static_cast<const int8_t*>(p.v) + off,
                   ok);
      } else {
        cp_async16(smem_u32(Ks + buf * TKM * C::LD + j * C::LD + col),
                   static_cast<const T*>(p.k) + off, ok);
        cp_async16(smem_u32(Vs + buf * TKM * C::LD + j * C::LD + col),
                   static_cast<const T*>(p.v) + off, ok);
      }
    }
  };
  if (n_tiles > 0) {
    load_q<T, HD>(Qs, p.q, b, S, H, G, kvh, r0, hd);
    load_kv(0, 0);
  }
  cp_async_commit();

  const T* Qw = Qs + wr * C::LD;
  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and Q) has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // and every warp is done with the tile buffers of t - 1
    const int c0 = t * TKM;
    if constexpr (Q8) {
      // widen the staged int8 tile into the one K and V tile, and note each
      // key's scales (0 past the frontier)
      const int8_t* src = raw + (t & 1) * 2 * TKM * HD;
      for (int i = tid; i < 2 * TKM * (HD / 8); i += NT) {
        const int kv = i / (TKM * (HD / 8)), rem = i - kv * (TKM * (HD / 8));
        const int j = rem / (HD / 8), col = (rem % (HD / 8)) * 8;
        widen8(*reinterpret_cast<const uint2*>(src + kv * TKM * HD + j * HD + col),
               (kv == 0 ? Ks : Vs) + j * C::LD + col);
      }
      for (int j = tid; j < TKM; j += NT) {
        const int c = c0 + j;
        const int slot = c / page_size;
        key_ks[j] = c < n_keys ? page_ks[slot] : 0.f;
        key_vs[j] = c < n_keys ? page_vs[slot] : 0.f;
      }
      __syncthreads();
    }
    const T* kt = Ks + (Q8 ? 0 : (t & 1) * TKM * C::LD);
    const T* vt = Vs + (Q8 ? 0 : (t & 1) * TKM * C::LD);
    float s[NB][4];
    scores<T, HD>(s, Qw, kt, lane);

    // scale (int8: by each key's K scale) to base 2, mask by position, and
    // the online softmax; a tile wholly at or below the warp's least real
    // position needs no mask
    float mx0 = kNegInf, mx1 = kNegInf;
    const bool interior = c0 + TKM - 1 <= pos_first;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nb * 8 + 2 * tg + (e & 1);
        const float scale = Q8 ? p.scale_log2 * key_ks[kl] : p.scale_log2;
        const bool ok = interior || c0 + kl <= (e < 2 ? pos0 : pos1);
        const float x = ok ? s[nb][e] * scale : kNegInf;
        s[nb][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    online_softmax(s, o, mx0, mx1, m0, m1, l0, l1);
    if constexpr (Q8) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= key_vs[nb * 8 + 2 * tg + (e & 1)];
      }
    }
    pv<T, HD>(o, s, vt, lane);
    if constexpr (!Q8) __syncthreads();  // the next load overwrites this tile's buffer
  }

  store_out<T, HD>(o, l0, l1, p.out, b, S, H, G, kvh, r0 + wr + g, hd, tg);
}

template <typename T, int HD, bool Q8>
int launch(const ChunkParams<T>& p, cudaStream_t stream) {
  const size_t smem = Layout<T, HD, Q8>::bytes(p.P, p.B);
  cudaError_t err = cudaFuncSetAttribute(chunk_mma_kernel<T, HD, Q8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)p.B * p.KV * ((p.S * p.G + kRows - 1) / kRows);
  chunk_mma_kernel<T, HD, Q8><<<(unsigned)ctas, 32 * kWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The smallest template head dim that holds ``hd``.
template <typename T, bool Q8>
int launch_hd(const ChunkParams<T>& p, cudaStream_t s) {
  if (p.hd <= 16) return launch<T, 16, Q8>(p, s);
  if (p.hd <= 32) return launch<T, 32, Q8>(p, s);
  if (p.hd <= 64) return launch<T, 64, Q8>(p, s);
  if (p.hd <= 128) return launch<T, 128, Q8>(p, s);
  return launch<T, 256, Q8>(p, s);
}

template <typename T, bool Q8>
int chunk_typed(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                const void* v_scales, const void* tables, const void* q_positions, void* out,
                int B, int S, int KV, int G, int hd, int page_size, int P, cudaStream_t s) {
  ChunkParams<T> p{static_cast<const T*>(q), static_cast<T*>(out), k_pages, v_pages,
                   static_cast<const T*>(k_scales), static_cast<const T*>(v_scales),
                   static_cast<const int32_t*>(tables), static_cast<const int32_t*>(q_positions),
                   B, S, KV, G, hd, page_size, P, 1.4426950408889634f / sqrtf((float)hd)};
  return launch_hd<T, Q8>(p, s);
}

template <bool Q8>
int chunk(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
          const void* v_scales, const void* tables, const void* q_positions, void* out, int B,
          int S, int KV, int G, int hd, int page_size, int P, int dtype, void* stream) {
  if (KV <= 0 || G <= 0 || P <= 0 || page_size <= 0 || hd <= 0 || hd > 256 ||
      hd % (Q8 ? 16 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  if (Q8 && (k_scales == nullptr || v_scales == nullptr)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return chunk_typed<__nv_bfloat16, Q8>(q, k_pages, v_pages, k_scales, v_scales, tables,
                                          q_positions, out, B, S, KV, G, hd, page_size, P, s);
  if (dtype == 1)
    return chunk_typed<float, Q8>(q, k_pages, v_pages, k_scales, v_scales, tables, q_positions,
                                  out, B, S, KV, G, hd, page_size, P, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: [B, S, KV, G, hd]; pages: [num_pages, page_size, KV, hd], all in
// dtype (the wrappers' code: bf16 0, f32 1); tables: [B, P] int32;
// q_positions: [B, S] int32. hd % 8 == 0 up to 256; any page size.
extern "C" int mcf_paged_chunk_attention_mma(const void* q, const void* k_pages,
                                             const void* v_pages, const void* tables,
                                             const void* q_positions, void* out, int B, int S,
                                             int KV, int G, int hd, int page_size, int P,
                                             int dtype, void* stream) {
  return chunk<false>(q, k_pages, v_pages, nullptr, nullptr, tables, q_positions, out, B, S, KV,
                      G, hd, page_size, P, dtype, stream);
}

// The same over int8 pages (hd % 16 == 0); k_scales, v_scales: [num_pages,
// KV] in dtype.
extern "C" int mcf_paged_chunk_attention_mma_q8(const void* q, const void* k_pages,
                                                const void* v_pages, const void* k_scales,
                                                const void* v_scales, const void* tables,
                                                const void* q_positions, void* out, int B, int S,
                                                int KV, int G, int hd, int page_size, int P,
                                                int dtype, void* stream) {
  return chunk<true>(q, k_pages, v_pages, k_scales, v_scales, tables, q_positions, out, B, S,
                     KV, G, hd, page_size, P, dtype, stream);
}
