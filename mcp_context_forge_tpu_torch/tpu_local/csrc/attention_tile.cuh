// Tile engine of the paged chunk kernels that are not on the tensor cores
// (paged_chunk_attention.cu: f32 pages, and bf16 at head dims or page sizes
// the wgmma kernel paged_chunk_attention_tc.cu does not take; bf16/f32 and
// int8 pages). A tile of query rows, each with an absolute position, attends
// with an f32 online softmax over keys c <= position, where the keys come
// from a paged pool [N, page, KV, hd] through a block table. Paged K/V are
// stored in the query's type, or in int8 with one scale per (page, kv head)
// ([N, KV] in the query's type).
//
// Query and output layout is [B, S, KV*G, hd]; one CTA owns BQ = NT/4 rows
// r = s*G + g of one (batch row, kv head), so every key tile it stages in
// shared memory serves all G query heads of the group (no K/V repeat).
//
// Per key tile of TK keys:
//   1. the block resolves each key's address (block-table lookup, done by
//      the block itself: there is no scalar prefetch on this card) and, for
//      int8 pages, loads that page's K and V scales of this head;
//   2. K and V are staged in shared memory as f32 (one 16-byte load per
//      thread per 8 elements; 8 bytes for int8, each value multiplied by
//      its page's scale in f32, the Pallas kernel's dequantization);
//   3. scores: each thread owns a 4 x TK/16 micro-tile of (row, key) pairs;
//   4. softmax: one warp per row updates the running max m and sum l and
//      turns the scores into probabilities;
//   5. P @ V: each thread owns 4 rows x ceil(hd/16) output columns, kept in
//      registers across the whole key walk.
// Masked scores are -1e30, not -inf, as in the JAX kernels: a row that sees
// no valid key stays finite.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace mcf {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;

struct AttnParams {
  const void* q;              // [B, S, KV*G, hd]
  void* out;                  // [B, S, KV*G, hd]
  const void* k;              // pages [N, page, KV, hd]
  const void* v;
  const int32_t* tables;      // [B, P]
  const int32_t* q_pos;       // [B, S] absolute positions (-1 = padding)
  const void* k_scales;       // int8 pages: [N, KV] dequant scales in the query's type
  const void* v_scales;
  int B, S, KV, G, hd;
  int page_size, P;
  float scale;                // 1 / sqrt(hd)
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// 8 int8 values with one 8-byte load
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)b[i];
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory of one CTA, in bytes (layout as in the kernel).
inline size_t attn_smem_bytes(int BQ, int TK, int hd, bool q8) {
  const size_t ld = (size_t)hd + 1;
  return (size_t)TK * 8 + (size_t)BQ * 4                    // key_off, row_pos
         + (q8 ? (size_t)TK * 2 * 4 : 0)                     // key_ks, key_vs (int8 pages)
         + (size_t)BQ * 3 * 4                                // row_m, row_l, row_c
         + ((size_t)BQ + 2 * (size_t)TK) * ld * 4            // Qs, Ks, Vs
         + (size_t)BQ * (TK + 1) * 4;                        // Ps
}

// T: query, output and scale type; KT: K/V storage (T, or int8_t for int8
// pages)
template <typename T, typename KT, int NT, int TK>
__global__ void __launch_bounds__(NT) attn_tile_kernel(AttnParams p) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int BQ = NT / 4;    // query rows per CTA
  constexpr int TQ = NT / 16;   // a thread owns rows tq + TQ*i, i < 4
  constexpr int CK = TK / 16;   // keys per thread in the score micro-tile
  constexpr int KPL = TK / 32;  // keys per lane in the softmax pass
  constexpr int NW = NT / 32;
  constexpr int NJ = kMaxHeadDim / 16;
  static_assert(NT % 64 == 0 && TK % 32 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* key_off = reinterpret_cast<long long*>(smem_raw);  // [TK], -1 = no key
  float* key_ks = reinterpret_cast<float*>(key_off + TK);         // [TK] int8 only: page scales
  float* key_vs = key_ks + (Q8 ? TK : 0);                         // [TK] int8 only
  int* row_pos = reinterpret_cast<int*>(key_vs + (Q8 ? TK : 0));  // [BQ]
  float* row_m = reinterpret_cast<float*>(row_pos + BQ);          // [BQ]
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;
  const int hd = p.hd;
  const int ld = hd + 1;  // +1 float: rows fall on different banks
  float* Qs = row_c + BQ;            // [BQ][ld], pre-scaled by 1/sqrt(hd)
  float* Ks = Qs + BQ * ld;          // [TK][ld]
  float* Vs = Ks + TK * ld;          // [TK][ld]
  float* Ps = Vs + TK * ld;          // [BQ][TK + 1]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * BQ;
  const int G = p.G;
  const int R = p.S * G;
  const int H = p.KV * G;
  const int chunks = hd / 8;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const KT* __restrict__ kp = static_cast<const KT*>(p.k);
  const KT* __restrict__ vp = static_cast<const KT*>(p.v);

  for (int r = tid; r < BQ; r += NT) {
    const int gr = r0 + r;
    int pos = -1;
    if (gr < R) {
      const int s = gr / G;
      pos = p.q_pos[(long long)b * p.S + s];
    }
    row_pos[r] = pos;
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }
  for (int i = tid; i < BQ * chunks; i += NT) {
    const int r = i / chunks;
    const int c8 = (i % chunks) * 8;
    const int gr = r0 + r;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gr < R) {
      const int s = gr / G, g = gr % G;
      const long long off = (((long long)b * p.S + s) * H + (long long)kvh * G + g) * hd + c8;
      load8(q + off, vals);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[r * ld + c8 + e] = vals[e] * p.scale;
  }
  __syncthreads();

  // the keys this tile needs: 0 .. max(position) (causal frontier)
  int max_pos = -1;
  for (int r = 0; r < BQ; ++r) max_pos = max(max_pos, row_pos[r]);
  const int n_keys = min(max_pos + 1, p.P * p.page_size);
  const int n_tiles = n_keys > 0 ? (n_keys + TK - 1) / TK : 0;

  const int tq = tid / 16;
  const int tk = tid % 16;  // key column in the score tile, output column in P @ V
  const int warp = tid / 32, lane = tid % 32;
  const int nj = (hd + 15) / 16;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * TK;
    for (int j = tid; j < TK; j += NT) {
      const int c = c0 + j;
      long long off = -1;
      float ks = 0.f, vs = 0.f;
      if (c < n_keys) {
        const int page = p.tables[(long long)b * p.P + c / p.page_size];
        off = (((long long)page * p.page_size + c % p.page_size) * p.KV + kvh) * hd;
        if (Q8) {
          const long long s = (long long)page * p.KV + kvh;
          ks = to_float(static_cast<const T*>(p.k_scales)[s]);
          vs = to_float(static_cast<const T*>(p.v_scales)[s]);
        }
      }
      key_off[j] = off;
      if (Q8) {
        key_ks[j] = ks;
        key_vs[j] = vs;
      }
    }
    __syncthreads();
    for (int i = tid; i < TK * chunks; i += NT) {
      const int j = i / chunks;
      const int c8 = (i % chunks) * 8;
      const long long off = key_off[j];
      float kv8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vv8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (off >= 0) {
        load8(kp + off + c8, kv8);
        load8(vp + off + c8, vv8);
        if (Q8) {
          const float ks = key_ks[j], vs = key_vs[j];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kv8[e] *= ks;
            vv8[e] *= vs;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[j * ld + c8 + e] = kv8[e];
        Vs[j * ld + c8 + e] = vv8[e];
      }
    }
    __syncthreads();

    // scores of this thread's 4 x CK micro-tile
    float sc[4][CK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kk[CK];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tq + TQ * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kk[j] = Ks[(tk + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tq + TQ * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int key = tk + 16 * j;
        const bool ok = key_off[key] >= 0 && (c0 + key) <= row_pos[r];
        Ps[r * (TK + 1) + key] = ok ? sc[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += NW) {
      float s[KPL];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        s[u] = Ps[r * (TK + 1) + lane + 32 * u];
        mx = fmaxf(mx, s[u]);
      }
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const float e = expf(s[u] - m_new);
        Ps[r * (TK + 1) + lane + 32 * u] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * correction + P @ V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[tq + TQ * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int key = 0; key < TK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tq + TQ * i) * (TK + 1) + key];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tk + 16 * j;
        if (j < nj && d < hd) {
          const float vv = Vs[key * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites key_off, Ks, Vs and Ps
  }

  T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq + TQ * i;
    const int gr = r0 + r;
    if (gr >= R) continue;
    const int s = gr / G, g = gr % G;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    const long long base = (((long long)b * p.S + s) * H + (long long)kvh * G + g) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tk + 16 * j;
      if (j < nj && d < hd) store1(out + base + d, acc[i][j] * inv);
    }
  }
}

// Launches one tile kernel on ``stream``; returns cudaGetLastError().
template <typename T, typename KT, int NT, int TK>
int launch_attn(const AttnParams& p, cudaStream_t stream) {
  constexpr int BQ = NT / 4;
  const size_t smem = attn_smem_bytes(BQ, TK, p.hd, std::is_same<KT, int8_t>::value);
  auto kernel = attn_tile_kernel<T, KT, NT, TK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = p.S * p.G;
  if (p.B > 0 && rows > 0 && p.KV > 0) {
    dim3 grid((rows + BQ - 1) / BQ, p.KV, p.B);
    kernel<<<grid, NT, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// dtype codes shared with the Python wrappers
constexpr int kBF16 = 0;
constexpr int kF32 = 1;

// Q8: int8 K/V pages with scales in the query's type (``dtype``), both
// non-null
template <int NT, int TK, bool Q8>
int launch_attn_dtype(const AttnParams& p, int dtype, cudaStream_t stream) {
  if (p.hd <= 0 || p.hd > kMaxHeadDim || p.hd % 8 != 0) return (int)cudaErrorInvalidValue;
  if (Q8 && (p.k_scales == nullptr || p.v_scales == nullptr)) return (int)cudaErrorInvalidValue;
  using KB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using KF = typename std::conditional<Q8, int8_t, float>::type;
  if (dtype == kBF16) return launch_attn<__nv_bfloat16, KB, NT, TK>(p, stream);
  if (dtype == kF32) return launch_attn<float, KF, NT, TK>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mcf
