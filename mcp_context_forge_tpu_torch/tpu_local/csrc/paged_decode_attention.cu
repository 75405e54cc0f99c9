// Single-token decode attention over a paged KV pool as split-K
// flash-decoding, for Hopper (sm_90a).
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
// far below the ~295 at which the tensor cores would become the limit, so
// the arithmetic stays on f32 FMAs and the design's job is to keep enough
// bytes in flight:
//   - the key walk of a (row, KV head) is split across CTAs: grid (splits,
//     KV, B), each split a run of whole pages (``pps`` table slots, chosen
//     on the host so the grid holds four CTAs per SM); a CTA whose pages all
//     lie past its row's seq_len exits at once;
//   - a CTA reads its split's block-table entries (and int8 scales) once,
//     in parallel, and walks its pages in tiles of one page of one KV head
//     (bf16 pages wider than 16 KB per tile in page-aligned halves), loading
//     each tile with 16-byte cp.async into a double buffer, so the next tile
//     is in flight during this one's math;
//   - all 128 threads work for the G real query rows (the kernel holds 4, 8
//     or 16 rows, the fewest that take G): 1-8 neighbouring threads per key
//     for the scores (a shuffle adds their parts), one warp per row for the
//     online softmax, and for P @ V one thread per pair of head columns and
//     contiguous range of the tile's keys, with the ranges' partials added
//     once at the end of the walk;
//   - int8 pages: the scale is one per (page, KV head), so the kernel
//     multiplies each page's q.k sums by its K scale and its P @ V sum by
//     its V scale (two multiplies per page and row, not 2*hd per key);
//   - each CTA writes its split's (m, l, o[G][hd]) in f32 to a workspace,
//     and a second small launch combines the splits of a row in a fixed
//     order (M = max m_i, o = sum e^(m_i - M) o_i / sum e^(m_i - M) l_i),
//     so the result is deterministic with no atomics.
//
// Semantics: keys c < seq_lens[b] are attended; a row with seq_len 0 has no
// split to combine and writes zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;             // threads of a split CTA and of a combine CTA
constexpr int GMAX = 16;            // query heads per KV head
constexpr int TILE_BYTES = 16384;   // K (or V) bytes of one tile, at most
constexpr int MAX_TILE_KEYS = 256;
constexpr float kNegInf = -1e30f;
constexpr int kBF16 = 0;            // dtype codes shared with the Python wrappers
constexpr int kF32 = 1;

struct DecodeParams {
  const void* q;            // [B, KV, G, hd]
  const void* k;            // pages [N, page, pool_kv, hd]
  const void* v;
  const void* k_scales;     // int8 pages: [N, pool_kv] in the query's type
  const void* v_scales;
  const int32_t* tables;    // [B, P]
  const int32_t* seq_lens;  // [B]
  float2* part_ml;          // [B, KV, splits, G]: (m in base-2 units, l)
  float* part_o;            // [B, KV, splits, G, hd]
  void* out;                // [B, KV, G, hd]
  int B, KV, G, hd, page_size, P, pps, splits, tile_keys;
  int key_threads;          // threads that share a key's scores (a power of 2 <= 32)
  float scale_log2;         // log2(e) / sqrt(hd)
  // the pool's kv heads and the first one q's kv head 0 reads: a tensor-
  // parallel rank's query heads over a replicated pool read a window of it
  int pool_kv, kv_off;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// 16 bytes of K storage as 16 / sizeof(KT) floats
__device__ __forceinline__ void widen(const uint4& raw, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void widen(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* f, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = (float)b[i];
}

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

// Shared memory of a split CTA: K and V double buffers [2][tile_keys][pitch]
// (pitch = a key's hd elements + 16 bytes per thread of the key, so the rows
// that neighbouring threads read start on different banks), which at the
// end of the walk hold the P @ V partials of the key ranges; then q [G][hd]
// f32, scores [G][tile_keys] f32, the running m, l and correction of each
// row, and the split's pages and their K and V scales [pps].
__host__ __device__ inline int buffer_bytes(int tile_keys, int pitch, int G, int hd) {
  const int tiles = 4 * tile_keys * pitch, partials = (NT / (hd / 2)) * G * hd * 4;
  return tiles > partials ? tiles : partials;
}
inline size_t split_smem_bytes(int tile_keys, int pitch, int G, int hd, int pps) {
  return buffer_bytes(tile_keys, pitch, G, hd) + (size_t)G * hd * 4 +
         (size_t)G * tile_keys * 4 + 3 * GMAX * 4 + (size_t)pps * 12;
}

// T: query, output and scale type; KT: page storage (T, or int8_t); GM:
// query rows held, the smallest of 4, 8, 16 that is >= G
template <typename T, typename KT, int GM>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeParams p) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int EPC = 16 / sizeof(KT);  // elements per 16-byte chunk
  using Pair = typename std::conditional<Q8, char2, typename std::conditional<
      std::is_same<KT, float>::value, float2, __nv_bfloat162>::type>::type;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int PS = p.page_size, hd = p.hd, G = p.G, TKY = p.tile_keys, NKT = p.key_threads;
  const int seq = min(p.seq_lens[b], p.P * PS);
  const int key_begin = split * p.pps * PS;
  if (seq <= key_begin) return;  // every page of this split lies past seq_len
  const int key_end = min(key_begin + p.pps * PS, seq);

  const int row_bytes = hd * (int)sizeof(KT);
  const int pitch = row_bytes + 16 * NKT;
  const int chunks = row_bytes / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kbuf = smem;
  unsigned char* vbuf = kbuf + 2 * TKY * pitch;
  float* qs = reinterpret_cast<float*>(smem + buffer_bytes(TKY, pitch, G, hd));
  float* sc = qs + G * hd;
  float* row_m = sc + G * TKY;
  float* row_l = row_m + GMAX;
  float* row_c = row_l + GMAX;
  int* pages = reinterpret_cast<int*>(row_c + GMAX);
  float* page_ks = reinterpret_cast<float*>(pages + p.pps);
  float* page_vs = page_ks + p.pps;

  const int tid = threadIdx.x;
  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.KV + kvh) * G * hd;
  for (int i = tid; i < G * hd; i += NT) qs[i] = to_float(q[i]);
  if (tid < G) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  const int pages_in = (key_end - key_begin + PS - 1) / PS;
  for (int i = tid; i < pages_in; i += NT) {
    const int page = p.tables[(long long)b * p.P + key_begin / PS + i];
    pages[i] = page;
    if (Q8) {
      const long long at = (long long)page * p.pool_kv + p.kv_off + kvh;
      page_ks[i] = to_float(static_cast<const T*>(p.k_scales)[at]);
      page_vs[i] = to_float(static_cast<const T*>(p.v_scales)[at]);
    }
  }
  __syncthreads();

  // tile t: keys from offset (t % tpp) * TKY of the split's page t / tpp;
  // tiles never span pages
  const int tpp = (PS + TKY - 1) / TKY;
  const int last_keys = key_end - key_begin - (pages_in - 1) * PS;
  const int n_tiles = (pages_in - 1) * tpp + (last_keys + TKY - 1) / TKY;
  const long long kv_stride = (long long)p.pool_kv * hd * sizeof(KT);  // bytes from key to key

  auto tile_keys = [&](int t) {
    const int off = (t % tpp) * TKY;
    return min(min(TKY, PS - off), key_end - (key_begin + (t / tpp) * PS + off));
  };
  auto load = [&](int t, int buf) {
    const int n = tile_keys(t), sub = t % tpp;
    const int page = pages[t / tpp];
    const long long off =
        (((long long)page * PS + sub * TKY) * p.pool_kv + p.kv_off + kvh) * hd * sizeof(KT);
    const char* ksrc = static_cast<const char*>(p.k) + off;
    const char* vsrc = static_cast<const char*>(p.v) + off;
    const uint32_t kdst = static_cast<uint32_t>(__cvta_generic_to_shared(kbuf + buf * TKY * pitch));
    const uint32_t vdst = static_cast<uint32_t>(__cvta_generic_to_shared(vbuf + buf * TKY * pitch));
    for (int i = tid; i < n * chunks; i += NT) {
      const int j = i / chunks, c = i - j * chunks;
      cp_async16(kdst + j * pitch + c * 16, ksrc + j * kv_stride + c * 16);
      cp_async16(vdst + j * pitch + c * 16, vsrc + j * kv_stride + c * 16);
    }
  };

  // P @ V: this thread owns head columns 2*cp, 2*cp + 1 over the keys of
  // range kr of each tile (NT / (hd / 2) ranges)
  const int pairs = hd / 2;
  const int cp = tid % pairs, kr = tid / pairs, n_ranges = NT / pairs;
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int warp = tid / 32, lane = tid % 32;

  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load(t + 1, buf ^ 1);  // its buffer was freed by the last barrier
    cp_async_commit();
    cp_async_wait_one();  // tile t has landed
    __syncthreads();
    const int n = tile_keys(t);
    const float ks = Q8 ? page_ks[t / tpp] : 1.f, vs = Q8 ? page_vs[t / tpp] : 1.f;

    // scores in base-2 units: NKT neighbouring threads share a key, each
    // summing every NKT-th chunk, then add across the group
    const unsigned char* kb = kbuf + buf * TKY * pitch;
    const int part = tid % NKT;
    for (int j = tid / NKT; j < ((n + NT / NKT - 1) / (NT / NKT)) * (NT / NKT); j += NT / NKT) {
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = 0.f;
      if (j < n) {
        for (int c = part; c < chunks; c += NKT) {
          float kf[EPC];
          widen(*reinterpret_cast<const uint4*>(kb + j * pitch + c * 16), kf, KT());
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
              const float4* qg = reinterpret_cast<const float4*>(qs + g * hd + c * EPC);
              float a = s[g];
#pragma unroll
              for (int e4 = 0; e4 < EPC / 4; ++e4) {
                const float4 qv = qg[e4];
                a = fmaf(qv.x, kf[4 * e4], a);
                a = fmaf(qv.y, kf[4 * e4 + 1], a);
                a = fmaf(qv.z, kf[4 * e4 + 2], a);
                a = fmaf(qv.w, kf[4 * e4 + 3], a);
              }
              s[g] = a;
            }
          }
        }
      }
      for (int o = NKT / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      if (j < n && part == 0) {
        const float f = p.scale_log2 * ks;  // ks = 1 for unquantized pages
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) sc[g * TKY + j] = s[g] * f;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < G; g += NT / 32) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[g * TKY + j]);
      mx = warp_max(mx);
      const float m_old = row_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = exp2f(sc[g * TKY + j] - m_new);
        sc[g * TKY + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        row_c[g] = corr;
        row_l[g] = row_l[g] * corr + sum;
        row_m[g] = m_new;
      }
    }
    __syncthreads();

    // P @ V over this thread's key range, then acc = acc * corr + vs * (P V)
    const unsigned char* vb = vbuf + buf * TKY * pitch;
    const int per = (n + n_ranges - 1) / n_ranges;
    const int j0 = kr * per, j1 = kr < n_ranges ? min(n, j0 + per) : 0;
    float pv[GM][2];
#pragma unroll
    for (int g = 0; g < GM; ++g) pv[g][0] = pv[g][1] = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const Pair v2 = reinterpret_cast<const Pair*>(vb + j * pitch)[cp];
      const float v0 = to_float(v2.x), v1 = to_float(v2.y);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pg = sc[g * TKY + j];
          pv[g][0] = fmaf(pg, v0, pv[g][0]);
          pv[g][1] = fmaf(pg, v1, pv[g][1]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float corr = row_c[g];
        acc[g][0] = fmaf(acc[g][0], corr, vs * pv[g][0]);
        acc[g][1] = fmaf(acc[g][1], corr, vs * pv[g][1]);
      }
    }
    __syncthreads();  // the next tile overwrites this buffer's neighbour and the scores
  }

  // sum the key ranges' partials (in the free K buffers) and write the split
  float* red = reinterpret_cast<float*>(kbuf);  // [n_ranges][G][hd]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && kr < n_ranges) {  // hd / 2 need not divide NT
      red[(kr * G + g) * hd + 2 * cp] = acc[g][0];
      red[(kr * G + g) * hd + 2 * cp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  const long long slot = ((long long)b * p.KV + kvh) * p.splits + split;
  for (int i = tid; i < G * hd; i += NT) {
    float o = 0.f;
    for (int r = 0; r < n_ranges; ++r) o += red[r * G * hd + i];
    p.part_o[slot * G * hd + i] = o;
  }
  if (tid < G) p.part_ml[slot * G + tid] = make_float2(row_m[tid], row_l[tid]);
}

// One CTA per (KV head, row): each active split's weight per query row
// (2^(m_i - M) / sum_i 2^(m_i - M) l_i) once, one warp per row, then the
// weighted sum of the splits' partials, in split order.
template <typename T>
__global__ void __launch_bounds__(NT) decode_combine_kernel(DecodeParams p) {
  extern __shared__ float w[];  // [splits][G]
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int PS = p.page_size, G = p.G, hd = p.hd;
  const int seq = min(p.seq_lens[b], p.P * PS);
  const int active = ((seq + PS - 1) / PS + p.pps - 1) / p.pps;
  const long long slot0 = ((long long)b * p.KV + kvh) * p.splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += NT / 32) {
    float M = kNegInf;
    for (int s = lane; s < active; s += 32) M = fmaxf(M, p.part_ml[(slot0 + s) * G + g].x);
    M = warp_max(M);
    float den = 0.f;
    for (int s = lane; s < active; s += 32) {
      const float2 ml = p.part_ml[(slot0 + s) * G + g];
      const float e = exp2f(ml.x - M);
      w[s * G + g] = e;
      den = fmaf(e, ml.y, den);
    }
    den = warp_sum(den);
    const float inv = den > 0.f ? 1.f / den : 0.f;
    for (int s = lane; s < active; s += 32) w[s * G + g] *= inv;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + ((long long)b * p.KV + kvh) * G * hd;
  const float* o = p.part_o + slot0 * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int g = i / hd;
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < active; ++s) num = fmaf(w[s * G + g], o[(long long)s * G * hd + i], num);
    store1(out + i, num);
  }
}

bool shape_ok(const DecodeParams& p, int elem_bytes) {
  return p.G >= 1 && p.G <= GMAX && p.hd > 0 && p.hd <= 2 * NT && p.hd % 8 == 0 &&
         (p.hd * elem_bytes) % 16 == 0 && p.page_size > 0 && p.pps > 0 &&
         (long long)p.splits * p.pps >= p.P && p.kv_off >= 0 && p.kv_off + p.KV <= p.pool_kv;
}

template <typename T>
int combine(const DecodeParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.splits * p.G * 4;
  cudaError_t err = cudaFuncSetAttribute(decode_combine_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.B > 0 && p.KV > 0) decode_combine_kernel<T><<<dim3(p.KV, p.B), NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename KT, int GM>
int split_launch(const DecodeParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, KT, GM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.B > 0 && p.KV > 0) kernel<<<dim3(p.splits, p.KV, p.B), NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename KT>
int split_and_combine(DecodeParams p, cudaStream_t stream) {
  if (!shape_ok(p, (int)sizeof(KT))) return (int)cudaErrorInvalidValue;
  const int row_bytes = p.hd * (int)sizeof(KT);
  p.tile_keys = min(min(p.page_size, TILE_BYTES / row_bytes), MAX_TILE_KEYS);
  // threads per key: a power of two that fills the CTA on a short tile
  p.key_threads = 1;
  while (p.key_threads < 32 && p.tile_keys * p.key_threads * 2 <= NT &&
         (row_bytes / 16) % (p.key_threads * 2) == 0)
    p.key_threads *= 2;
  const size_t smem =
      split_smem_bytes(p.tile_keys, row_bytes + 16 * p.key_threads, p.G, p.hd, p.pps);
  const int err = p.G <= 4   ? split_launch<T, KT, 4>(p, smem, stream)
                  : p.G <= 8 ? split_launch<T, KT, 8>(p, smem, stream)
                             : split_launch<T, KT, 16>(p, smem, stream);
  if (err != (int)cudaSuccess) return err;
  return combine<T>(p, stream);
}

template <bool Q8>
int decode(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
           const void* v_scales, const void* tables, const void* seq_lens, void* part_ml,
           void* part_o, void* out, int B, int KV, int G, int hd, int page_size, int P, int pps,
           int splits, int pool_kv, int kv_off, int dtype, void* stream) {
  if (Q8 && (k_scales == nullptr || v_scales == nullptr)) return (int)cudaErrorInvalidValue;
  DecodeParams p{q, k_pages, v_pages, k_scales, v_scales,
                 static_cast<const int32_t*>(tables), static_cast<const int32_t*>(seq_lens),
                 static_cast<float2*>(part_ml), static_cast<float*>(part_o), out,
                 B, KV, G, hd, page_size, P, pps, splits, 0, 1,
                 1.4426950408889634f / sqrtf((float)hd), pool_kv, kv_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using KB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using KF = typename std::conditional<Q8, int8_t, float>::type;
  if (dtype == kBF16) return split_and_combine<__nv_bfloat16, KB>(p, s);
  if (dtype == kF32) return split_and_combine<float, KF>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// part_ml: [B, KV, splits, G, 2] f32, part_o: [B, KV, splits, G, hd] f32
// workspaces; split s covers table slots [s*pps, (s+1)*pps), splits*pps >= P.
// Pages hold pool_kv >= kv_off + KV heads; q's kv head j reads pool head
// kv_off + j.
extern "C" int mcf_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* tables,
                                          const void* seq_lens, void* part_ml, void* part_o,
                                          void* out, int B, int KV, int G, int hd,
                                          int page_size, int P, int pps, int splits,
                                          int pool_kv, int kv_off, int dtype, void* stream) {
  return decode<false>(q, k_pages, v_pages, nullptr, nullptr, tables, seq_lens, part_ml, part_o,
                       out, B, KV, G, hd, page_size, P, pps, splits, pool_kv, kv_off, dtype,
                       stream);
}

// Replaces: mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:199 with
// k_scales/v_scales (int8 pages). k_scales, v_scales: [N, pool_kv] in dtype.
extern "C" int mcf_paged_decode_attention_q8(const void* q, const void* k_pages,
                                             const void* v_pages, const void* k_scales,
                                             const void* v_scales, const void* tables,
                                             const void* seq_lens, void* part_ml, void* part_o,
                                             void* out, int B, int KV, int G, int hd,
                                             int page_size, int P, int pps, int splits,
                                             int pool_kv, int kv_off, int dtype, void* stream) {
  return decode<true>(q, k_pages, v_pages, k_scales, v_scales, tables, seq_lens, part_ml, part_o,
                      out, B, KV, G, hd, page_size, P, pps, splits, pool_kv, kv_off, dtype,
                      stream);
}

// The combine launch alone, over partials already in the workspaces.
extern "C" int mcf_paged_decode_combine(const void* seq_lens, void* part_ml, void* part_o,
                                        void* out, int B, int KV, int G, int hd, int page_size,
                                        int P, int pps, int splits, int dtype, void* stream) {
  DecodeParams p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 static_cast<const int32_t*>(seq_lens), static_cast<float2*>(part_ml),
                 static_cast<float*>(part_o), out, B, KV, G, hd, page_size, P, pps, splits, 0, 1,
                 0.f, KV, 0};
  if (!shape_ok(p, 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return combine<__nv_bfloat16>(p, s);
  if (dtype == kF32) return combine<float>(p, s);
  return (int)cudaErrorInvalidValue;
}
