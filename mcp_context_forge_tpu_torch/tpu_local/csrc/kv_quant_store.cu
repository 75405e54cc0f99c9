// Int8 KV-page writers, K and V of one layer in one launch, for Hopper
// (sm_90a): one decode token per row (mcf_kv_quant_store_decode), and a
// [B, S] span per row (mcf_kv_quant_store_span: prefill, chunk rounds,
// prefix-hit suffixes and the speculative verify).
//
// Replaces: the int8 writes of the JAX package,
// mcp_context_forge_tpu/tpu_local/kv/paged_cache.py:121 (_quant_store) as
// write_decode_kv (:208) calls it for a one-token span and as
// write_prefill_kv (:165) calls it for a [B, S] block. It is not a
// pl.pallas_call: XLA fuses it for the reference. In eager PyTorch the same
// arithmetic (kv/paged_cache.py _quant_store) is ~35 launches per pool and
// layer, 2270 of a Llama-3-8B decode step's 4825 launches on int8 pages,
// and as many again in every int8 prefill call.
//
// What bounds both: HBM bytes. Per layer they read each written token's
// KV*hd values of K and of V and write as many int8 values and a scale per
// (page, head); a row's first page, when its span starts mid-page and the
// page's running-max scale grows, also has its resident [page, hd] values
// of each head read and written once (only then: a ratio of exactly 1
// leaves them as they are). The arithmetic is a few f32 operations per byte.
//
// Decode design: one CTA of 128 threads per (row, KV head, K|V), grid
// (B, KV, 2). The CTA looks up its row's page, reduces max|x| over the
// head's hd values, settles the page's scale, requantizes the resident
// values 4 bytes per thread when the scale grew, then writes the token.
//
// Span design: one CTA of 128 threads per (row, page the span touches, KV
// head, K|V), grid (B, pages a span of S tokens can touch, 2 KV). A row's
// valid columns form one run c0..c0+n-1 at positions p0..p0+n-1 (how every
// caller packs them); each CTA finds c0 and n by scanning the row's valid
// flags, takes the tokens of its page (positions in [col*page, col*page +
// page) of the span), reduces each token's max|x| (a warp per token),
// settles the page's scale from them, requantizes the row's first page
// when the span starts mid-page and the scale grew, and writes its tokens
// 4 bytes per thread. A CTA past the row's last page exits at once.
//
// In both, two live rows never write the same page, so CTAs meet only on
// the trash page 0 (invalid decode rows; table columns left unassigned),
// whose contents are don't-care: no atomics. The span writer writes
// nothing for an invalid token.
//
// Numerics: the plain writer's, bit for bit on every page >= 1 and its
// scales. Built without --use_fast_math; divisions are IEEE (__fdiv_rn),
// products __fmul_rn (no contraction), rounding half to even (rintf):
//   tok   = (scale dtype)(amax / 127)
//   s_new = a token at offset 0 ? max(tok) : max(s_old, max(tok))
//   ratio = s_old / max(s_new, 1e-8)          (the first page, mid-page only)
//   q     = clamp(rint(x / max(s_new, 1e-8)), -127, 127)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr float kScaleEps = 1e-8f;   // quantize.py KV_SCALE_EPS
constexpr int kBF16 = 0;             // dtype codes shared with the Python wrappers
constexpr int kF32 = 1;

struct StoreParams {
  int8_t* pages[2];           // K, V: [N, page, KV, hd] int8 (one layer)
  void* scales[2];            // [N, KV] in T
  const void* vals[2];        // [B, KV, hd] in T
  const int32_t* tables;      // [slots, P]
  const int32_t* slot_ids;    // [B]
  const int32_t* positions;   // [B]
  const bool* valid;          // [B] or nullptr (every row valid)
  int B, KV, hd, page_size, P;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int8_t quantize(float x, float ratio_or_inv, bool divide) {
  const float y = divide ? __fdiv_rn(x, ratio_or_inv) : __fmul_rn(x, ratio_or_inv);
  return (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(NT) quant_store_kernel(StoreParams p) {
  const int b = blockIdx.x, h = blockIdx.y, which = blockIdx.z;
  const int tid = threadIdx.x;
  // selects, not an index into the parameter arrays (which would copy them to the stack)
  int8_t* pages = which ? p.pages[1] : p.pages[0];
  T* scales = static_cast<T*>(which ? p.scales[1] : p.scales[0]);
  const T* x = static_cast<const T*>(which ? p.vals[1] : p.vals[0]) +
               ((size_t)b * p.KV + h) * p.hd;

  const bool live = p.valid == nullptr || p.valid[b];
  int page = 0, offset = 0;
  if (live) {
    const int pos = p.positions[b];
    const int col = min(pos / p.page_size, p.P - 1);
    page = p.tables[(size_t)p.slot_ids[b] * p.P + col];
    offset = pos % p.page_size;
  }

  // max|x| over the head's values: a warp shuffle, then the four warps
  __shared__ float warp_max[NT / 32];
  float amax = 0.f;
  for (int d = tid; d < p.hd; d += NT) amax = fmaxf(amax, fabsf(to_float(x[d])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(warp_max[0], warp_max[1]), fmaxf(warp_max[2], warp_max[3]));

  T* scale_ptr = scales + (size_t)page * p.KV + h;
  const float tok = to_float(from_float<T>(__fdiv_rn(amax, 127.f)));
  const float s_old = to_float(*scale_ptr);
  const float s_new = offset == 0 ? tok : fmaxf(s_old, tok);
  __syncthreads();   // every thread has read s_old before thread 0 stores s_new

  const size_t row_stride = (size_t)p.KV * p.hd;   // bytes from one token to the next
  int8_t* page_base = pages + (size_t)page * p.page_size * row_stride + (size_t)h * p.hd;
  if (offset > 0) {
    const float ratio = __fdiv_rn(s_old, fmaxf(s_new, kScaleEps));
    if (ratio != 1.f) {
      // the head's resident [page, hd] values, 4 bytes per thread (hd % 8 == 0)
      const int words = p.hd / 4;
      for (int i = tid; i < p.page_size * words; i += NT) {
        char4* w = reinterpret_cast<char4*>(page_base + (size_t)(i / words) * row_stride) +
                   i % words;
        char4 c = *w;
        c.x = quantize((float)c.x, ratio, false);
        c.y = quantize((float)c.y, ratio, false);
        c.z = quantize((float)c.z, ratio, false);
        c.w = quantize((float)c.w, ratio, false);
        *w = c;
      }
      __syncthreads();   // the token's row is requantized before it is overwritten
    }
  }
  const float divisor = fmaxf(s_new, kScaleEps);
  int8_t* dst = page_base + (size_t)offset * row_stride;
  for (int d = tid; d < p.hd; d += NT) dst[d] = quantize(to_float(x[d]), divisor, true);
  if (tid == 0) *scale_ptr = from_float<T>(s_new);
}


struct SpanParams {
  int8_t* pages[2];           // K, V: [N, page, KV, hd] int8 (one layer)
  void* scales[2];            // [N, KV] in T
  const void* vals[2];        // [B, S, KV, hd] in T
  const int32_t* tables;      // [slots, P]
  const int32_t* slot_ids;    // [B]
  const int32_t* positions;   // [B, S]
  const bool* valid;          // [B, S]
  int B, S, KV, hd, page_size, P;
};

// four consecutive values of x as f32 (x 8-byte aligned for bf16, 16 for f32)
__device__ __forceinline__ void load4(const __nv_bfloat16* x, float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(x);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  out[0] = __low2float(a); out[1] = __high2float(a);
  out[2] = __low2float(b); out[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* x, float* out) {
  const float4 w = *reinterpret_cast<const float4*>(x);
  out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
}

template <typename T>
__global__ void __launch_bounds__(NT) span_store_kernel(SpanParams p) {
  constexpr int kWarps = NT / 32;
  const int b = blockIdx.x, j = blockIdx.y, h = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int8_t* pages = which ? p.pages[1] : p.pages[0];
  T* scales = static_cast<T*>(which ? p.scales[1] : p.scales[0]);
  const T* vals = static_cast<const T*>(which ? p.vals[1] : p.vals[0]);

  // the row's valid run: its first column and its length
  __shared__ int run_first[kWarps], run_count[kWarps];
  __shared__ float warp_max[kWarps];
  const bool* valid = p.valid + (size_t)b * p.S;
  int first = p.S, count = 0;
  for (int c = tid; c < p.S; c += NT) {
    if (valid[c]) {
      first = min(first, c);
      ++count;
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) {
    run_first[warp] = first;
    run_count[warp] = count;
  }
  __syncthreads();
  first = run_first[0];
  count = run_count[0];
  for (int w = 1; w < kWarps; ++w) {
    first = min(first, run_first[w]);
    count += run_count[w];
  }
  if (count == 0) return;   // no valid token: nothing to write

  // this CTA's page: table column col0 + j, positions [lo, hi) of the span
  const int p0 = p.positions[(size_t)b * p.S + first];
  const int col = p0 / p.page_size + j;
  const int lo = max(p0, col * p.page_size);
  const int hi = min(p0 + count, (col + 1) * p.page_size);
  if (lo >= hi || col >= p.P) return;
  const int page = p.tables[(size_t)p.slot_ids[b] * p.P + col];
  const int n = hi - lo;
  const int c_lo = first + (lo - p0);   // the column of position lo
  const size_t x_stride = (size_t)p.KV * p.hd;   // from one column's values to the next
  const T* x0 = vals + ((size_t)b * p.S + c_lo) * x_stride + (size_t)h * p.hd;

  T* scale_ptr = scales + (size_t)page * p.KV + h;
  const float s_old = to_float(*scale_ptr);

  // each token's scale in the scale dtype, a warp per token; their max
  const int words = p.hd / 4;
  float tok_max = 0.f;
  for (int t = warp; t < n; t += kWarps) {
    float amax = 0.f, v[4];
    for (int w = lane; w < words; w += 32) {
      load4(x0 + t * x_stride + 4 * w, v);
      amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v[0]), fabsf(v[1]))),
                   fmaxf(fabsf(v[2]), fabsf(v[3])));
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    tok_max = fmaxf(tok_max, to_float(from_float<T>(__fdiv_rn(amax, 127.f))));
  }
  if (lane == 0) warp_max[warp] = tok_max;
  __syncthreads();   // also: every thread has read s_old before thread 0 stores s_new
  for (int w = 0; w < kWarps; ++w) tok_max = fmaxf(tok_max, warp_max[w]);

  // a token at offset 0 begins a new tenancy: the old scale is dropped
  const bool fresh = lo % p.page_size == 0;
  const float s_new = fresh ? tok_max : fmaxf(s_old, tok_max);
  int8_t* page_base = pages + (size_t)page * p.page_size * x_stride + (size_t)h * p.hd;
  if (j == 0 && !fresh) {
    // the row's first page, written from mid-page: its resident values
    // were quantized under s_old
    const float ratio = __fdiv_rn(s_old, fmaxf(s_new, kScaleEps));
    if (ratio != 1.f) {
      for (int i = tid; i < p.page_size * words; i += NT) {
        char4* w = reinterpret_cast<char4*>(page_base + (size_t)(i / words) * x_stride) +
                   i % words;
        char4 c = *w;
        c.x = quantize((float)c.x, ratio, false);
        c.y = quantize((float)c.y, ratio, false);
        c.z = quantize((float)c.z, ratio, false);
        c.w = quantize((float)c.w, ratio, false);
        *w = c;
      }
      __syncthreads();   // requantized before the span's tokens overwrite their rows
    }
  }
  const float divisor = fmaxf(s_new, kScaleEps);
  int8_t* dst = page_base + (size_t)(lo % p.page_size) * x_stride;
  for (int i = tid; i < n * words; i += NT) {
    const int t = i / words, w = i % words;
    float v[4];
    load4(x0 + t * x_stride + 4 * w, v);
    char4 c;
    c.x = quantize(v[0], divisor, true);
    c.y = quantize(v[1], divisor, true);
    c.z = quantize(v[2], divisor, true);
    c.w = quantize(v[3], divisor, true);
    *(reinterpret_cast<char4*>(dst + (size_t)t * x_stride) + w) = c;
  }
  if (tid == 0) *scale_ptr = from_float<T>(s_new);
}

}  // namespace

// One layer: k_pages/v_pages [N, page, KV, hd] int8, k_scales/v_scales
// [N, KV] and k/v [B, KV, hd] in dtype (bf16 0, f32 1), tables [slots, P],
// slot_ids/positions [B] int32, valid [B] bool or null.
extern "C" int mcf_kv_quant_store_decode(void* k_pages, void* v_pages, void* k_scales,
                                         void* v_scales, const void* k, const void* v,
                                         const void* tables, const void* slot_ids,
                                         const void* positions, const void* valid, int B,
                                         int KV, int hd, int page_size, int P, int dtype,
                                         void* stream) {
  if (B < 0 || KV <= 0 || hd <= 0 || hd % 8 || page_size <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  StoreParams p{{static_cast<int8_t*>(k_pages), static_cast<int8_t*>(v_pages)},
                {k_scales, v_scales},
                {k, v},
                static_cast<const int32_t*>(tables),
                static_cast<const int32_t*>(slot_ids),
                static_cast<const int32_t*>(positions),
                static_cast<const bool*>(valid),
                B, KV, hd, page_size, P};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaGetLastError();
  const dim3 grid(B, KV, 2);
  if (dtype == kBF16)
    quant_store_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(p);
  else if (dtype == kF32)
    quant_store_kernel<float><<<grid, NT, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Pages a span of S tokens can touch: it may start at a page's last offset.
static int span_pages(int S, int page_size) { return (S + 2 * page_size - 2) / page_size; }

// One layer: k_pages/v_pages [N, page, KV, hd] int8, k_scales/v_scales
// [N, KV] and k/v [B, S, KV, hd] in dtype (bf16 0, f32 1), tables
// [slots, P], slot_ids [B] and positions [B, S] int32, valid [B, S] bool.
extern "C" int mcf_kv_quant_store_span(void* k_pages, void* v_pages, void* k_scales,
                                       void* v_scales, const void* k, const void* v,
                                       const void* tables, const void* slot_ids,
                                       const void* positions, const void* valid, int B, int S,
                                       int KV, int hd, int page_size, int P, int dtype,
                                       void* stream) {
  if (B < 0 || S <= 0 || KV <= 0 || hd <= 0 || hd % 8 || page_size <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  SpanParams p{{static_cast<int8_t*>(k_pages), static_cast<int8_t*>(v_pages)},
               {k_scales, v_scales},
               {k, v},
               static_cast<const int32_t*>(tables),
               static_cast<const int32_t*>(slot_ids),
               static_cast<const int32_t*>(positions),
               static_cast<const bool*>(valid),
               B, S, KV, hd, page_size, P};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaGetLastError();
  const dim3 grid(B, min(span_pages(S, page_size), P), 2 * KV);
  if (dtype == kBF16)
    span_store_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(p);
  else if (dtype == kF32)
    span_store_kernel<float><<<grid, NT, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
