// Int8 KV-page writer for one decode token per row, K and V of one layer in
// one launch, for Hopper (sm_90a).
//
// Replaces: the int8 decode write of the JAX package,
// mcp_context_forge_tpu/tpu_local/kv/paged_cache.py:121 (_quant_store) as
// write_decode_kv (:208) calls it for a one-token span. It is not a
// pl.pallas_call: XLA fuses it for the reference. In eager PyTorch the same
// arithmetic (kv/paged_cache.py _quant_store) is ~35 launches per pool and
// layer, 2270 of a Llama-3-8B decode step's 4825 launches on int8 pages.
//
// What bounds it: HBM bytes. Per layer it reads B*KV*hd values of K and of
// V and writes as many int8 values and B*KV scales of each; a page whose
// running-max scale grows also has its resident [page, hd] values of that
// head read and written once (only then: a ratio of exactly 1 leaves them
// as they are). The arithmetic is a few f32 operations per byte.
//
// Design: one CTA of 128 threads per (row, KV head, K|V), grid (B, KV, 2).
// The CTA looks up its row's page, reduces max|x| over the head's hd values,
// settles the page's scale, requantizes the resident values 4 bytes per
// thread when the scale grew, then writes the token. Two live rows never
// write the same page, so CTAs meet only on the trash page 0 (invalid
// rows), whose contents are don't-care: no atomics.
//
// Numerics: the plain writer's, bit for bit on every page >= 1 and its
// scales. Built without --use_fast_math; divisions are IEEE (__fdiv_rn),
// products __fmul_rn (no contraction), rounding half to even (rintf):
//   tok   = (scale dtype)(amax / 127)
//   s_new = offset == 0 ? tok : max(s_old, tok)
//   ratio = s_old / max(s_new, 1e-8)          (offset > 0 only)
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
