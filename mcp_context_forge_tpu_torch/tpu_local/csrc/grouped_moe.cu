// Grouped expert FFN over expert-sorted row-blocks (the dropless MoE FFN),
// for Hopper (sm_90a), on WMMA: the cases the wgmma kernel
// (grouped_moe_tc.cu: bf16 activations, Bt a multiple of 64, D of 256 and
// F of 128) does not take, such as f32 and moe_block 8;
// ops/grouped_moe.py moe_route chooses. Two C entries:
//   mcf_expert_blocks     full-precision expert stacks (bf16 or f32)
//   mcf_expert_blocks_q8  int8 expert stacks with per-(expert, out-channel)
//                         scales
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/grouped_moe.py,
// _expert_blocks_pallas (kernel body _moe_block_kernel) and
// _expert_blocks_pallas_q8 (_moe_block_kernel_q8), which the JAX engine
// reaches from models/llama.py _ffn_block through moe_ffn_grouped whenever
// a batch has T*k >= E*moe_block token-expert pairs (prefill).
//
// Semantics, for each row-block b of Bt rows, owned by e = block_expert[b]:
//   h   = act(x_b @ w1[e]) * (x_b @ w3[e])                         (f32)
//   out = h @ w2[e]                                                 (x's dtype)
// and with int8 stacks (scales s1/s3 [E, F], s2 [E, D], in x's dtype):
//   h   = act((x_b @ q1[e]) * s1[e]) * ((x_b @ q3[e]) * s3[e])      (f32)
//   out = (h @ q2[e]) * s2[e]
// act: SiLU, or tanh-approximate GeLU. Every row of every block is written
// (group padding rows are zeros in x and come out zero).
//
// Design. The TPU kernel walks F tiles in order and accumulates h @ w2 in
// VMEM scratch; blocks here run in parallel with nothing carried between
// them, so the work is two launches:
//   phase A, grid (row tiles of every block, F / 64): h in f32 into a
//     workspace [NB*Bt, F] that the wrapper allocates;
//   phase B, grid (row tiles of every block, D / 64): out = h @ w2.
// Each CTA reads its block's expert id itself (this card has no scalar
// prefetch). The grid's fastest axis walks the row-blocks, so the blocks
// of one expert run side by side and share each weight tile through L2.
// bf16 activations run on the tensor cores (WMMA 16x16x16, f32
// accumulate): bf16 x bf16 products are exact in f32, and int8 weights
// widen to bf16 exactly. h stays f32 in device memory; phase B splits each
// value into bf16 hi + lo halves on load and runs two MMAs, so the product
// sees 16 bits of h's mantissa rather than bf16's 8. f32 activations run
// on the FMA pipes in f32 throughout.
//
// What bounds it: operations. At Mixtral-8x7B widths (D 4096, F 14336,
// Bt 128) and T = 2048 tokens (NB = 40 blocks), 6*NB*Bt*D*F = 1.80 TFLOP
// against 2.82 GB of bf16 weights (1.41 GB int8): 1.82 ms at the bf16
// tensor-core peak vs 0.84 ms of bytes. This kernel loads tiles
// synchronously (no cp.async / TMA pipeline) and uses WMMA, not wgmma;
// phase B's hi/lo split doubles its MMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// dtype and activation codes shared with the Python wrapper
constexpr int kBF16 = 0;
constexpr int kF32 = 1;
constexpr int kSilu = 0;
constexpr int kGelu = 1;

struct MoeArgs {
  const void* x;                 // [NB*Bt, D]
  const void* w1;                // [E, D, F] (q1 in the int8 entry)
  const void* w3;                // [E, D, F]
  const void* w2;                // [E, F, D]
  const void* s1;                // [E, F] (int8 entry only)
  const void* s3;                // [E, F]
  const void* s2;                // [E, D]
  const int32_t* block_expert;   // [NB]
  float* h;                      // workspace [NB*Bt, F]
  void* out;                     // [NB*Bt, D]
  int NB, Bt, D, F, E, act;
};

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v / (1.f + expf(-v));
}

// 8 consecutive elements (16-, 32- or 8-byte aligned) -> f32
__device__ __forceinline__ void load8(const bf16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// 8 f32 -> 8 bf16 (round to nearest even), one 16-byte store
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// The rows of block b that one CTA owns: BM rows from r0 on, of which
// ``rows`` exist (a block of Bt rows spans ceil(Bt / BM) row tiles).
struct RowTile {
  int b, rows, e;
  long long row0;  // global row of the tile's first row
};

template <int BM>
__device__ __forceinline__ RowTile row_tile(const MoeArgs& a) {
  const int tiles = (a.Bt + BM - 1) / BM;
  RowTile t;
  t.b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BM;
  t.rows = min(BM, a.Bt - r0);
  t.row0 = (long long)t.b * a.Bt + r0;
  // the routing plan clamps block owners to [0, E); guard the read anyway
  t.e = min(max(a.block_expert[t.b], 0), a.E - 1);
  return t;
}

// ------------------------------------------------------------ tensor cores
// bf16 activations. CTA tile BM x BN = 128 x 64, K step 32; eight warps in
// a 4 x 2 grid, each owning a 32 x 32 patch (2 x 2 fragments).
constexpr int kTcBM = 128, kTcBN = 64, kTcBK = 32, kTcThreads = 256;
constexpr int kTcLDA = kTcBK + 8;   // bf16 elements; rows stay 32-byte aligned
constexpr int kTcLDB = kTcBN + 8;
constexpr int kTcLDC = kTcBN + 4;   // f32 epilogue staging

constexpr size_t tc_up_smem() {
  // main loop: X [BM][LDA] + W1, W3 [BK][LDB] bf16; epilogue: C1, C3 [BM][LDC] f32
  return 2 * (size_t)kTcBM * kTcLDC * 4;
}
constexpr size_t tc_down_smem() {
  // main loop: Hhi, Hlo [BM][LDA] + W2 [BK][LDB] bf16 (25 KB); epilogue C [BM][LDC] f32
  return (size_t)kTcBM * kTcLDC * 4;
}
static_assert(2 * kTcBM * kTcLDA * 2 + kTcBK * kTcLDB * 2 <= tc_down_smem(),
              "phase B tiles fit the epilogue buffer");
static_assert(kTcBM * kTcLDA * 2 + 2 * kTcBK * kTcLDB * 2 <= tc_up_smem(),
              "phase A tiles fit the epilogue buffer");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <typename TW, bool Q8>
__global__ void __launch_bounds__(kTcThreads) moe_up_tc(MoeArgs a) {
  constexpr int BM = kTcBM, BN = kTcBN, BK = kTcBK, NT = kTcThreads;
  constexpr int LDA = kTcLDA, LDB = kTcLDB, LDC = kTcLDC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);   // [BM][LDA]
  bf16* W1s = Xs + BM * LDA;                  // [BK][LDB]
  bf16* W3s = W1s + BK * LDB;                 // [BK][LDB]
  float* C1 = reinterpret_cast<float*>(smem); // [BM][LDC], after the loop
  float* C3 = C1 + BM * LDC;

  const int tid = threadIdx.x;
  const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
  const RowTile t = row_tile<BM>(a);
  const int f0 = blockIdx.y * BN;
  const int D = a.D, F = a.F;
  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const TW* __restrict__ w1 = static_cast<const TW*>(a.w1) + (long long)t.e * D * F;
  const TW* __restrict__ w3 = static_cast<const TW*>(a.w3) + (long long)t.e * D * F;

  FragC acc1[2][2], acc3[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc1[i][j], 0.f);
      wmma::fill_fragment(acc3[i][j], 0.f);
    }

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < t.rows && k0 + c8 < D) load8(x + (t.row0 + r) * D + k0 + c8, v);
      store8_bf16(Xs + r * LDA + c8, v);
    }
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int kr = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
      float v1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float v3[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + kr < D && f0 + c8 < F) {
        const long long off = (long long)(k0 + kr) * F + f0 + c8;
        load8(w1 + off, v1);
        load8(w3 + off, v3);
      }
      store8_bf16(W1s + kr * LDB + c8, v1);
      store8_bf16(W3s + kr * LDB + c8, v3);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[2];
      FragB fb;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Xs + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, W1s + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc1[i][j], fa[i], fb, acc1[i][j]);
        wmma::load_matrix_sync(fb, W3s + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc3[i][j], fa[i], fb, acc3[i][j]);
      }
    }
    __syncthreads();  // the next K step overwrites the tiles
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wr * 32 + i * 16) * LDC + wc * 32 + j * 16;
      wmma::store_matrix_sync(C1 + off, acc1[i][j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(C3 + off, acc3[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < t.rows * BN; i += NT) {
    const int r = i / BN, c = i % BN, f = f0 + c;
    if (f >= F) continue;
    float g = C1[r * LDC + c], u = C3[r * LDC + c];
    if (Q8) {
      g *= to_f32(static_cast<const bf16*>(a.s1)[(long long)t.e * F + f]);
      u *= to_f32(static_cast<const bf16*>(a.s3)[(long long)t.e * F + f]);
    }
    a.h[(t.row0 + r) * F + f] = act_fn(g, a.act) * u;
  }
}

template <typename TW, bool Q8>
__global__ void __launch_bounds__(kTcThreads) moe_down_tc(MoeArgs a) {
  constexpr int BM = kTcBM, BN = kTcBN, BK = kTcBK, NT = kTcThreads;
  constexpr int LDA = kTcLDA, LDB = kTcLDB, LDC = kTcLDC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Hhi = reinterpret_cast<bf16*>(smem);  // [BM][LDA]
  bf16* Hlo = Hhi + BM * LDA;                 // [BM][LDA]
  bf16* W2s = Hlo + BM * LDA;                 // [BK][LDB]
  float* C = reinterpret_cast<float*>(smem);  // [BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
  const RowTile t = row_tile<BM>(a);
  const int d0 = blockIdx.y * BN;
  const int D = a.D, F = a.F;
  const float* __restrict__ h = a.h;
  const TW* __restrict__ w2 = static_cast<const TW*>(a.w2) + (long long)t.e * F * D;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < t.rows && k0 + c8 < F) load8(h + (t.row0 + r) * F + k0 + c8, v);
      float hi[8], lo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hi[e] = __bfloat162float(__float2bfloat16(v[e]));
        lo[e] = v[e] - hi[e];  // exact in f32
      }
      store8_bf16(Hhi + r * LDA + c8, hi);
      store8_bf16(Hlo + r * LDA + c8, lo);
    }
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int kr = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + kr < F && d0 + c8 < D) load8(w2 + (long long)(k0 + kr) * D + d0 + c8, v);
      store8_bf16(W2s + kr * LDB + c8, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fhi[2], flo[2];
      FragB fb;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fhi[i], Hhi + (wr * 32 + i * 16) * LDA + kk, LDA);
        wmma::load_matrix_sync(flo[i], Hlo + (wr * 32 + i * 16) * LDA + kk, LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, W2s + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc[i][j], fhi[i], fb, acc[i][j]);
          wmma::mma_sync(acc[i][j], flo[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(C + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
  for (int i = tid; i < t.rows * BN; i += NT) {
    const int r = i / BN, c = i % BN, d = d0 + c;
    if (d >= D) continue;
    float v = C[r * LDC + c];
    if (Q8) v *= to_f32(static_cast<const bf16*>(a.s2)[(long long)t.e * D + d]);
    store1(out + (t.row0 + r) * D + d, v);
  }
}

// ---------------------------------------------------------------- FMA pipes
// f32 activations. CTA tile 64 x 64, K step 16, 256 threads; each thread
// owns rows ty + 16*i and columns tx + 16*j (i, j < 4).
constexpr int kFmBM = 64, kFmBN = 64, kFmBK = 16, kFmThreads = 256;

template <typename TW, bool Q8>
__global__ void __launch_bounds__(kFmThreads) moe_up_fma(MoeArgs a) {
  constexpr int BM = kFmBM, BN = kFmBN, BK = kFmBK, NT = kFmThreads;
  __shared__ float Xs[BK][BM + 4];  // transposed: [k][row]
  __shared__ float W1s[BK][BN];
  __shared__ float W3s[BK][BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const RowTile t = row_tile<BM>(a);
  const int f0 = blockIdx.y * BN;
  const int D = a.D, F = a.F;
  const float* __restrict__ x = static_cast<const float*>(a.x);
  const TW* __restrict__ w1 = static_cast<const TW*>(a.w1) + (long long)t.e * D * F;
  const TW* __restrict__ w3 = static_cast<const TW*>(a.w3) + (long long)t.e * D * F;

  float acc1[4][4], acc3[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc3[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < t.rows && k0 + c8 < D) load8(x + (t.row0 + r) * D + k0 + c8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) Xs[c8 + e][r] = v[e];
    }
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int kr = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
      float v1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float v3[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + kr < D && f0 + c8 < F) {
        const long long off = (long long)(k0 + kr) * F + f0 + c8;
        load8(w1 + off, v1);
        load8(w3 + off, v3);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        W1s[kr][c8 + e] = v1[e];
        W3s[kr][c8 + e] = v3[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xa[4], b1[4], b3[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = W1s[kk][tx + 16 * j];
        b3[j] = W3s[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(xa[i], b1[j], acc1[i][j]);
          acc3[i][j] = fmaf(xa[i], b3[j], acc3[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, f = f0 + tx + 16 * j;
      if (r >= t.rows || f >= F) continue;
      float g = acc1[i][j], u = acc3[i][j];
      if (Q8) {
        g *= to_f32(static_cast<const float*>(a.s1)[(long long)t.e * F + f]);
        u *= to_f32(static_cast<const float*>(a.s3)[(long long)t.e * F + f]);
      }
      a.h[(t.row0 + r) * F + f] = act_fn(g, a.act) * u;
    }
}

template <typename TW, bool Q8>
__global__ void __launch_bounds__(kFmThreads) moe_down_fma(MoeArgs a) {
  constexpr int BM = kFmBM, BN = kFmBN, BK = kFmBK, NT = kFmThreads;
  __shared__ float Hs[BK][BM + 4];  // transposed: [k][row]
  __shared__ float W2s[BK][BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const RowTile t = row_tile<BM>(a);
  const int d0 = blockIdx.y * BN;
  const int D = a.D, F = a.F;
  const float* __restrict__ h = a.h;
  const TW* __restrict__ w2 = static_cast<const TW*>(a.w2) + (long long)t.e * F * D;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < t.rows && k0 + c8 < F) load8(h + (t.row0 + r) * F + k0 + c8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) Hs[c8 + e][r] = v[e];
    }
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int kr = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + kr < F && d0 + c8 < D) load8(w2 + (long long)(k0 + kr) * D + d0 + c8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) W2s[kr][c8 + e] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ha[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ha[i] = Hs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = W2s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ha[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* __restrict__ out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, d = d0 + tx + 16 * j;
      if (r >= t.rows || d >= D) continue;
      float v = acc[i][j];
      if (Q8) v *= static_cast<const float*>(a.s2)[(long long)t.e * D + d];
      out[(t.row0 + r) * D + d] = v;
    }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, size_t smem,
               const MoeArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Phase A then phase B on ``stream``; returns the first launch error.
template <typename TX, typename TW, bool Q8>
int launch(const MoeArgs& a, cudaStream_t stream) {
  if (a.NB <= 0 || a.Bt <= 0) return (int)cudaGetLastError();
  if constexpr (std::is_same<TX, bf16>::value) {
    const unsigned row_tiles = (unsigned)a.NB * ((a.Bt + kTcBM - 1) / kTcBM);
    int err = launch_one(moe_up_tc<TW, Q8>,
                         dim3(row_tiles, (a.F + kTcBN - 1) / kTcBN),
                         kTcThreads, tc_up_smem(), a, stream);
    if (err != 0) return err;
    return launch_one(moe_down_tc<TW, Q8>,
                      dim3(row_tiles, (a.D + kTcBN - 1) / kTcBN),
                      kTcThreads, tc_down_smem(), a, stream);
  } else {
    const unsigned row_tiles = (unsigned)a.NB * ((a.Bt + kFmBM - 1) / kFmBM);
    int err = launch_one(moe_up_fma<TW, Q8>,
                         dim3(row_tiles, (a.F + kFmBN - 1) / kFmBN),
                         kFmThreads, 0, a, stream);
    if (err != 0) return err;
    return launch_one(moe_down_fma<TW, Q8>,
                      dim3(row_tiles, (a.D + kFmBN - 1) / kFmBN),
                      kFmThreads, 0, a, stream);
  }
}

bool valid_shape(int NB, int Bt, int D, int F, int E, int act) {
  return NB >= 0 && Bt > 0 && Bt % 8 == 0 && D > 0 && D % 8 == 0 && F > 0 &&
         F % 8 == 0 && E > 0 && (act == kSilu || act == kGelu);
}

}  // namespace

extern "C" int mcf_expert_blocks(const void* x, const void* w1, const void* w3,
                                 const void* w2, const void* block_expert,
                                 void* h, void* out, int NB, int Bt, int D,
                                 int F, int E, int act, int dtype,
                                 void* stream) {
  if (!valid_shape(NB, Bt, D, F, E, act)) return (int)cudaErrorInvalidValue;
  MoeArgs a{x, w1, w3, w2, nullptr, nullptr, nullptr,
            static_cast<const int32_t*>(block_expert), static_cast<float*>(h),
            out, NB, Bt, D, F, E, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16, bf16, false>(a, s);
  if (dtype == kF32) return launch<float, float, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mcf_expert_blocks_q8(const void* x, const void* q1,
                                    const void* s1, const void* q3,
                                    const void* s3, const void* q2,
                                    const void* s2, const void* block_expert,
                                    void* h, void* out, int NB, int Bt, int D,
                                    int F, int E, int act, int dtype,
                                    void* stream) {
  if (!valid_shape(NB, Bt, D, F, E, act)) return (int)cudaErrorInvalidValue;
  MoeArgs a{x, q1, q3, q2, s1, s3, s2,
            static_cast<const int32_t*>(block_expert), static_cast<float*>(h),
            out, NB, Bt, D, F, E, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16, int8_t, true>(a, s);
  if (dtype == kF32) return launch<float, int8_t, true>(a, s);
  return (int)cudaErrorInvalidValue;
}
