// Grouped expert FFN over expert-sorted row-blocks (the dropless MoE FFN)
// on Hopper's tensor cores (sm_90a): bf16 activations, Bt a multiple of 64,
// D a multiple of 256 and F of 128. Two C entries:
//   mcf_expert_blocks_tc     bf16 expert stacks
//   mcf_expert_blocks_tc_q8  int8 expert stacks with per-(expert, out-channel)
//                            bf16 scales
// Other geometries (f32, Bt 8, narrow widths) keep the WMMA kernel
// (grouped_moe.cu); ops/grouped_moe.py moe_route chooses.
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/grouped_moe.py,
// _expert_blocks_pallas (kernel body _moe_block_kernel) and
// _expert_blocks_pallas_q8 (_moe_block_kernel_q8), which the JAX engine
// reaches from models/llama.py _ffn_block through moe_ffn_grouped whenever
// a batch has T*k >= E*moe_block token-expert pairs (prefill).
//
// Semantics, for each row-block b of Bt rows, owned by e = block_expert[b]:
//   h   = act(x_b @ w1[e]) * (x_b @ w3[e])                         (f32)
//   out = h @ w2[e]                                                 (bf16)
// and with int8 stacks (scales s1/s3 [E, F], s2 [E, D], bf16):
//   h   = act((x_b @ q1[e]) * s1[e]) * ((x_b @ q3[e]) * s3[e])      (f32)
//   out = (h @ q2[e]) * s2[e]
// act: SiLU, or tanh-approximate GeLU.
//
// What bounds it: operations. At Mixtral-8x7B widths (D 4096, F 14336,
// Bt 128) and T = 2048 tokens (NB = 40 blocks), 6*NB*Bt*D*F = 1.80 TFLOP
// against 2.82 GB of bf16 weights (1.41 GB int8): 1.82 ms at the bf16
// tensor-core peak against 0.84 ms of bytes. Phase B runs its product
// twice (below), so this numerics' floor is 8/6 of that, ~2.4 ms.
//
// Design. Blocks share nothing and a [Bt, D] f32 accumulator over all of F
// does not fit on chip, so the work is two launches:
//   phase A (up), grid (row tiles, F / 128): h of one row tile and 128 F
//     columns; both w1 and w3 tiles against one shared x tile, two
//     accumulators, act(gate) * up in the epilogue;
//   phase B (down), grid (row tiles, D / 256): out of one row tile and 256 D
//     columns over K = F, two 128-column accumulators.
// A CTA is one or two consumer warpgroups of 64 rows (two when Bt % 128 ==
// 0), all in one block, so all share the block's expert, which each CTA
// reads from block_expert itself (there is no scalar prefetch on this
// card). The grid's fastest axis walks the row tiles, so the blocks of one
// expert run side by side and share each weight tile through L2.
//   - Operands: x and h are K-major A operands, TMA'd as 64-column boxes
//     under the 128-byte swizzle; w1[e] [D, F] and w2[e] [F, D] have N
//     contiguous, so they are MN-major B operands (the V operand of the
//     attention kernels), two 64-column slabs per 128-column accumulator.
//     Each k-step of 64 is one stage of a TMA ring (four stages in phase A,
//     three in phase B) on mbarriers; every CTA thread issues wgmma
//     m64n128k16 from shared memory, keeps one k-step in flight behind the
//     current one, and the warpgroup that releases a stage last refills it
//     (one thread issues the copies; no producer warp).
//   - h keeps 16 bits of its f32 mantissa into phase B: phase A's epilogue
//     writes hi = bf16(h) and lo = bf16(h - hi) (the same bytes as an f32
//     workspace), and phase B runs one wgmma on hi and one on lo per k-step
//     and B tile, so the product sees h as the f32 plain version does
//     (within 2^-17 of each value) rather than rounded to bf16.
//   - int8 stacks: TMA brings the int8 weight tiles into the ring
//     unswizzled; all threads widen them to bf16 (exact: |q| <= 127, by a
//     byte permute into an f32's mantissa and one subtract) into one of two
//     swizzled operand buffers, one CTA barrier per k-step, while the
//     previous k-step's wgmmas run. HBM traffic stays int8-sized. s1/s3
//     scale the gate and up columns before act in phase A's epilogue, s2
//     the output columns in phase B's.
#include "hopper_tc.cuh"

namespace {

using namespace tc;
using bf16 = __nv_bfloat16;

constexpr int kSilu = 0;
constexpr int kGelu = 1;
constexpr int BK = 64;             // k-step: one 128-byte swizzle row of bf16
constexpr int BN = 128;            // columns of one accumulator (wgmma m64n128)
constexpr int SLAB = BK * 128;     // bytes of one [64 x 64] bf16 slab
constexpr int kBf16B = 2 * SLAB;   // one bf16 B operand: [BK x 128], two slabs
constexpr int kInt8B = BK * BN;    // one int8 B operand: [BK x 128]

struct MoeTcArgs {
  const int32_t* block_expert;  // [NB]
  const bf16* s1;               // [E, F] (int8 stacks only)
  const bf16* s3;               // [E, F]
  const bf16* s2;               // [E, D]
  bf16* hi;                     // [NB*Bt, F]
  bf16* lo;                     // [NB*Bt, F]
  bf16* out;                    // [NB*Bt, D]
  int Bt, D, F, E, act;
};

// Phase A (DOWN false) or B, int8 stacks or not, WG consumer warpgroups.
template <bool DOWN, bool Q8, int WG>
struct Cfg {
  static constexpr int NT = 128 * WG;
  static constexpr int BM = 64 * WG;                  // rows per CTA
  static constexpr int STAGES = DOWN ? 3 : 4;
  static constexpr int NA = DOWN ? 2 : 1;             // A operands: x, or hi and lo
  static constexpr int kA = BM * 128;                 // one A operand [BM x 64] bf16
  static constexpr int kB = Q8 ? kInt8B : kBf16B;     // one B operand as TMA writes it
  static constexpr int kStage = NA * kA + 2 * kB;     // two B operands per stage
  static constexpr int kOps = Q8 ? 2 * 2 * kBf16B : 0;  // widened B, double-buffered
  static constexpr int kBars = STAGES * kStage + kOps;
  static constexpr int kBytes = 1024 + kBars + 12 * STAGES;  // + barriers, release counts
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v / (1.f + expf(-v));
}

// The k-step kt's A and B tiles into ring stage kt % STAGES; one thread.
// A: [BM rows x 64] of x (phase A) or of hi and lo (phase B) at (k0, row0).
// B operand j: [64 k-rows x 128 columns] of w1 / w3 at column n0 (phase A)
// or of w2 at column n0 + 128 j (phase B), rows e*K + k0 of the [E*K, N]
// stack: two 64-column swizzled boxes in bf16, one 128-column box in int8.
template <bool DOWN, bool Q8, int WG>
__device__ __forceinline__ void load_stage(uint32_t stages, uint32_t bar_full,
                                           const CUtensorMap* ma0, const CUtensorMap* ma1,
                                           const CUtensorMap* mb0, const CUtensorMap* mb1,
                                           int kt, int row0, int n0, int krow0) {
  using C = Cfg<DOWN, Q8, WG>;
  const int st = kt % C::STAGES;
  const int k0 = kt * BK;
  const uint32_t bar = bar_full + 8 * st;
  const uint32_t dst = stages + st * C::kStage;
  mbar_expect_tx(bar, C::kStage);
  tma_load_2d(dst, ma0, bar, k0, row0);
  if (DOWN) tma_load_2d(dst + C::kA, ma1, bar, k0, row0);
  const uint32_t b_dst = dst + C::NA * C::kA;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const CUtensorMap* mb = (DOWN || j == 0) ? mb0 : mb1;
    const int col = DOWN ? n0 + BN * j : n0;
    tma_load_2d(b_dst + j * C::kB, mb, bar, col, krow0 + k0);
    if (!Q8) tma_load_2d(b_dst + j * C::kB + SLAB, mb, bar, col + 64, krow0 + k0);
  }
}

// 8 int8 values -> 8 bf16 (exact): each byte, biased to unsigned, becomes
// the low mantissa byte of 2^23 + u; subtracting 2^23 + 128 leaves the value.
__device__ __forceinline__ uint4 widen8(uint2 v) {
  const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540u | (i % 4))) - 8388736.f;
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// The two int8 B operands [BK x 128] at ``raw`` widened to bf16 MN-major
// operands at ``ops`` (two 64-column slabs each, 128-byte swizzled as TMA
// would have written them).
template <int NT>
__device__ __forceinline__ void widen_b(const unsigned char* raw, unsigned char* ops) {
  constexpr int CH = BN / 8;  // 8-value chunks per k-row
  for (int i = threadIdx.x; i < 2 * BK * CH; i += NT) {
    const int j = i / (BK * CH), rem = i - j * (BK * CH);
    const int r = rem / CH, c = rem - r * CH;
    const uint2 v8 = *reinterpret_cast<const uint2*>(raw + j * kInt8B + r * BN + c * 8);
    *reinterpret_cast<uint4*>(ops + j * kBf16B + (c / 8) * SLAB + r * 128 +
                              (((c % 8) ^ (r % 8)) << 4)) = widen8(v8);
  }
}

// One k-step's wgmmas of this warpgroup: 4 steps of k16; per step, each A
// operand (x; or hi then lo) against both B operands.
template <int NA>
__device__ __forceinline__ void issue_kstep(float (&acc0)[64], float (&acc1)[64], uint32_t a,
                                            int a_stride, uint32_t b0, uint32_t b1) {
  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const uint64_t da = sw128_desc(a + i * a_stride + kk * 32, 16, 1024);
      wgmma_ss_n128_tb(acc0, da, sw128_desc(b0 + kk * 16 * 128, SLAB, 1024));
      wgmma_ss_n128_tb(acc1, da, sw128_desc(b1 + kk * 16 * 128, SLAB, 1024));
    }
  }
  wgmma_commit();
}

// Two output columns (times their int8 scales) as one bf16 pair.
template <bool Q8>
__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1, const bf16* scale) {
  if (Q8) {
    v0 *= __bfloat162float(scale[0]);
    v1 *= __bfloat162float(scale[1]);
  }
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

template <bool DOWN, bool Q8, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
    moe_tc_kernel(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap ma1,
                  const __grid_constant__ CUtensorMap mb0, const __grid_constant__ CUtensorMap mb1,
                  MoeTcArgs a) {
  using C = Cfg<DOWN, Q8, WG>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::kBars;  // [STAGES] x 8 bytes
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + C::kBars + 8 * C::STAGES);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * (DOWN ? 2 * BN : BN);
  const int K = DOWN ? a.F : a.D;
  const int N = DOWN ? a.D : a.F;
  // the routing plan clamps block owners to [0, E); guard the read anyway
  const int e = min(max(a.block_expert[row0 / a.Bt], 0), a.E - 1);
  const int krow0 = e * K;  // the expert's first row of the [E*K, N] stack
  const int nk = K / BK;

  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      released[st] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < min(nk, C::STAGES); ++kt)
      load_stage<DOWN, Q8, WG>(base, bar_full, &ma0, &ma1, &mb0, &mb1, kt, row0, n0, krow0);

  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % C::STAGES;
    const uint32_t stage = base + st * C::kStage;
    mbar_wait(bar_full + 8 * st, (kt / C::STAGES) & 1);
    if constexpr (Q8) {
      // widen this k-step's B into the buffer of its parity (read last by
      // k-step kt - 2, complete before the last barrier), let k-step kt - 1
      // finish, and meet the CTA: stage kt - 1 is then free to refill
      widen_b<C::NT>(smem + st * C::kStage + C::NA * C::kA,
                     smem + C::STAGES * C::kStage + (kt % 2) * 2 * kBf16B);
      wgmma_wait<0>();
      fence_proxy_async();
      __syncthreads();
      if (tid == 0 && kt > 0 && kt - 1 + C::STAGES < nk)
        load_stage<DOWN, Q8, WG>(base, bar_full, &ma0, &ma1, &mb0, &mb1, kt - 1 + C::STAGES,
                                 row0, n0, krow0);
      const uint32_t ops = base + C::STAGES * C::kStage + (kt % 2) * 2 * kBf16B;
      issue_kstep<C::NA>(acc0, acc1, stage + wg * 64 * 128, C::kA, ops, ops + kBf16B);
    } else {
      const uint32_t b = stage + C::NA * C::kA;
      issue_kstep<C::NA>(acc0, acc1, stage + wg * 64 * 128, C::kA, b, b + C::kB);
      wgmma_wait<1>();  // k-step kt - 1 is done: its stage may be refilled
      const int refill = kt - 1 + C::STAGES;
      if (tid % 128 == 0 && kt > 0 && refill < nk) {
        uint32_t* count = released + (kt - 1) % C::STAGES;
        if (WG == 1 || atomicAdd(count, 1u) == WG - 1) {
          *count = 0u;
          load_stage<DOWN, Q8, WG>(base, bar_full, &ma0, &ma1, &mb0, &mb1, refill, row0, n0,
                                   krow0);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);

  // epilogue: this thread holds rows lr and lr + 8 of the tile, columns
  // j*8 + col + {0, 1} of each accumulator
  const int lr = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int col = (lane % 4) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = row0 + lr + 8 * half;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int i0 = j * 4 + 2 * half;
      if constexpr (DOWN) {
        const int d = n0 + j * 8 + col;
        store_pair<Q8>(a.out + row * N + d, acc0[i0], acc0[i0 + 1], a.s2 + (long long)e * N + d);
        store_pair<Q8>(a.out + row * N + d + BN, acc1[i0], acc1[i0 + 1],
                       a.s2 + (long long)e * N + d + BN);
      } else {
        const int f = n0 + j * 8 + col;
        float g0 = acc0[i0], g1 = acc0[i0 + 1], u0 = acc1[i0], u1 = acc1[i0 + 1];
        if (Q8) {
          const long long s = (long long)e * N + f;
          g0 *= __bfloat162float(a.s1[s]);
          g1 *= __bfloat162float(a.s1[s + 1]);
          u0 *= __bfloat162float(a.s3[s]);
          u1 *= __bfloat162float(a.s3[s + 1]);
        }
        const float h0 = act_fn(g0, a.act) * u0, h1 = act_fn(g1, a.act) * u1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(a.hi + row * N + f) = hi;
        *reinterpret_cast<__nv_bfloat162*>(a.lo + row * N + f) =
            __floats2bfloat162_rn(h0 - hf.x, h1 - hf.y);
      }
    }
  }
}

template <bool DOWN, bool Q8, int WG>
int launch_phase(const CUtensorMap& ma0, const CUtensorMap& ma1, const CUtensorMap& mb0,
                 const CUtensorMap& mb1, const MoeTcArgs& a, int NB, cudaStream_t stream) {
  using C = Cfg<DOWN, Q8, WG>;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_tc_kernel<DOWN, Q8, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((long long)NB * a.Bt / C::BM),
                  (unsigned)(DOWN ? a.D / (2 * BN) : a.F / BN));
  moe_tc_kernel<DOWN, Q8, WG><<<grid, C::NT, C::kBytes, stream>>>(ma0, ma1, mb0, mb1, a);
  return (int)cudaGetLastError();
}

// Phase A then phase B (``phases`` bit 1 and bit 2) on ``stream``; returns
// the first error.
template <bool Q8, int WG>
int launch(const void* x, const void* w1, const void* w3, const void* w2, const MoeTcArgs& a,
           int NB, int phases, cudaStream_t stream) {
  const long long NP = (long long)NB * a.Bt;
  const int bm = 64 * WG, bcols = Q8 ? BN : 64;
  CUtensorMap mx, mhi, mlo, m1, m3, m2;
  if (!map_2d(&mx, x, false, NP, a.D, 64, bm) || !map_2d(&mhi, a.hi, false, NP, a.F, 64, bm) ||
      !map_2d(&mlo, a.lo, false, NP, a.F, 64, bm) ||
      !map_2d(&m1, w1, Q8, (long long)a.E * a.D, a.F, bcols, BK) ||
      !map_2d(&m3, w3, Q8, (long long)a.E * a.D, a.F, bcols, BK) ||
      !map_2d(&m2, w2, Q8, (long long)a.E * a.F, a.D, bcols, BK))
    return (int)cudaErrorInvalidValue;
  if (phases & 1) {
    const int err = launch_phase<false, Q8, WG>(mx, mx, m1, m3, a, NB, stream);
    if (err != 0) return err;
  }
  if (phases & 2) return launch_phase<true, Q8, WG>(mhi, mlo, m2, m2, a, NB, stream);
  return (int)cudaGetLastError();
}

template <bool Q8>
int run(const void* x, const void* w1, const void* w3, const void* w2, const void* s1,
        const void* s3, const void* s2, const void* block_expert, void* h, void* out, int NB,
        int Bt, int D, int F, int E, int act, int phases, void* stream) {
  if (NB < 0 || Bt <= 0 || Bt % 64 != 0 || D <= 0 || D % (2 * BN) != 0 || F <= 0 ||
      F % BN != 0 || E <= 0 || (act != kSilu && act != kGelu) || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  if (NB == 0) return (int)cudaGetLastError();
  bf16* hi = static_cast<bf16*>(h);
  MoeTcArgs a{static_cast<const int32_t*>(block_expert), static_cast<const bf16*>(s1),
              static_cast<const bf16*>(s3), static_cast<const bf16*>(s2), hi,
              hi + (long long)NB * Bt * F, static_cast<bf16*>(out), Bt, D, F, E, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bt % 128 == 0) return launch<Q8, 2>(x, w1, w3, w2, a, NB, phases, s);
  return launch<Q8, 1>(x, w1, w3, w2, a, NB, phases, s);
}

}  // namespace

// x, out: [NB*Bt, D] bf16; w1, w3: [E, D, F] bf16; w2: [E, F, D] bf16;
// block_expert: [NB] int32; h: workspace [2, NB*Bt, F] bf16 (hi, lo).
// ``phases``: 1 phase A, 2 phase B (over the h already in the workspace),
// 3 both.
extern "C" int mcf_expert_blocks_tc(const void* x, const void* w1, const void* w3,
                                    const void* w2, const void* block_expert, void* h,
                                    void* out, int NB, int Bt, int D, int F, int E, int act,
                                    int phases, void* stream) {
  return run<false>(x, w1, w3, w2, nullptr, nullptr, nullptr, block_expert, h, out, NB, Bt, D,
                    F, E, act, phases, stream);
}

// The same over int8 stacks q1, q3 [E, D, F], q2 [E, F, D] with bf16 scales
// s1, s3 [E, F] and s2 [E, D].
extern "C" int mcf_expert_blocks_tc_q8(const void* x, const void* q1, const void* s1,
                                       const void* q3, const void* s3, const void* q2,
                                       const void* s2, const void* block_expert, void* h,
                                       void* out, int NB, int Bt, int D, int F, int E, int act,
                                       int phases, void* stream) {
  return run<true>(x, q1, q3, q2, s1, s3, s2, block_expert, h, out, NB, Bt, D, F, E, act,
                   phases, stream);
}
