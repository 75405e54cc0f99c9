// Causal prefill attention on Hopper's tensor cores (sm_90a): bf16 inputs,
// head dims 64 and 128.
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/attention.py,
// flash_attention_pallas (kernel body _flash_kernel), which the JAX engine
// reaches from models/llama.py prefill through causal_attention. f32 inputs
// and other head dims take the mma.sync kernel (flash_attention_mma.cu);
// the wrapper (ops/attention.py flash_route) makes that choice by dtype and
// hd.
//
// What bounds it: operations. FLOPs grow as S^2 (4*hd per attended (query,
// key) pair and head) against bytes growing as S; at Llama-3-8B's 32 query /
// 8 KV heads the FLOP bound passes the byte bound near S = 740, so the 2048
// bucket is FLOP-bound. The design puts those FLOPs on the tensor cores
// (the machinery is attention_tc.cuh, shared with the paged chunk kernel):
//   - one CTA owns 128 query rows r = s*G + g of one (batch row, KV head),
//     two consumer warpgroups of 64 rows each, so every K/V tile it stages
//     serves all G query heads of the group (K/V are never repeated to H
//     heads); Q is written once into shared memory in the 128-byte-swizzled
//     layout wgmma reads;
//   - S = Q K^T and O += P V run as wgmma m64nNk16 (bf16 in, f32
//     accumulate); P is rounded to bf16 in registers and fed as the register
//     A operand of the P V product, and V is read from shared memory as an
//     MN-major (transposed) B operand, so nothing is transposed;
//   - K/V tiles of 64 keys arrive by TMA (a 4-D tensor map over
//     [B, S, KV, hd], boxes of 64 hd columns x 64 keys, 128-byte swizzle;
//     keys past S arrive as zeros and are masked) into a four-stage ring of
//     mbarriers, so copies run ahead of the math; the warpgroup that
//     releases a stage last refills it (one thread issues the copy: no
//     producer warp, whose registers would cap the consumers' at 168);
//   - each warpgroup issues the next tile's S = Q K^T before it runs this
//     tile's softmax, so the tensor cores work while the exponentials do
//     (two score accumulators in registers; the two warpgroups also overlap
//     each other, as nothing in the key walk synchronises the CTA);
//   - the online softmax (running max m and sum l per row in f32 registers,
//     base-2 exponentials) is the Pallas body's; each CTA walks key tiles
//     only up to its causal frontier and skips the trailing tiles that hold
//     no valid key (the padding of a short prompt in a long bucket), and the
//     longest (last) query blocks launch first so the causal imbalance does
//     not leave the grid's tail on a few SMs.
//
// Semantics: out[b, s, h] = softmax_c(q.k_c / sqrt(hd)) @ v over keys
// c <= s with valid[b, c]; masked scores are -1e30. A tile whose keys are
// all invalid adds nothing to a row that sees a valid key; a row that sees
// none stays finite (its sum is floored at 1e-30). Any S; any G = H / KV.
#include "attention_tc.cuh"

namespace {

using namespace tc;

struct FlashParams {
  const __nv_bfloat16* q;  // [B, S, KV*G, hd]
  __nv_bfloat16* out;      // [B, S, KV*G, hd]
  const uint8_t* valid;    // [B, S]
  int S, KV, G;
  float scale_log2;        // log2(e) / sqrt(hd)
};

// Shared memory, from a 1024-byte-aligned base: Q, then STAGES x {K, V}
// (Tiles<HD>), the ring's barriers and release counts, and the validity
// bits of the walked keys.
template <int HD>
struct Layout {
  using T = Tiles<HD>;
  static constexpr int kBars = T::kQ + STAGES * T::kStage;
  static constexpr int kBits = kBars + 64;
  static size_t bytes(int S) { return 1024 + kBits + (size_t)((S + TK - 1) / TK) * (TK / 32) * 4; }
};

template <int HD>
__global__ void __launch_bounds__(NT, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, FlashParams p) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::kBars;  // [STAGES] x 8 bytes
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + L::kBars + 8 * STAGES);
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem + L::kBits);

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // the longest query blocks first
  const int S = p.S, G = p.G, H = p.KV * G, R = S * G;
  const int r0 = qb * BM;
  const int n_keys = min((min(r0 + BM, R) - 1) / G + 1, S);  // causal frontier
  int n_tiles = (n_keys + TK - 1) / TK;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      released[st] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_q<HD>(smem, p.q, b, S, H, G, kvh, r0);
  {
    // one bit per walked key: valid[b, c] (0 past S)
    const int warp = tid / 32, lane = tid % 32;
    for (int w = warp; w < n_tiles * (TK / 32); w += NT / 32) {
      const int c = w * 32 + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, c < S && p.valid[(long long)b * S + c] != 0);
      if (lane == 0) vbits[w] = bits;
    }
  }
  // Q was written through the generic proxy; wgmma reads through the async one
  fence_proxy_async();
  __syncthreads();
  // trailing tiles without a valid key are not walked
  while (n_tiles > 0 && (vbits[2 * n_tiles - 2] | vbits[2 * n_tiles - 1]) == 0) --n_tiles;

  const Ring ring{&tm_k, &tm_v, base + Tiles<HD>::kQ, bar_full, released, kvh, b, nullptr, 0};
  if (tid == 0)  // the first stages; the rest are refilled as they are released
    for (int t = 0; t < min(n_tiles, STAGES); ++t) load_tile<HD>(ring, t);

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the block; this
  // thread holds rows lr and lr + 8 of the accumulator fragments, columns
  // j*8 + col + {0, 1}
  const int wg = tid / 128, lane = tid % 32;
  const int lr = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  RowState st{kNegInf, kNegInf, 0.f, 0.f, (r0 + lr) / G, (r0 + lr + 8) / G, (lane % 4) * 2,
              r0 / G};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  key_walk<HD, true>(o, st, n_tiles, base + wg * 64 * 128, ring, vbits, p.scale_log2);
  store_rows<HD>(o, st, p.out, b, S, H, G, kvh, r0, lr);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
           int S, int KV, int G, cudaStream_t stream) {
  // [B, S, KV, hd] bf16 with boxes of 64 hd columns x TK keys; keys past S read 0
  CUtensorMap tm_k, tm_v;
  if (!map_4d(&tm_k, k, false, B, S, KV, HD, 64) || !map_4d(&tm_v, v, false, B, S, KV, HD, 64))
    return (int)cudaErrorInvalidValue;
  FlashParams p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
                static_cast<const uint8_t*>(valid), S, KV, G,
                1.4426950408889634f / sqrtf((float)HD)};
  const size_t smem = Layout<HD>::bytes(S);
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B, (S * G + BM - 1) / BM);
  flash_tc_kernel<HD><<<grid, NT, smem, stream>>>(tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, S, H, hd] bf16; k, v: [B, S, KV, hd] bf16; valid: [B, S] bool.
// hd 64 or 128; dtype is the wrappers' code, bf16 (0) only.
extern "C" int mcf_flash_attention_tc(const void* q, const void* k, const void* v,
                                      const void* valid, void* out, int B, int S, int H, int KV,
                                      int hd, int dtype, void* stream) {
  if (dtype != 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(q, k, v, valid, out, B, S, KV, H / KV, s);
  if (hd == 64) return launch<64>(q, k, v, valid, out, B, S, KV, H / KV, s);
  return (int)cudaErrorInvalidValue;
}
