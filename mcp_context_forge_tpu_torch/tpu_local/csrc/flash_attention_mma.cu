// Causal prefill attention on warp-level tensor-core tiles (mma.sync,
// sm_90a): f32 at any head dim, bf16 at the head dims the wgmma kernel
// (flash_attention_tc.cu: bf16 at hd 64 and 128) does not take, e.g.
// gemma-2b's 256 and the tiny configs' 16 and 32.
//
// Replaces: mcp_context_forge_tpu/tpu_local/ops/attention.py,
// flash_attention_pallas (kernel body _flash_kernel), which the JAX engine
// reaches from models/llama.py prefill through causal_attention; the
// wrapper's flash_route (ops/attention.py) sends every case the wgmma
// kernel does not take here.
//
// What bounds it: operations (4*hd per attended (query, key) pair and
// head, growing as S^2 against bytes growing as S). The design is
// FlashAttention-2's, on the machinery of attention_mma.cuh (shared with
// the paged chunk kernel, paged_chunk_attention_mma.cu):
//   - each warp owns 16 query rows r = s*G + g of one (batch row, KV head),
//     four warps to a CTA (64 rows). Smaller CTAs would fill more SMs at
//     small shapes, but each one's key walk is then a single warp's latency
//     chain: at B=2, S=256, G=2, KV=4 (f32, hd 32) 256 CTAs of one warp
//     took 0.0237 ms and 64 CTAs of four 0.0190 (H100);
//   - K/V tiles of 64 keys (32 at hd 256, so that two CTAs of four warps
//     share an SM in bf16 and one fits in f32) arrive by cp.async into a
//     double buffer and serve all G heads of the KV group and every warp of
//     the CTA;
//   - bf16 runs mma.sync m16n8k16, f32 3xTF32 m16n8k8 (attention_mma.cuh);
//     the head dim is a template value in {16, 32, 64, 128, 256};
//   - each CTA walks key tiles up to its causal frontier and skips the
//     trailing tiles with no valid key; the longest (last) query blocks
//     launch first.
//
// Semantics: out[b, s, h] = softmax_c(q.k_c / sqrt(hd)) @ v over keys
// c <= s with valid[b, c]; masked scores are -1e30 and the sum is floored
// at 1e-30, so a row that sees no valid key stays finite.
#include "attention_mma.cuh"

namespace {

using namespace mma;

template <typename T>
struct MmaParams {
  const T* q;             // [B, S, KV*G, hd]
  const T* k;             // [B, S, KV, hd]
  const T* v;
  const uint8_t* valid;   // [B, S]
  T* out;                 // [B, S, KV*G, hd]
  int S, KV, G, hd;
  float scale_log2;       // log2(e) / sqrt(hd)
};

// Shared memory: Q [kRows][LD], K [2][TKM][LD], V [2][TKM][LD], then one
// validity bit per walked key.
template <typename T, int HD>
size_t smem_bytes(int S) {
  using C = Cfg<T, HD>;
  return (size_t)(kRows + 4 * C::TKM) * C::LD * sizeof(T) +
         (size_t)((S + C::TKM - 1) / C::TKM) * (C::TKM / 32) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kWarps) flash_mma_kernel(MmaParams<T> p) {
  using C = Cfg<T, HD>;
  constexpr int TKM = C::TKM, NB = TKM / 8, WPT = TKM / 32;  // bit words per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kRows * C::LD;
  T* Vs = Ks + 2 * TKM * C::LD;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(Vs + 2 * TKM * C::LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // the longest query blocks first
  const int S = p.S, G = p.G, KV = p.KV, H = KV * G, R = S * G, hd = p.hd;
  const int r0 = qb * kRows;
  const int n_keys = min((min(r0 + kRows, R) - 1) / G + 1, S);  // causal frontier
  int n_tiles = (n_keys + TKM - 1) / TKM;

  // one bit per walked key: valid[b, c] (0 past S)
  for (int w = warp; w < n_tiles * WPT; w += kWarps) {
    const int c = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, c < S && p.valid[(long long)b * S + c] != 0);
    if (lane == 0) vbits[w] = bits;
  }
  __syncthreads();
  // trailing tiles without a valid key are not walked
  for (;;) {
    if (n_tiles == 0) break;
    uint32_t any = 0u;
#pragma unroll
    for (int w = 0; w < WPT; ++w) any |= vbits[(n_tiles - 1) * WPT + w];
    if (any != 0u) break;
    --n_tiles;
  }

  auto load_kv = [&](int t, int buf) {
    T* kd = Ks + buf * TKM * C::LD;
    T* vd = Vs + buf * TKM * C::LD;
    for (int i = tid; i < TKM * C::CPR; i += 32 * kWarps) {
      const int j = i / C::CPR, col = (i % C::CPR) * C::EPC;
      const int key = t * TKM + j;
      const bool ok = key < S && col < hd;
      const long long off = ok ? (((long long)b * S + key) * KV + kvh) * hd + col : 0;
      cp_async16(smem_u32(kd + j * C::LD + col), p.k + off, ok);
      cp_async16(smem_u32(vd + j * C::LD + col), p.v + off, ok);
    }
  };
  if (n_tiles > 0) {
    load_q<T, HD>(Qs, p.q, b, S, H, G, kvh, r0, hd);
    load_kv(0, 0);
  }
  cp_async_commit();

  // this thread: rows g and g + 8 of its warp's 16, accumulator columns
  // nb*8 + 2*tg + {0, 1}
  const int g = lane / 4, tg = lane % 4;
  const int wr = warp * 16;
  const int pos0 = (r0 + wr + g) / G, pos1 = (r0 + wr + g + 8) / G;
  const int pos_first = (r0 + wr) / G;  // keys up to it need no causal mask
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
    __syncthreads();
    const T* kt = Ks + (t & 1) * TKM * C::LD;
    const T* vt = Vs + (t & 1) * TKM * C::LD;
    float s[NB][4];
    scores<T, HD>(s, Qw, kt, lane);

    // mask (validity bit and causality), scale to base 2, online softmax; an
    // interior tile (every key valid, none past the warp's first position)
    // needs no mask
    const int c0 = t * TKM;
    uint32_t words[WPT], all = 0xffffffffu;
#pragma unroll
    for (int w = 0; w < WPT; ++w) {
      words[w] = vbits[t * WPT + w];
      all &= words[w];
    }
    float mx0 = kNegInf, mx1 = kNegInf;
    if (all == 0xffffffffu && c0 + TKM - 1 <= pos_first) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] *= p.scale_log2;
          if (e < 2) mx0 = fmaxf(mx0, s[nb][e]);
          else mx1 = fmaxf(mx1, s[nb][e]);
        }
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nb * 8 + 2 * tg + (e & 1);  // word kl / 32 = nb / 4: a register
          const bool ok = ((words[nb / 4] >> (kl & 31)) & 1u) != 0u &&
                          c0 + kl <= (e < 2 ? pos0 : pos1);
          const float x = ok ? s[nb][e] * p.scale_log2 : kNegInf;
          s[nb][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
    }
    online_softmax(s, o, mx0, mx1, m0, m1, l0, l1);
    pv<T, HD>(o, s, vt, lane);
    __syncthreads();  // the next load overwrites this tile's buffer
  }

  store_out<T, HD>(o, l0, l1, p.out, b, S, H, G, kvh, r0 + wr + g, hd, tg);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
           int S, int KV, int G, int hd, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(S);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  MmaParams<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                 static_cast<const uint8_t*>(valid), static_cast<T*>(out), S, KV, G, hd,
                 1.4426950408889634f / sqrtf((float)hd)};
  const dim3 grid(KV, B, (unsigned)(((long long)S * G + kRows - 1) / kRows));
  flash_mma_kernel<T, HD><<<grid, 32 * kWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The smallest template head dim that holds ``hd``.
template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
              int S, int KV, int G, int hd, cudaStream_t s) {
  if (hd <= 16) return launch<T, 16>(q, k, v, valid, out, B, S, KV, G, hd, s);
  if (hd <= 32) return launch<T, 32>(q, k, v, valid, out, B, S, KV, G, hd, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, valid, out, B, S, KV, G, hd, s);
  if (hd <= 128) return launch<T, 128>(q, k, v, valid, out, B, S, KV, G, hd, s);
  return launch<T, 256>(q, k, v, valid, out, B, S, KV, G, hd, s);
}

}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, S, KV, hd]; valid: [B, S] bool. dtype
// is the wrappers' code: bf16 (0) or f32 (1); hd % 8 == 0, hd <= 256.
extern "C" int mcf_flash_attention_mma(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, int B, int S, int H, int KV,
                                       int hd, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<__nv_bfloat16>(q, k, v, valid, out, B, S, KV, H / KV, hd, s);
  if (dtype == 1) return launch_hd<float>(q, k, v, valid, out, B, S, KV, H / KV, hd, s);
  return (int)cudaErrorInvalidValue;
}
