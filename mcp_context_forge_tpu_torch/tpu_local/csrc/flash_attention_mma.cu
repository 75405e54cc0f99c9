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
// FlashAttention-2's:
//   - each warp owns 16 query rows r = s*G + g of one (batch row, KV head),
//     four warps to a CTA (64 rows). Smaller CTAs would fill more SMs at
//     small shapes, but each one's key walk is then a single warp's latency
//     chain: at B=2, S=256, G=2, KV=4 (f32, hd 32) 256 CTAs of one warp
//     took 0.0237 ms and 64 CTAs of four 0.0190 (H100);
//   - K/V tiles of 64 keys (32 at hd 256, so that two CTAs of four warps
//     share an SM in bf16 and one fits in f32) arrive by cp.async into a
//     double buffer and serve all G heads of the KV group and every warp of
//     the CTA;
//   - bf16: S = Q K^T and O += P V run as mma.sync m16n8k16 with f32
//     accumulation; Q and K fragments come by ldmatrix, V by ldmatrix.trans,
//     and the S accumulator's fragment, rounded to bf16, is the A fragment
//     of P V in registers;
//   - f32: 3xTF32 mma.sync m16n8k8: a = a_hi + a_lo with both parts in TF32
//     and a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, within ~1e-6 relative of
//     f32 FMAs (one TF32 product alone is ~1e-3). The S accumulator holds
//     keys (2t, 2t+1) of each 8-key group where the m16n8k8 A fragment
//     wants (t, t + 4), so P V reads its keys in that order: key 2t of the
//     group is column t and key 2t + 1 column t + 4 of the A fragment, and
//     the V rows of the B fragment follow the same order;
//   - the head dim is a template value in {16, 32, 64, 128, 256}; a runtime
//     hd up to it (hd % 8 == 0) reads zeros in the columns past hd;
//   - each CTA walks key tiles up to its causal frontier and skips the
//     trailing tiles with no valid key; the longest (last) query blocks
//     launch first.
//
// Semantics: out[b, s, h] = softmax_c(q.k_c / sqrt(hd)) @ v over keys
// c <= s with valid[b, c]; masked scores are -1e30 and the sum is floored
// at 1e-30, so a row that sees no valid key stays finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per CTA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where ``ok`` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D[16 x 8] += A[16 x 8] B[8 x 8], TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both TF32 (round to nearest); x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// a*b in 3xTF32: the two cross terms first, the large term last
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

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

// Tile shape and shared memory: Q [kRows][LD], K [2][TKM][LD], V [2][TKM][LD]
// (a pitch of HD + 8 bf16 or HD + 4 f32 puts the rows a fragment reads on
// distinct banks), then one validity bit per walked key.
template <typename T, int HD>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int TKM = HD == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = F32 ? HD + 4 : HD + 8;
  static constexpr int EPC = 16 / (int)sizeof(T);           // elements per 16-byte chunk
  static constexpr int CPR = HD / EPC;                      // chunks per row
  static size_t bytes(int S) {
    return (size_t)(kRows + 4 * TKM) * LD * sizeof(T) + (size_t)((S + TKM - 1) / TKM) * (TKM / 32) * 4;
  }
};

// S[16 x TKM] = Q K^T of one warp's rows (Qw) and one key tile (kt)
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[Cfg<T, HD>::TKM / 8][4], const T* Qw,
                                       const T* kt, int lane) {
  using C = Cfg<T, HD>;
  constexpr int NB = C::TKM / 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
  if constexpr (C::F32) {
    const int g = lane / 4, tg = lane % 4;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(Qw[g * C::LD + kk * 8 + tg], ah[0], al[0]);
      split_tf32(Qw[(g + 8) * C::LD + kk * 8 + tg], ah[1], al[1]);
      split_tf32(Qw[g * C::LD + kk * 8 + tg + 4], ah[2], al[2]);
      split_tf32(Qw[(g + 8) * C::LD + kk * 8 + tg + 4], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kt[(nb * 8 + g) * C::LD + kk * 8 + tg], bh0, bl0);
        split_tf32(kt[(nb * 8 + g) * C::LD + kk * 8 + tg + 4], bh1, bl1);
        mma_3xtf32(s[nb], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(Qw + (lane % 8 + ((lane / 8) % 2) * 8) * C::LD + kk * 16 +
                              (lane / 16) * 8));
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(kt + (nb * 8 + lane % 8 + (lane / 16) * 8) * C::LD + kk * 16 +
                                 ((lane / 8) % 2) * 8));
        mma_bf16(s[nb], a, bf[0], bf[1]);
        mma_bf16(s[nb + 1], a, bf[2], bf[3]);
      }
    }
  }
}

// O[16 x HD] += P V of one warp's rows: P (the probabilities in s) and one
// V tile (vt)
template <typename T, int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&s)[Cfg<T, HD>::TKM / 8][4],
                                   const T* vt, int lane) {
  using C = Cfg<T, HD>;
  if constexpr (C::F32) {
    const int g = lane / 4, tg = lane % 4;
#pragma unroll
    for (int kk = 0; kk < C::TKM / 8; ++kk) {
      // A column tg is key 2tg of the group, column tg + 4 key 2tg + 1
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
      const T* v0 = vt + (kk * 8 + 2 * tg) * C::LD + g;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[nb * 8], bh0, bl0);
        split_tf32(v0[C::LD + nb * 8], bh1, bl1);
        mma_3xtf32(o[nb], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < C::TKM / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nb = 0; nb < HD / 8; nb += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * C::LD +
                                       nb * 8 + (lane / 16) * 8));
        mma_bf16(o[nb], a, bf[0], bf[1]);
        mma_bf16(o[nb + 1], a, bf[2], bf[3]);
      }
    }
  }
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
    for (int i = tid; i < kRows * C::CPR; i += 32 * kWarps) {
      const int r = i / C::CPR, col = (i % C::CPR) * C::EPC;
      const int gr = r0 + r;
      const bool ok = gr < R && col < hd;
      const int s = gr / G, g = gr - s * G;
      const long long off = ok ? (((long long)b * S + s) * H + (long long)kvh * G + g) * hd + col : 0;
      cp_async16(smem_u32(Qs + r * C::LD + col), p.q + off, ok);
    }
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
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {  // the four threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mn0);
      s[nb][1] = exp2f(s[nb][1] - mn0);
      s[nb][2] = exp2f(s[nb][2] - mn1);
      s[nb][3] = exp2f(s[nb][3] - mn1);
      sum0 += s[nb][0] + s[nb][1];
      sum1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * corr0 + sum0;  // this thread's columns; the row sums at the end
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      o[nb][0] *= corr0;
      o[nb][1] *= corr0;
      o[nb][2] *= corr1;
      o[nb][3] *= corr1;
    }
    pv<T, HD>(o, s, vt, lane);
    __syncthreads();  // the next load overwrites this tile's buffer
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = r0 + wr + g + 8 * half;
    if (gr >= R) continue;
    const int s = gr / G, gh = gr - s * G;
    T* dst = p.out + (((long long)b * S + s) * H + (long long)kvh * G + gh) * hd;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const int col = nb * 8 + 2 * tg;
      if (col < hd) store2(dst + col, o[nb][2 * half] * inv[half], o[nb][2 * half + 1] * inv[half]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
           int S, int KV, int G, int hd, cudaStream_t stream) {
  const size_t smem = Cfg<T, HD>::bytes(S);
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
