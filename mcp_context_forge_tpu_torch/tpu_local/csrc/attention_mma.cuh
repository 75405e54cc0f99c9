// Warp-level tensor-core attention machinery (mma.sync, sm_90a) shared by
// the flash prefill kernel (flash_attention_mma.cu) and the paged chunk
// kernel (paged_chunk_attention_mma.cu): f32 at any head dim, bf16 at the
// head dims the wgmma kernels do not take.
//
// Each warp owns 16 query rows r = s*G + g of one (batch row, KV head),
// four warps to a CTA (64 rows); K/V tiles of TKM keys (64; 32 at hd 256)
// sit in shared memory and serve all G heads of the KV group and every warp
// of the CTA.
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
//     hd up to it (hd % 8 == 0) reads zeros in the columns past hd.
// A thread holds rows g and g + 8 of its warp's 16 (g = lane / 4) and the
// accumulator columns nb*8 + 2*tg + {0, 1} (tg = lane % 4). The online
// softmax (running max and sum per row, base-2 exponentials, masked scores
// -1e30, the sum floored at 1e-30) is the Pallas kernels'.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mma {

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


// Tile shape: Q [kRows][LD] and K, V tiles [TKM][LD] in shared memory (a
// pitch of HD + 8 bf16 or HD + 4 f32 puts the rows a fragment reads on
// distinct banks).
template <typename T, int HD>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int TKM = HD == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = F32 ? HD + 4 : HD + 8;
  static constexpr int EPC = 16 / (int)sizeof(T);           // elements per 16-byte chunk
  static constexpr int CPR = HD / EPC;                      // chunks per row
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


// Q rows r0 .. r0 + kRows - 1 (r = s*G + g of KV head kvh; q is
// [B, S, KV*G, hd]) into Qs by cp.async, not committed; rows past R = S*G
// and columns past hd are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_q(T* Qs, const T* q, int b, int S, int H, int G, int kvh,
                                       int r0, int hd) {
  using C = Cfg<T, HD>;
  const int R = S * G;
  for (int i = threadIdx.x; i < kRows * C::CPR; i += 32 * kWarps) {
    const int r = i / C::CPR, col = (i % C::CPR) * C::EPC;
    const int gr = r0 + r;
    const bool ok = gr < R && col < hd;
    const int s = gr / G, g = gr - s * G;
    const long long off = ok ? (((long long)b * S + s) * H + (long long)kvh * G + g) * hd + col : 0;
    cp_async16(smem_u32(Qs + r * C::LD + col), q + off, ok);
  }
}

// One tile's online-softmax step for a thread's two rows: ``s`` holds the
// masked scores in base-2 units and mx0/mx1 this thread's maxima of them;
// the maxima are reduced over the four threads of each row, the running
// max m and sum l are updated, O is rescaled, and ``s`` becomes the
// probabilities (the sum takes them as they are).
template <int NB, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4], float (&o)[NO][4], float mx0,
                                               float mx1, float& m0, float& m1, float& l0,
                                               float& l1) {
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
  for (int nb = 0; nb < NO; ++nb) {
    o[nb][0] *= corr0;
    o[nb][1] *= corr0;
    o[nb][2] *= corr1;
    o[nb][3] *= corr1;
  }
}

// O / l of this thread's rows gr and gr + 8 (r = s*G + g) into ``out``
// ([B, S, KV*G, hd]); rows past R = S*G and columns past hd are not written.
template <typename T, int HD>
__device__ __forceinline__ void store_out(const float (&o)[HD / 8][4], float l0, float l1, T* out,
                                          int b, int S, int H, int G, int kvh, int gr, int hd,
                                          int tg) {
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  const int R = S * G;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gr + 8 * half;
    if (r >= R) continue;
    const int s = r / G, gh = r - s * G;
    T* dst = out + (((long long)b * S + s) * H + (long long)kvh * G + gh) * hd;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const int col = nb * 8 + 2 * tg;
      if (col < hd) store2(dst + col, o[nb][2 * half] * inv[half], o[nb][2 * half + 1] * inv[half]);
    }
  }
}

}  // namespace mma
