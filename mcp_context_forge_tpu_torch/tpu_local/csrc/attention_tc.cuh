// Hopper tensor-core attention machinery shared by the flash prefill kernel
// (flash_attention_tc.cu) and the paged chunk kernel
// (paged_chunk_attention_tc.cu): bf16 operands, head dims 64 and 128.
//
// One CTA owns BM = 128 query rows r = s*G + g of one (batch row, KV head)
// in two consumer warpgroups of 64 rows. Q sits in shared memory in the
// 128-byte-swizzled layout wgmma reads; K/V tiles of TK = 64 keys arrive
// by TMA (4-D tensor maps whose two outer coordinates name the tile: a key
// offset and a batch row for contiguous K/V, a page offset and a page for
// a paged pool) into a STAGES-deep mbarrier ring. S = Q K^T and O += P V
// run as wgmma m64nNk16 (bf16 in, f32 accumulate); P is rounded to bf16 in
// registers and fed as the register A operand of P V, and V is read as an
// MN-major B operand. The online softmax (running max and sum per row,
// base-2 exponentials, masked scores -1e30, the sum floored at 1e-30) is
// the Pallas kernels'. A row attends key c iff c <= its position (and,
// for flash, key c is valid).
//
// key_walk is the bf16 key loop: each warpgroup issues the next tile's
// S = Q K^T before it runs this tile's softmax, so the tensor cores work
// while the exponentials do, and the warpgroup that releases a ring stage
// last refills it (one thread issues the copy; no producer warp). The
// generic Hopper pieces (mbarriers, TMA, wgmma descriptors and
// instructions) are in hopper_tc.cuh, shared with grouped_moe_tc.cu.
#pragma once

#include "hopper_tc.cuh"

namespace tc {

constexpr int BM = 128;             // query rows per CTA: two warpgroups of 64
constexpr int TK = 64;              // keys per K/V tile
constexpr int STAGES = 4;           // K/V ring depth
constexpr int NT = 256;             // two warpgroups
constexpr int SLAB = TK * 128;      // one 64-column slab of a K or V tile, bytes
constexpr float kNegInf = -1e30f;
// a warpgroup waits for tile t + 1 before it releases tile t - 1
static_assert(STAGES >= 3, "the one-tile lookahead needs three stages");

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t desc_v) {
  if constexpr (HD == 128) wgmma_rs_n128_tb(o, a, desc_v);
  else wgmma_rs_n64_tb(o, a, desc_v);
}

// Sizes of the shared operands: Q [HD/64 slabs][BM rows][64] bf16, and one
// ring stage {K, V} [HD/64 slabs][TK keys][64] bf16, all 128-byte swizzled.
template <int HD>
struct Tiles {
  static constexpr int kSlabs = HD / 64;
  static constexpr int kQ = kSlabs * BM * 128;
  static constexpr int kTile = kSlabs * SLAB;   // K or V of one stage
  static constexpr int kStage = 2 * kTile;
};

// Where a tile's K/V come from and go to. Tile t's keys are rows
// t*TK .. t*TK + TK - 1 of batch row ``b`` (contiguous K/V, ``pages`` null),
// or rows (t*TK) % page_size onward of page pages[t*TK / page_size] (a
// paged pool; page_size is a multiple of TK).
struct Ring {
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  uint32_t tiles, bar_full;
  uint32_t* released;  // [STAGES]: warpgroups done with the stage's tile
  int kvh, b;
  const int* pages;    // shared memory: the walked pages, or nullptr
  int page_size;

  __device__ __forceinline__ void coords(int t, int& row, int& outer) const {
    if (pages == nullptr) {
      row = t * TK;
      outer = b;
    } else {
      row = (t * TK) % page_size;
      outer = pages[(t * TK) / page_size];
    }
  }
};

// K and V of tile t into its stage: one thread issues the TMA boxes, the
// stage's barrier counts their bytes.
template <int HD>
__device__ __forceinline__ void load_tile(const Ring& ring, int t) {
  using L = Tiles<HD>;
  const int st = t % STAGES;
  int row, outer;
  ring.coords(t, row, outer);
  const uint32_t bar = ring.bar_full + 8 * st;
  mbar_expect_tx(bar, L::kStage);
  const uint32_t k_dst = ring.tiles + st * L::kStage;
#pragma unroll
  for (int sl = 0; sl < L::kSlabs; ++sl) {
    tma_load_4d(k_dst + sl * SLAB, ring.tm_k, bar, sl * 64, ring.kvh, row, outer);
    tma_load_4d(k_dst + L::kTile + sl * SLAB, ring.tm_v, bar, sl * 64, ring.kvh, row, outer);
  }
}

// Q rows r0 .. r0 + BM - 1 (r = s*G + g of KV head kvh; q is
// [B, S, KV*G, HD] bf16) into the swizzled layout at ``smem``: 16-byte
// chunk c of row r lands at chunk (c % 8) ^ (r % 8) of the row's 128 bytes
// in slab c / 8. Rows past R = S*G are zeros.
template <int HD>
__device__ __forceinline__ void load_q(unsigned char* smem, const __nv_bfloat16* q, int b, int S,
                                       int H, int G, int kvh, int r0) {
  constexpr int CH = HD / 8;
  const int R = S * G;
  for (int i = threadIdx.x; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int gr = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < R) {
      const int s = gr / G, g = gr - s * G;
      v = *reinterpret_cast<const uint4*>(
          q + (((long long)b * S + s) * H + (long long)kvh * G + g) * HD + c * 8);
    }
    *reinterpret_cast<uint4*>(smem + (c / 8) * BM * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4)) = v;
  }
}

// One consumer thread's two rows: running max and sum (base-2 units),
// positions, and its first accumulator column.
struct RowState {
  float m0, m1, l0, l1;
  int pos0, pos1, col;
  int pos_first;  // the least position of the block's rows: keys up to it need no causal mask
};

// S = Q K^T of one tile over hd in steps of 16 (32 bytes inside a 128-byte
// swizzle row), issued and committed, not waited for.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[TK / 2], uint32_t q_base,
                                             uint32_t k_tile) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(q_base + (kk / 4) * BM * 128 + off, 16, 1024),
                 sw128_desc(k_tile + (kk / 4) * SLAB + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Scores of tile t to base-2 units with the mask applied (key validity bits
// where VBITS, and causality by the rows' positions; an interior tile, every
// key valid and none past the block's least position, needs no mask);
// returns this thread's two row maxima over the tile, reduced over the four
// threads of each row.
template <bool VBITS>
__device__ __forceinline__ void mask_scores(float (&cur)[TK / 2], const RowState& st, int t,
                                            const uint32_t* vbits, float scale_log2, float& mx0,
                                            float& mx1) {
  const int c0 = t * TK;
  const uint32_t w_lo = VBITS ? vbits[t * 2] : 0xffffffffu;
  const uint32_t w_hi = VBITS ? vbits[t * 2 + 1] : 0xffffffffu;
  mx0 = kNegInf;
  mx1 = kNegInf;
  if ((w_lo & w_hi) == 0xffffffffu && c0 + TK - 1 <= st.pos_first) {
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      cur[i] *= scale_log2;
      if (i % 4 < 2) mx0 = fmaxf(mx0, cur[i]);
      else mx1 = fmaxf(mx1, cur[i]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + st.col + (e & 1);
        const bool bit = !VBITS || (((j < 4 ? w_lo : w_hi) >> (kl & 31)) & 1u);
        const bool ok = bit && c0 + kl <= (e < 2 ? st.pos0 : st.pos1);
        const float x = ok ? cur[j * 4 + e] * scale_log2 : kNegInf;
        cur[j * 4 + e] = x;
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
}

// Online softmax of one masked tile: updates the running max and sum and
// returns the correction factors of O; P (times ``p_scale``, the int8
// pages' V scale, 1 otherwise) goes to ``pa`` in bf16, the register A
// fragments of m64nNk16. The sum takes the unscaled P.
__device__ __forceinline__ void softmax_tile(const float (&cur)[TK / 2], RowState& st, float mx0,
                                             float mx1, float p_scale, uint32_t (&pa)[TK / 16][4],
                                             float& corr0, float& corr1) {
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  corr0 = exp2f(st.m0 - mn0);
  corr1 = exp2f(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
    const float p0 = exp2f(cur[j * 4 + 0] - mn0), p1 = exp2f(cur[j * 4 + 1] - mn0);
    const float p2 = exp2f(cur[j * 4 + 2] - mn1), p3 = exp2f(cur[j * 4 + 3] - mn1);
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    pa[j / 2][(j % 2) * 2] = pack_bf16(p0 * p_scale, p1 * p_scale);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2 * p_scale, p3 * p_scale);
  }
  st.l0 = st.l0 * corr0 + sum0;  // this thread's columns; the row sums at the end
  st.l1 = st.l1 * corr1 + sum1;
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], float corr0, float corr1) {
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j * 4 + 0] *= corr0;
    o[j * 4 + 1] *= corr0;
    o[j * 4 + 2] *= corr1;
    o[j * 4 + 3] *= corr1;
  }
}

// O += P V, issued and committed: V tile rows are keys, 64-column slabs
// LBO = one slab apart, 8-key groups SBO = 1024 bytes apart.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[TK / 16][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_pv<HD>(o, pa[kk], sw128_desc(v_tile + kk * 16 * 128, SLAB, 1024));
  wgmma_commit();
}

// Tile t: its scores ``cur`` (issued one tile earlier) become probabilities
// and O += P V is issued; the next tile's scores go into ``nxt`` first.
// Commit order per tile: S(t+1), then PV(t), so at the top of tile t the
// pending groups are S(t) and PV(t-1). FIRST (t = 0) and LAST (t = n - 1)
// are compile-time, so every wait names a fixed count of pending groups.
template <int HD, bool VBITS, bool FIRST, bool LAST>
__device__ __forceinline__ void consume_tile(float (&cur)[TK / 2], float (&nxt)[TK / 2],
                                             float (&o)[HD / 2], RowState& st, int t,
                                             int n_tiles, uint32_t q_base, const Ring& ring,
                                             const uint32_t* vbits, float scale_log2) {
  using L = Tiles<HD>;
  if (FIRST) wgmma_wait<0>();
  else wgmma_wait<1>();  // S(t) is done; PV(t-1) may still run
  fence_regs(cur);
  if (!LAST) {
    const int nx = (t + 1) % STAGES;
    mbar_wait(ring.bar_full + 8 * nx, ((t + 1) / STAGES) & 1);
    issue_scores<HD>(nxt, q_base, ring.tiles + nx * L::kStage);
  }
  float mx0, mx1, corr0, corr1;
  mask_scores<VBITS>(cur, st, t, vbits, scale_log2, mx0, mx1);
  uint32_t pa[TK / 16][4];
  softmax_tile(cur, st, mx0, mx1, 1.f, pa, corr0, corr1);

  // PV(t-1) must be done before O is rescaled; its stage is then free, and
  // the second warpgroup to be done with it loads tile t - 1 + STAGES there
  if (!FIRST) {
    if (LAST) wgmma_wait<0>();
    else wgmma_wait<1>();
    const int refill = t - 1 + STAGES;
    if (threadIdx.x % 128 == 0 && refill < n_tiles) {
      uint32_t* count = ring.released + (t - 1) % STAGES;
      if (atomicAdd(count, 1u) == 1u) {
        *count = 0u;
        load_tile<HD>(ring, refill);
      }
    }
  }
  rescale<HD>(o, corr0, corr1);
  issue_pv<HD>(o, pa, ring.tiles + (t % STAGES) * L::kStage + L::kTile);
}

// The bf16 key walk of one warpgroup over tiles 0 .. n_tiles - 1, whose
// first min(n_tiles, STAGES) loads are already issued. S of tile t is
// issued one tile ahead, so the tensor cores compute it while this
// warpgroup runs the softmax of the tile before; even tiles score into sa,
// odd ones into sb. Leaves every wgmma of the walk complete.
template <int HD, bool VBITS>
__device__ __forceinline__ void key_walk(float (&o)[HD / 2], RowState& st, int n_tiles,
                                         uint32_t q_base, const Ring& ring,
                                         const uint32_t* vbits, float scale_log2) {
  float sa[TK / 2], sb[TK / 2];
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) sa[i] = sb[i] = 0.f;
  if (n_tiles > 0) {
    mbar_wait(ring.bar_full, 0);
    issue_scores<HD>(sa, q_base, ring.tiles);
  }
  if (n_tiles == 1) {
    consume_tile<HD, VBITS, true, true>(sa, sb, o, st, 0, n_tiles, q_base, ring, vbits,
                                        scale_log2);
  } else if (n_tiles > 1) {
    consume_tile<HD, VBITS, true, false>(sa, sb, o, st, 0, n_tiles, q_base, ring, vbits,
                                         scale_log2);
    int t = 1;
    for (; t + 2 < n_tiles; t += 2) {
      consume_tile<HD, VBITS, false, false>(sb, sa, o, st, t, n_tiles, q_base, ring, vbits,
                                            scale_log2);
      consume_tile<HD, VBITS, false, false>(sa, sb, o, st, t + 1, n_tiles, q_base, ring, vbits,
                                            scale_log2);
    }
    if (t + 1 < n_tiles) {
      consume_tile<HD, VBITS, false, false>(sb, sa, o, st, t, n_tiles, q_base, ring, vbits,
                                            scale_log2);
      consume_tile<HD, VBITS, false, true>(sa, sb, o, st, t + 1, n_tiles, q_base, ring, vbits,
                                           scale_log2);
    } else {
      consume_tile<HD, VBITS, false, true>(sb, sa, o, st, t, n_tiles, q_base, ring, vbits,
                                           scale_log2);
    }
  }
  wgmma_wait<0>();
  fence_regs(o);
}

// O / l of this thread's two rows (lr, lr + 8 of the block) into ``out``
// ([B, S, KV*G, HD] bf16); rows past R = S*G are not written.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 2], const RowState& st,
                                           __nv_bfloat16* out, int b, int S, int H, int G,
                                           int kvh, int r0, int lr) {
  const int R = S * G;
  float l0 = st.l0, l1 = st.l1;
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {  // the four threads of a row
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = r0 + lr + 8 * half;
    if (gr >= R) continue;
    const int s = gr / G, g = gr - s * G;
    __nv_bfloat16* dst =
        out + (((long long)b * S + s) * H + (long long)kvh * G + g) * HD + st.col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          o[j * 4 + 2 * half] * inv[half], o[j * 4 + 2 * half + 1] * inv[half]);
  }
}
// A 4-D [d3, d2, KV, hd] tensor (innermost last here, first in the map)
// with boxes of ``box0`` hd elements x 1 head x TK rows x 1: bf16 boxes of
// 64 columns under the 128-byte swizzle (wgmma operands), or unswizzled
// int8 boxes of the whole head (staged, then widened). Rows past d2 read 0.
inline bool map_4d(CUtensorMap* map, const void* ptr, bool int8, int d3, int d2, int KV, int hd,
                   int box0) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int es = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * es, (cuuint64_t)KV * hd * es,
                                 (cuuint64_t)d2 * KV * hd * es};
  const cuuint32_t box[4] = {(cuuint32_t)box0, 1, TK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc