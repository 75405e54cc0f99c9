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
// last refills it (one thread issues the copy; no producer warp).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int BM = 128;             // query rows per CTA: two warpgroups of 64
constexpr int TK = 64;              // keys per K/V tile
constexpr int STAGES = 4;           // K/V ring depth
constexpr int NT = 256;             // two warpgroups
constexpr int SLAB = TK * 128;      // one 64-column slab of a K or V tile, bytes
constexpr float kNegInf = -1e30f;
// a warpgroup waits for tile t + 1 before it releases tile t - 1
static_assert(STAGES >= 3, "the one-tile lookahead needs three stages");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map into shared memory; completion counts bytes on
// ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared memory written through the generic proxy, read next by wgmma or
// TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving an accumulator's reads and writes across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs), B
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs), B
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128_tb(float* d, const uint32_t* a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t desc_v) {
  if constexpr (HD == 128) wgmma_rs_n128_tb(o, a, desc_v);
  else wgmma_rs_n64_tb(o, a, desc_v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// cuTensorMapEncodeTiled from the driver, found at run time so the library
// needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
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
