// The 64-row (prefill) W4A8 tile body for Hopper (sm_90a): FP4 weights
// requantized to int8 in the kernel, int8 activations, int8 wgmma with s32
// sums:
//     B8[k, n] = rne(bf16(decode(W)[k, n] * R[k / 16, n]))      (|B8| <= 127)
//     C[m, n]  = bf16(((f32(sum_k A8[m, k] * B8[k, n]) * arow[m]) * acol[n]) * gs)
// for the (64, BN) output tiles of one CTA, on the operands of
// fp4_gemm_w4a8.cu (W (kp/8, n) words of fp4_gemm.cuh's layout, R (kp/16,
// n) bf16 requantization constants, A8 (m, k) int8 in natural k order,
// arow (m,) and acol (n,) f32, gs). pk_fp4_gemm_w4a8's 64-row tiles run
// it at G = 1 and pk_fp4_gemm_w4a8_wc's at G > 1 (G m-tiles a CTA). It
// replaces, at prefill block sizes, the TPU kernels
// petit_kernel_tpu/ops/kernels/fused.py:482 _fused_kernel_w4a8 and :526
// _fused_kernel_w4a8_wc (reached through fused_mul_w4a8, their
// pallas_call at :695).
//
// What bounds it: the int8 tensor cores. The four Llama-3-8B projections
// at m = 2048 are 8.93e11 integer operations, 0.451 ms at 1,979 TOP/s;
// their bytes (A8, the packed words, R, C) take a fifth of that. A 64-row
// tile requantizes every weight once per 64 rows, about 7e9 values there,
// so the requantization has to be cheap and run under the MMAs, and the
// MMAs have to reach the rate only wgmma gives. What the design does:
//   - one warpgroup per 64-row m-tile: wgmma.mma_async m64nBNk32 s8 with
//     s32 accumulators in registers, A and B both read from shared memory
//     through descriptors, both K-major (the only form s8 operands take)
//     with the 128-byte swizzle. A k32 chunk is 32 bytes, a bf16 k16
//     chunk's size, so sw128_desc and its + 2q advance serve as they are;
//   - fp4_wgmma.cuh's steps: step s reads the 32 word rows of half g = s & 1
//     of block c = s >> 1 (wg_load_ws: the same stage of words and 16
//     scale rows, here R rows), which hold 64 contiguous natural k of every
//     quarter j, from j*(kp/4) + 128c + 64g. An int8 swizzle row holds 128
//     k, so a unit is two quarters: unit v of the step takes quarters 2v
//     and 2v + 1, row bytes 0-63 the first's 64 k and 64-127 the second's.
//     A unit's A is then two runs of 64 contiguous bytes a row, plain
//     16-byte cp.async copies (zero past M and K) that use every byte of
//     each sector they touch, chunk a of row r stored at a ^ (r & 7). The
//     integer sums are exact, so the order of k does not matter;
//   - B is requantized two values per 32-bit operation: quarter-local
//     chunk A (16 k) of column n is the slot of quarter J in half A & 1 of
//     stage rows 2x + (A >> 1), x < 16, under stage R row 4J + A.
//     decode_pair<J> (fp4_stream.cuh) and mul.rn.bf16x2 by the R pair give
//     bf16(decode * R), the product of a 2-bit and an 8-bit significand
//     rounded once, as the TPU kernel's bf16 multiply does. The round to
//     int8 is a magic-constant add, as the TPU kernel's (_round_i8_bf16)
//     is, but in f32 and signed: b + 1.5 * 2^23 rounds b to an integer and
//     leaves its two's complement in the low byte, so three prmt gather
//     four values a word with no sign handling (|b| <= 127 by the
//     construction of R; out of that range the byte wraps, as the mma.sync
//     body's & 0xFF does). It measured 1.4% faster than the TPU kernel's
//     bf16 form, |b| + 128 and a bytewise negation (PERF.md, section 6).
//     16-byte stores put chunk 4(J - 2v) + A of B row n at that ^ (n & 7). A thread owns row parity p of CW columns: it keeps
//     its 16 words a column of the step in registers as half pairs and
//     writes chunks 2p and 2p + 1 of both quarters of each unit;
//   - a ring: three B slots, three A slots loaded one unit ahead, and two
//     stages of words and R, loaded one step ahead. Unit u requantizes into
//     B slot u % 3 while unit u - 1's wgmmas run (committed, waited for
//     only down to one group in flight). Two units a step leave the words
//     one unit of lead over the A lookahead, so the lookahead is one unit;
//   - the epilogue keeps the TPU kernel's order: __fmul_rn of
//     __int2float_rn(acc) by arow, by acol, by gs, then bf16;
//   - the launcher (fp4_gemm_w4a8.cu) puts the m-tiles first in the grid,
//     so the CTAs in flight share their n-tiles' weights and stream them
//     from device memory once, not once per m-tile (1.5% faster).
//   - the weight cache (G > 1): one CTA runs G m-tiles of one n-tile, a
//     warpgroup each, on one A slot of G*64 rows (each warpgroup's
//     descriptor at its own 64 rows) and one requantized B slot that all
//     G read, so each weight is requantized once per G*64 rows. All 128G
//     threads share a unit's requantization (W8Share: a (column, chunk)
//     a thread, one half of w8_quarter's pair), so none waits idle at the
//     unit's barrier. G = 1 keeps its own cut (W8Decode).
// Shared memory: 3 A slots of G * 8 KB, 3 B slots of BN * 128 bytes, 2
// stages of BN * 160 bytes, 1 KB of alignment: at G = 1 115,712 bytes at
// BN = 128 (two blocks an SM), 70,656 at BN = 64 (three), the bf16 body's
// own plan; at G = 4 (the weight cache) 189,440 and 144,384 (one
// block an SM each; static_asserts below). ptxas (sm_90a, CUDA 12.9): at
// G = 1 176 registers at BN = 128, 117 at 64, no spill; at G = 4 128 (its
// cap, a 16-byte spill) and 107; no C7515. On the card the
// requantization's arithmetic sets the plain tile's time: without the
// wgmmas a launch takes as long, without that arithmetic about half as
// long. At G = 4 removing either leaves about 1.3 of 1.7 ms, and removing
// both and the A copies 0.86: the copies' latency, which each unit waits
// out (cp_async_wait<0>), and the barriers (PERF.md, section 6).
//
// Visibility: wgmma reads shared memory through the async proxy, and both
// the requantization's stores and the cp.async copies are generic-proxy
// writes, so each unit runs fence.proxy.async after them and before the
// barrier that precedes its wgmmas.

#pragma once

#include "fp4_wgmma.cuh"

namespace {

constexpr int W8_A_SLOTS = 3;   // A slots: one unit of lookahead

// shared-memory plan of w4a8_wgmma_tile<BN, G>; every slot a multiple of
// 1024 bytes (the swizzle atom), the words and R last
template <int BN, int G>
struct W8Plan {
  static constexpr int threads = THREADS * G;
  static constexpr int a_slot = G * WG_BM * WG_ROW;   // 64 rows x 128 int8 k
  static constexpr int b_slot = BN * WG_ROW;          // BN rows x 128 int8 k
  static constexpr int ws_stage = WROWS * BN * 4 + WROWS / 2 * BN * 2;   // words, R
  static constexpr int bytes =
      W8_A_SLOTS * a_slot + WG_B_SLOTS * b_slot + 2 * ws_stage + 1024;
  static constexpr int blocks = wg_blocks(bytes);
  static_assert(blocks >= 1 && bytes <= WG_SMEM_LIMIT, "shared memory");
};
static_assert(W8Plan<128, 1>::bytes == 115712 && W8Plan<128, 1>::blocks == 2 &&
                  W8Plan<64, 1>::bytes == 70656 && W8Plan<64, 1>::blocks == 3,
              "the plain tiles' plan: two blocks an SM at BN = 128, three at 64");
static_assert(W8Plan<128, 4>::bytes == 189440 && W8Plan<128, 4>::blocks == 1 &&
                  W8Plan<64, 4>::bytes == 144384 && W8Plan<64, 4>::blocks == 1,
              "the weight cache's tiles (G = 4): one block an SM");

template <int BN, int G>
__host__ __device__ constexpr int w4a8_wgmma_threads() { return W8Plan<BN, G>::threads; }

template <int BN, int G>
__host__ __device__ constexpr int w4a8_wgmma_smem_bytes() { return W8Plan<BN, G>::bytes; }

// ---- loads -----------------------------------------------------------------

// cp.async A8 of unit u (step u >> 1, quarters 2v and 2v + 1, v = u & 1)
// for the G*64 rows from m0 into `slot`: chunk a (16 k) of row r is k
// j*(kp/4) + 128c + 64g + 16(a & 3) of quarter j = 2v + (a >> 2), stored at
// chunk a ^ (r & 7)
template <int G>
__device__ __forceinline__ void w8_load_a(unsigned char* slot, const int8_t* __restrict__ A,
                                          int M, int K, int KP, int m0, int u) {
  constexpr int NTH = THREADS * G;
  const int step = u >> 1, v = u & 1;
  const int k0 = 2 * v * (KP / 4) + (step >> 1) * 128 + (step & 1) * 64;
#pragma unroll
  for (int i = 0; i < G * WG_BM * 8 / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, r = e >> 3, a = e & 7;
    const int kn = k0 + (a >> 2) * (KP / 4) + (a & 3) * 16;
    const bool ok = m0 + r < M && kn < K;
    cp_async16(slot + r * WG_ROW + ((a ^ (r & 7)) << 4),
               ok ? A + (size_t)(m0 + r) * K + kn : A, ok);
  }
}

// ---- requantization --------------------------------------------------------

// How the requantization is cut: a task is (CW columns STRIDE apart, row
// parity p < 2); thread t runs column c0 = t % STRIDE, p = t / STRIDE.
template <int BN, int G>
struct W8Decode {
  static constexpr int NTH = THREADS * G;
  static constexpr int CW = BN * 2 >= NTH ? BN * 2 / NTH : 1;
  static constexpr int STRIDE = BN / CW;
  static constexpr int TASKS = BN * 2 / CW;
};

// The thread's words of one step as the half pairs decode_pair takes:
// lo[i][y] holds the half-0 slots of stage rows 4y + p and 4y + 2 + p (x =
// 2y and 2y + 1) of column i, hi[i][y] their half-1 slots
template <int BN, int G>
__device__ __forceinline__ void w8_words(const uint32_t* Ws,
                                         uint32_t (&lo)[W8Decode<BN, G>::CW][8],
                                         uint32_t (&hi)[W8Decode<BN, G>::CW][8]) {
  using D = W8Decode<BN, G>;
  const int c0 = threadIdx.x % D::STRIDE, p = threadIdx.x / D::STRIDE;
  if (D::TASKS < D::NTH && threadIdx.x >= D::TASKS) return;
#pragma unroll
  for (int i = 0; i < D::CW; ++i) {
    const uint32_t* col = Ws + p * BN + c0 + i * D::STRIDE;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const uint32_t w0 = col[4 * y * BN], w1 = col[(4 * y + 2) * BN];
      lo[i][y] = prmt(w0, w1, 0x5410u);
      hi[i][y] = prmt(w0, w1, 0x7632u);
    }
  }
}

// Four bf16 values (b01: values 0 and 1, b23: 2 and 3) as the four int8
// rne(b), value i in byte i: b + 1.5 * 2^23 in f32 lands where the f32 ulp
// is 1, so the add rounds b to an integer, and the low byte of the sum is
// that integer's two's complement (|b| < 2^22)
__device__ __forceinline__ uint32_t requant4(uint32_t b01, uint32_t b23) {
  const float M = 12582912.0f;
  const uint32_t f0 = __float_as_uint(__fadd_rn(__uint_as_float(b01 << 16), M));
  const uint32_t f1 = __float_as_uint(__fadd_rn(__uint_as_float(b01 & 0xFFFF0000u), M));
  const uint32_t f2 = __float_as_uint(__fadd_rn(__uint_as_float(b23 << 16), M));
  const uint32_t f3 = __float_as_uint(__fadd_rn(__uint_as_float(b23 & 0xFFFF0000u), M));
  return prmt(prmt(f0, f1, 0x0040u), prmt(f2, f3, 0x0040u), 0x5410u);
}

// One 16-byte chunk of quarter J: the 16 values of the half pairs pr[y]
// (values 2y, 2y + 1), times the R pair rr, requantized
template <int J>
__device__ __forceinline__ uint4 w8_chunk(const uint32_t (&pr)[8], uint32_t rr) {
  uint32_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = requant4(mul_bf16x2(decode_pair<J>(pr[2 * q]), rr),
                    mul_bf16x2(decode_pair<J>(pr[2 * q + 1]), rr));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Quarter J's chunks 2p (half 0) and 2p + 1 (half 1) of B row n, at row
// chunks base + 2p and base + 2p + 1, under stage R rows 4J + 2p and 4J +
// 2p + 1
template <int J, int BN>
__device__ __forceinline__ void w8_quarter(unsigned char* row, int n, int p, int base,
                                           const unsigned short* r16, const uint32_t (&lo)[8],
                                           const uint32_t (&hi)[8]) {
  const uint32_t s0 = r16[(4 * J + 2 * p) * BN + n], s1 = r16[(4 * J + 2 * p + 1) * BN + n];
  const uint4 c0 = w8_chunk<J>(lo, s0 | (s0 << 16));
  const uint4 c1 = w8_chunk<J>(hi, s1 | (s1 << 16));
  *reinterpret_cast<uint4*>(row + (((base + 2 * p) ^ (n & 7)) << 4)) = c0;
  *reinterpret_cast<uint4*>(row + (((base + 2 * p + 1) ^ (n & 7)) << 4)) = c1;
}

// Unit V of the step (quarters 2V, 2V + 1) into the B slot `bq`
template <int V, int BN, int G>
__device__ __forceinline__ void w8_decode(unsigned char* bq, const __nv_bfloat16* Rs,
                                          const uint32_t (&lo)[W8Decode<BN, G>::CW][8],
                                          const uint32_t (&hi)[W8Decode<BN, G>::CW][8]) {
  using D = W8Decode<BN, G>;
  const int c0 = threadIdx.x % D::STRIDE, p = threadIdx.x / D::STRIDE;
  if (D::TASKS < D::NTH && threadIdx.x >= D::TASKS) return;
  const unsigned short* r16 = reinterpret_cast<const unsigned short*>(Rs);
#pragma unroll
  for (int i = 0; i < D::CW; ++i) {
    const int n = c0 + i * D::STRIDE;
    unsigned char* row = bq + n * WG_ROW;
    w8_quarter<2 * V, BN>(row, n, p, 0, r16, lo[i], hi[i]);
    w8_quarter<2 * V + 1, BN>(row, n, p, 4, r16, lo[i], hi[i]);
  }
}

// ---- requantization at G > 1 -----------------------------------------------

// How the requantization is cut at G > 1, so that all 128G threads share
// each unit's: a task is (column c, quarter-local chunk A < 4 and, where
// BN * 4 < 128G, quarter 2V + h of the unit, h < 2); thread t runs c = t %
// BN, A = (t / BN) % 4, h = t / (4 BN). Chunk A = 2p + e is half e of the
// stage rows of parity p, so the two threads of a (column, p) read the
// same words and each requantizes one half of w8_quarter's pair. A and h
// are the same across a warp.
template <int BN, int G>
struct W8Share {
  static constexpr int QS = THREADS * G / (BN * 4);   // threads a (column, chunk)
  static_assert((QS == 1 || QS == 2) && QS * BN * 4 == THREADS * G, "every thread one task");
};

// The thread's words of one step: pr[y] holds the half-e slots of stage
// rows 4y + p and 4y + 2 + p of its column (values 2y and 2y + 1 of chunk
// A)
template <int BN, int G>
__device__ __forceinline__ void w8_words(const uint32_t* Ws, uint32_t (&pr)[8]) {
  const int c = threadIdx.x % BN, a = (threadIdx.x / BN) & 3;
  const uint32_t sel = 0x5410u + (a & 1) * 0x2222u;   // e = 1: 0x7632
  const uint32_t* col = Ws + (a >> 1) * BN + c;
#pragma unroll
  for (int y = 0; y < 8; ++y) pr[y] = prmt(col[4 * y * BN], col[(4 * y + 2) * BN], sel);
}

// Chunk A of quarter J of B row n, at row chunk base + A, under stage R
// row 4J + A
template <int J, int BN>
__device__ __forceinline__ void w8_half(unsigned char* row, int n, int a, int base,
                                        const unsigned short* r16, const uint32_t (&pr)[8]) {
  const uint32_t s = r16[(4 * J + a) * BN + n];
  *reinterpret_cast<uint4*>(row + (((base + a) ^ (n & 7)) << 4)) = w8_chunk<J>(pr, s | (s << 16));
}

// Unit V of the step (quarters 2V, 2V + 1) into the B slot `bq`, the
// thread's share
template <int V, int BN, int G>
__device__ __forceinline__ void w8_decode(unsigned char* bq, const __nv_bfloat16* Rs,
                                          const uint32_t (&pr)[8]) {
  using S = W8Share<BN, G>;
  const int n = threadIdx.x % BN, a = (threadIdx.x / BN) & 3;
  const unsigned short* r16 = reinterpret_cast<const unsigned short*>(Rs);
  unsigned char* row = bq + n * WG_ROW;
  if (S::QS == 1 || threadIdx.x < 4 * BN) w8_half<2 * V, BN>(row, n, a, 0, r16, pr);
  if (S::QS == 1 || threadIdx.x >= 4 * BN) w8_half<2 * V + 1, BN>(row, n, a, 4, r16, pr);
}

// ---- the tile --------------------------------------------------------------

// Unit u = 2 * step + V: requantize into B slot u % 3 (the thread's words:
// lo, hi at G = 1, pr above), wait for A(u), then queue the copies of A(u +
// 1) (and, at V = 0, the words and R of step + 1) and run the unit's four
// wgmmas, each warpgroup on its own 64 A rows and the one B slot.
template <int V, int BN, int G, class... Words>
__device__ __forceinline__ void w8_unit(const WgRing& ring, const __nv_bfloat16* Rs,
                                        int (&acc)[BN / 2], const int8_t* __restrict__ A,
                                        const uint32_t* __restrict__ W,
                                        const __nv_bfloat16* __restrict__ R, int M, int N, int K,
                                        int KP, int m0, int n0, int step, const Words&... words) {
  using P = W8Plan<BN, G>;
  const int u = 2 * step + V, units = KP / KSTEP * 2;
  unsigned char* bq = ring.b + (u % WG_B_SLOTS) * P::b_slot;
  w8_decode<V, BN, G>(bq, Rs, words...);
  cp_async_wait<0>();   // A(u) and, at V = 1, the next step's words have landed
  fence_proxy_async();
  __syncthreads();      // B(u) complete; every warp is past wgmma(u - 2)
  if (u + 1 < units)
    w8_load_a<G>(ring.a + ((u + 1) % W8_A_SLOTS) * P::a_slot, A, M, K, KP, m0, u + 1);
  if (V == 0 && step + 1 < KP / KSTEP)
    wg_load_ws<BN, G>(ring.ws + ((step + 1) & 1) * P::ws_stage, W, R, N, KP, n0, step + 1);
  cp_async_commit();
  const int grp = threadIdx.x >> 7;   // this warpgroup's m-tile
  const uint64_t desc_a =
      sw128_desc(ring.a + (u % W8_A_SLOTS) * P::a_slot + grp * WG_BM * WG_ROW);
  const uint64_t desc_b = sw128_desc(bq);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q)   // 32-deep chunk q: 32 bytes further along the rows
    wgmma_s8(acc, desc_a + 2 * q, desc_b + 2 * q);
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// The G tiles (m0 + 64i, n0), i < G, of one matrix, by one CTA of
// w4a8_wgmma_threads<BN, G>() threads with w4a8_wgmma_smem_bytes<BN, G>()
// bytes of dynamic shared memory at `smem`; warpgroup i owns m-tile i.
template <int BN, int G = 1>
__device__ __forceinline__ void w4a8_wgmma_tile(
    unsigned char* smem, const int8_t* __restrict__ A, const float* __restrict__ arow,
    const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ R,
    const float* __restrict__ acol, const float* __restrict__ gs,
    __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP, int m0, int n0) {
  using P = W8Plan<BN, G>;
  using D = W8Decode<BN, G>;
  static_assert(BN == 64 || BN == 128, "BN");
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  WgRing ring;
  ring.a = smem + ((1024u - (base & 1023u)) & 1023u);
  ring.b = ring.a + W8_A_SLOTS * P::a_slot;
  ring.ws = ring.b + WG_B_SLOTS * P::b_slot;
  const int steps = KP / KSTEP;

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);

  // one group: step 0's words and R, A of unit 0
  wg_load_ws<BN, G>(ring.ws, W, R, N, KP, n0, 0);
  w8_load_a<G>(ring.a, A, M, K, KP, m0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(ring.ws + (step & 1) * P::ws_stage);
    const __nv_bfloat16* Rs = reinterpret_cast<const __nv_bfloat16*>(Ws + WROWS * BN);
    if constexpr (G == 1) {
      uint32_t lo[D::CW][8], hi[D::CW][8];
      w8_words<BN, G>(Ws, lo, hi);
      w8_unit<0, BN, G>(ring, Rs, acc, A, W, R, M, N, K, KP, m0, n0, step, lo, hi);
      w8_unit<1, BN, G>(ring, Rs, acc, A, W, R, M, N, K, KP, m0, n0, step, lo, hi);
    } else {
      uint32_t pr[8];
      w8_words<BN, G>(Ws, pr);
      w8_unit<0, BN, G>(ring, Rs, acc, A, W, R, M, N, K, KP, m0, n0, step, pr);
      w8_unit<1, BN, G>(ring, Rs, acc, A, W, R, M, N, K, KP, m0, n0, step, pr);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: bf16(((f32(acc) * arow) * acol) * gs), the TPU kernel's order
  // (fused.py:521-523). acc[4i + e] of warp w, lane l: row 16w + l/4 (+ 8
  // for e >= 2), column 8i + 2(l % 4) + (e & 1)
  const float s = *gs;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = m0 + (threadIdx.x >> 7) * WG_BM + 16 * w + (lane >> 2);
  const float ar0 = row < M ? arow[row] : 0.f, ar1 = row + 8 < M ? arow[row + 8] : 0.f;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    if (col >= N) continue;
    const float c0 = acol[col], c1 = acol[col + 1];
    if (row < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) = __floats2bfloat162_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i]), ar0), c0), s),
          __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 1]), ar0), c1), s));
    if (row + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
          __floats2bfloat162_rn(
              __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2]), ar1), c0), s),
              __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 3]), ar1), c1), s));
  }
}

}  // namespace
