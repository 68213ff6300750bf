// The 64-row (prefill) FP4 dequant + GEMM tile body for Hopper (sm_90a):
//     C[m, n] = bf16((A[m, :] @ dequant(W, S)[:, n]) * gs)
// for the (64, BN) output tiles of one CTA, on the packed operands of
// fp4_gemm.cuh (W (kp/8, n) words in the v6 q-coded layout, S (kp/16, n)
// bf16 scales, A (m, k) bf16 in natural k order). Every 64-row launcher
// runs it: pk_fp4_gemm and pk_fp4_gemm_wc (fp4_gemm.cu), the grouped GEMM's
// cap > 32 tiles (grouped_fp4_gemm.cu) and the hybrid GEMM's prefill FP4
// CTAs (hybrid_gemm.cu), so at one tile all four give the same bits. It
// replaces, at prefill block sizes, the TPU kernels
// petit_kernel_tpu/ops/kernels/fused.py:195 _fused_kernel, :259
// _fused_kernel_wc, grouped.py:26 _grouped_kernel and hybrid.py:34
// _hybrid_kernel (its FP4 half).
//
// What bounds it: the tensor cores. The four Llama-3-8B projections at
// m = 2048 are 8.93e11 operations, 0.903 ms at 989 TFLOP/s; their bytes
// (A, the packed weights, C) take a tenth of that. A 64-row tile decodes
// every weight once per 64 rows, so the decode has to run under the MMAs,
// and the MMAs have to reach the rate only wgmma gives. What the design
// does:
//   - one warpgroup per 64-row m-tile: wgmma.mma_async m64nBNk16 bf16 with
//     f32 accumulators in registers, A and B both read from shared memory
//     through descriptors, both K-major with the 128-byte swizzle;
//   - the work goes by units of 64 contiguous natural k: a step takes
//     half g of the 128-deep block c of every quarter j (word rows 64c ..
//     64c + 63 hold all of block c: fp4_gemm.cuh), one unit a quarter, so a
//     unit's A is 128 contiguous bytes a row, one 128-byte swizzle row:
//     plain 16-byte cp.async copies (zero past M and K) that use every
//     byte of each sector they touch, chunk a of row r stored at chunk
//     a ^ (r & 7). (The layout's local k order of fp4_gemm.cuh would take
//     8 of every 16 k, half of each sector, and the A copies bound the
//     tile.) The step's 32 word rows are those of block c congruent to
//     2g and 2g + 1 mod 4, its 16 scale rows 8c + 4g .. + 3 of each
//     quarter;
//   - B is decoded two values per 32-bit operation (fp4_stream.cuh's
//     decode_pair: the 0x3F00 bias, a bf16x2 compare that zeroes the stored
//     zero t = 1, mul.rn.bf16x2 by the scale) into the swizzled B rows:
//     unit-local k 16A + 8b + x (chunk 2A + b) of column n is the slot of
//     quarter j in half A & 1 of word row 4(8b + x) + 2g + (A >> 1) of the
//     block, under scale row 8c + 4g + A (WgDecode below). Value times
//     scale is exact in bf16, so these are the exact decoded weights;
//   - a ring: three B slots (one quarter each), A slots DA + 2 quarters
//     deep, loaded DA units ahead, and two stages of words and scales,
//     loaded one step ahead. Unit u decodes into B slot u % 3 while unit
//     u - 1's wgmmas run (committed, waited for only down to one group in
//     flight), so the decode, the copies and the MMAs overlap;
//   - each output element sums its k in one order, unit by unit (block
//     c, half g, quarter j), four 16-deep m64 wgmmas a unit: the same
//     sequence in every launcher;
//   - the weight cache (G = 4) runs 4 warpgroups over 4 consecutive
//     m-tiles of one n-tile: each unit's B is decoded once for the four.
// Every instance fits the 232,448 bytes of shared memory a block may use
// (static_assert below). The A lookahead DA is picked for the most blocks
// an SM (WgPlan): each block has one warpgroup a tile, so a second block
// on the SM is what hides one block's barrier, copy and decode latencies.
//
// Visibility: wgmma reads shared memory through the async proxy, and both
// the decode's stores and the cp.async copies are generic-proxy writes, so
// each unit runs fence.proxy.async after them and before the barrier that
// precedes its wgmmas.

#pragma once

#include "fp4_stream.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WG_BM = 64;                    // rows of a wgmma m-tile
constexpr int WG_ROW = 128;                  // bytes of a swizzled quarter row (64 bf16)
constexpr int WG_SMEM_LIMIT = 232448;        // shared memory a block may use
constexpr int WG_SMEM_SM = 233472;           // an SM's, 1 KB of it reserved per block
constexpr int WG_B_SLOTS = 3;                // B quarter slots in the ring

// blocks of `bytes` that fit an SM's shared memory, 0 if none may
__host__ __device__ constexpr int wg_blocks(int bytes) {
  return bytes <= WG_SMEM_LIMIT ? WG_SMEM_SM / (bytes + 1024) : 0;
}

// shared-memory plan of fp4_wgmma_tile<BN, G>; every slot a multiple of
// 1024 bytes (the swizzle atom), the words and scales last
template <int BN, int G>
struct WgPlan {
  static constexpr int threads = THREADS * G;
  static constexpr int a_slot = G * WG_BM * WG_ROW;         // one quarter of G m-tiles
  static constexpr int b_slot = BN * WG_ROW;                // one quarter of B
  static constexpr int ws_stage = WROWS * BN * 4 + WROWS / 2 * BN * 2;   // words, scales
  static constexpr int fixed = WG_B_SLOTS * b_slot + 2 * ws_stage + 1024;   // + alignment
  // A lookahead in units, with da + 2 A slots: the deepest of 3, 2, 1 that
  // keeps the most blocks an SM. The plain (64, 128) tile takes 1 and two
  // blocks (115,712 bytes), the (64, 64) one 1 and three; the weight
  // cache, one block an SM at either width, 2 (128) and 3 (64)
  static constexpr int blocks = wg_blocks(3 * a_slot + fixed);
  static constexpr int da = wg_blocks(5 * a_slot + fixed) >= blocks   ? 3
                            : wg_blocks(4 * a_slot + fixed) >= blocks ? 2
                                                                      : 1;
  static constexpr int a_slots = da + 2;
  static constexpr int bytes = a_slots * a_slot + fixed;
  static_assert(blocks >= 1 && bytes <= WG_SMEM_LIMIT, "shared memory");
};

template <int BN, int G>
__host__ __device__ constexpr int fp4_wgmma_threads() { return WgPlan<BN, G>::threads; }

template <int BN, int G>
__host__ __device__ constexpr int fp4_wgmma_smem_bytes() { return WgPlan<BN, G>::bytes; }

// ---- loads -----------------------------------------------------------------

// the first natural k of unit u: quarter j = u & 3, block c and half g of
// step u >> 2
__device__ __forceinline__ int unit_k0(int KP, int u) {
  const int step = u >> 2;
  return (u & 3) * (KP / 4) + (step >> 1) * 128 + (step & 1) * 64;
}

// cp.async A of unit u, natural k unit_k0 .. + 63, for the G*64 rows from
// m0 into `slot`: chunk a of row r (8 k) to chunk a ^ (r & 7) of row r
template <int G>
__device__ __forceinline__ void wg_load_a(unsigned char* slot,
                                          const __nv_bfloat16* __restrict__ A, int M, int K,
                                          int KP, int m0, int u) {
  constexpr int NTH = THREADS * G;
  const int k0 = unit_k0(KP, u);
#pragma unroll
  for (int i = 0; i < G * WG_BM * 8 / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, r = e >> 3, a = e & 7;
    const int kn = k0 + a * 8;
    const bool ok = m0 + r < M && kn < K;
    cp_async16(slot + r * WG_ROW + ((a ^ (r & 7)) << 4),
               ok ? A + (size_t)(m0 + r) * K + kn : A, ok);
  }
}

// cp.async the words [WROWS][BN] and the scale rows [WROWS / 2][BN] of
// `step` (block c = step >> 1, half g = step & 1) into `stage`: stage word
// row sr <- word row 64c + 2g + 4(sr >> 1) + (sr & 1), stage scale row
// 4j + t <- scale row j*(kp/64) + 8c + 4g + t
template <int BN, int G>
__device__ __forceinline__ void wg_load_ws(unsigned char* stage,
                                           const uint32_t* __restrict__ W,
                                           const __nv_bfloat16* __restrict__ S, int N, int KP,
                                           int n0, int step) {
  constexpr int NTH = THREADS * G, WC = BN / 4, SC = BN / 8;
  uint32_t* Ws = reinterpret_cast<uint32_t*>(stage);
  __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(Ws + WROWS * BN);
  const int c = step >> 1, g = step & 1, srq = KP / 64;
  for (int e = threadIdx.x; e < WROWS * WC; e += NTH) {
    const int r = e / WC, cc = e % WC;
    const int row = 64 * c + 2 * g + 4 * (r >> 1) + (r & 1);
    const bool ok = n0 + cc * 4 < N;   // N % 16 == 0: a piece is all in or all out
    cp_async16(Ws + r * BN + cc * 4, ok ? W + (size_t)row * N + n0 + cc * 4 : W, ok);
  }
  for (int e = threadIdx.x; e < WROWS / 2 * SC; e += NTH) {
    const int r = e / SC, cc = e % SC;
    const int row = (r >> 2) * srq + 8 * c + 4 * g + (r & 3);
    const bool ok = n0 + cc * 8 < N;
    cp_async16(Ss + r * BN + cc * 8, ok ? S + (size_t)row * N + n0 + cc * 8 : S, ok);
  }
}

// ---- decode ----------------------------------------------------------------

// How the decode of one quarter is cut: a task is (CW columns STRIDE apart,
// word-row set p < 4); thread t runs column c0 = t % STRIDE, p = t / STRIDE.
// Set p = b + 2d holds the 8 stage rows 16b + d + 2x, x < 8, and fills
// chunks b + 4d (their half-0 slots) and b + 4d + 2 (half 1), x the
// element: unit-local k 8 * chunk + x is natural k 16A + 8b + x of the
// unit, A = chunk >> 1 = 2d + h, whose word row in block c is
// 4(8b + x) + 2g + d, half h, and scale row 8c + 4g + A.
template <int BN, int G>
struct WgDecode {
  static constexpr int NTH = THREADS * G;
  static constexpr int CW = BN * 4 >= NTH ? BN * 4 / NTH : 1;
  static constexpr int STRIDE = BN / CW;
  static constexpr int TASKS = BN * 4 / CW;
};

// The thread's words of one step as the half pairs decode_pair takes:
// lo[i][y] holds the half-0 slots of stage rows r and r + 2, r = 16b + d +
// 4y, of column i (elements 2y and 2y + 1), hi[i][y] their half-1 slots
template <int BN, int G>
__device__ __forceinline__ void wg_words(const uint32_t* Ws,
                                         uint32_t (&lo)[WgDecode<BN, G>::CW][4],
                                         uint32_t (&hi)[WgDecode<BN, G>::CW][4]) {
  using D = WgDecode<BN, G>;
  const int c0 = threadIdx.x % D::STRIDE, p = threadIdx.x / D::STRIDE;
  if (D::TASKS < D::NTH && threadIdx.x >= D::TASKS) return;
#pragma unroll
  for (int i = 0; i < D::CW; ++i) {
    const uint32_t* col = Ws + (16 * (p & 1) + (p >> 1)) * BN + c0 + i * D::STRIDE;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const uint32_t w0 = col[4 * y * BN], w1 = col[(4 * y + 2) * BN];
      lo[i][y] = prmt(w0, w1, 0x5410u);
      hi[i][y] = prmt(w0, w1, 0x7632u);
    }
  }
}

// Quarter J of the step into the B slot `bq`: chunks b + 4d and b + 4d + 2
// (8 values each) of the thread's columns, under stage scale rows 4J + 2d
// and 4J + 2d + 1
template <int J, int BN, int G>
__device__ __forceinline__ void wg_decode(unsigned char* bq, const __nv_bfloat16* Ss,
                                          const uint32_t (&lo)[WgDecode<BN, G>::CW][4],
                                          const uint32_t (&hi)[WgDecode<BN, G>::CW][4]) {
  using D = WgDecode<BN, G>;
  const int c0 = threadIdx.x % D::STRIDE, p = threadIdx.x / D::STRIDE;
  if (D::TASKS < D::NTH && threadIdx.x >= D::TASKS) return;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(Ss);
#pragma unroll
  for (int i = 0; i < D::CW; ++i) {
    const int n = c0 + i * D::STRIDE;
    const int d = p >> 1, ch = (p & 1) + 4 * d;   // the half-0 chunk; half 1: ch + 2
    const uint32_t s0 = s16[(4 * J + 2 * d) * BN + n], s1 = s16[(4 * J + 2 * d + 1) * BN + n];
    const uint32_t b0 = s0 | (s0 << 16), b1 = s1 | (s1 << 16);   // the scale in both halves
    uint32_t v0[4], v1[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      v0[y] = mul_bf16x2(decode_pair<J>(lo[i][y]), b0);
      v1[y] = mul_bf16x2(decode_pair<J>(hi[i][y]), b1);
    }
    unsigned char* row = bq + n * WG_ROW;
    *reinterpret_cast<uint4*>(row + ((ch ^ (n & 7)) << 4)) =
        make_uint4(v0[0], v0[1], v0[2], v0[3]);
    *reinterpret_cast<uint4*>(row + (((ch + 2) ^ (n & 7)) << 4)) =
        make_uint4(v1[0], v1[1], v1[2], v1[3]);
  }
}

// ---- the tile --------------------------------------------------------------

struct WgRing {
  unsigned char *a, *b, *ws;
};

// Unit u = 4 * step + J: decode into B slot u % 3, wait for A(u), then
// queue the copies of A(u + DA) (and, at J = 0, the words and scales of
// step + 1) and run the unit's four wgmmas.
template <int J, int BN, int G>
__device__ __forceinline__ void wg_unit(const WgRing& ring, const __nv_bfloat16* Ss,
                                        const uint32_t (&lo)[WgDecode<BN, G>::CW][4],
                                        const uint32_t (&hi)[WgDecode<BN, G>::CW][4],
                                        float (&acc)[BN / 2], const __nv_bfloat16* __restrict__ A,
                                        const uint32_t* __restrict__ W,
                                        const __nv_bfloat16* __restrict__ S, int M, int N, int K,
                                        int KP, int m0, int n0, int step) {
  using P = WgPlan<BN, G>;
  const int u = 4 * step + J, units = KP / KSTEP * 4;
  unsigned char* bq = ring.b + (u % WG_B_SLOTS) * P::b_slot;
  wg_decode<J, BN, G>(bq, Ss, lo, hi);
  cp_async_wait<P::da - 1>();   // A(u) and, at J = 3, the next step's words have landed
  fence_proxy_async();
  __syncthreads();              // B(u) complete; every warp is past wgmma(u - 2)
  if (u + P::da < units)
    wg_load_a<G>(ring.a + ((u + P::da) % P::a_slots) * P::a_slot, A, M, K, KP, m0, u + P::da);
  if (J == 0 && step + 1 < KP / KSTEP)
    wg_load_ws<BN, G>(ring.ws + ((step + 1) & 1) * P::ws_stage, W, S, N, KP, n0, step + 1);
  cp_async_commit();
  const int grp = threadIdx.x >> 7;   // this warpgroup's m-tile
  const uint64_t desc_a =
      sw128_desc(ring.a + (u % P::a_slots) * P::a_slot + grp * WG_BM * WG_ROW);
  const uint64_t desc_b = sw128_desc(bq);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q)   // 16-deep chunk q: 32 bytes further along the rows
    wgmma_bf16(acc, desc_a + 2 * q, desc_b + 2 * q);
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// The G tiles (m0 + 64i, n0), i < G, of one matrix, by one CTA of
// fp4_wgmma_threads<BN, G>() threads with fp4_wgmma_smem_bytes<BN, G>()
// bytes of dynamic shared memory at `smem`; warpgroup i owns m-tile i.
template <int BN, int G = 1>
__device__ __forceinline__ void fp4_wgmma_tile(
    unsigned char* smem, const __nv_bfloat16* __restrict__ A,
    const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ S,
    const float* __restrict__ gs, __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP,
    int m0, int n0) {
  using P = WgPlan<BN, G>;
  using D = WgDecode<BN, G>;
  static_assert(BN == 64 || BN == 128, "BN");
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  WgRing ring;
  ring.a = smem + ((1024u - (base & 1023u)) & 1023u);
  ring.b = ring.a + P::a_slots * P::a_slot;
  ring.ws = ring.b + WG_B_SLOTS * P::b_slot;
  const int steps = KP / KSTEP;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  // groups 0 .. da - 1: A of units 0 .. da - 1 (da < 4 <= units), step
  // 0's words and scales with the first
#pragma unroll
  for (int v = 0; v < P::da; ++v) {
    if (v == 0) wg_load_ws<BN, G>(ring.ws, W, S, N, KP, n0, 0);
    wg_load_a<G>(ring.a + v * P::a_slot, A, M, K, KP, m0, v);
    cp_async_commit();
  }
  cp_async_wait<P::da - 1>();
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(ring.ws + (step & 1) * P::ws_stage);
    const __nv_bfloat16* Ss = reinterpret_cast<const __nv_bfloat16*>(Ws + WROWS * BN);
    uint32_t lo[D::CW][4], hi[D::CW][4];
    wg_words<BN, G>(Ws, lo, hi);
    wg_unit<0, BN, G>(ring, Ss, lo, hi, acc, A, W, S, M, N, K, KP, m0, n0, step);
    wg_unit<1, BN, G>(ring, Ss, lo, hi, acc, A, W, S, M, N, K, KP, m0, n0, step);
    wg_unit<2, BN, G>(ring, Ss, lo, hi, acc, A, W, S, M, N, K, KP, m0, n0, step);
    wg_unit<3, BN, G>(ring, Ss, lo, hi, acc, A, W, S, M, N, K, KP, m0, n0, step);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: bf16(acc * gs), the TPU kernel's order (fused.py:254-256).
  // acc[4i + e] of warp w, lane l: row 16w + l/4 (+ 8 for e >= 2), column
  // 8i + 2(l % 4) + (e & 1)
  const float s = *gs;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = m0 + (threadIdx.x >> 7) * WG_BM + 16 * w + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    if (col >= N) continue;
    if (row < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
          __floats2bfloat162_rn(acc[4 * i] * s, acc[4 * i + 1] * s);
    if (row + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * s, acc[4 * i + 3] * s);
  }
}

}  // namespace
