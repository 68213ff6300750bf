// The W4A8 decode-regime stream body for Hopper (sm_90a): the 16-row tiles
// of fp4_gemm_w4a8.cu, plain (G = 1 m-tile a CTA) and weight cache (G =
// WC_GROUP = 4 m-tiles of one n-tile a CTA), FP4 weights requantized to
// int8 in registers, int8 activations, mma.sync m16n8k32 s8 with s32 sums:
//     B8[k, n] = rne(bf16(decode(W)[k, n] * R[k / 16, n]))      (|B8| <= 127)
//     C[m, n]  = bf16(((f32(sum_k A8[m, k] * B8[k, n]) * arow[m]) * acol[n]) * gs)
// on the operands of fp4_gemm_w4a8.cu (W (kp/8, n) words of fp4_gemm.cuh's
// layout, R (kp/16, n) bf16 requantization constants, A8 (m, k) int8 in
// natural k order, arow (m,) and acol (n,) f32, gs). It replaces, at decode
// block sizes, the TPU kernels petit_kernel_tpu/ops/kernels/fused.py:482
// _fused_kernel_w4a8 and :526 _fused_kernel_w4a8_wc (reached through
// fused_mul_w4a8, their pallas_call at :695).
//
// What bounds it: at m <= 64 the weight stream, 0.625 bytes a weight, and
// the instructions a weight takes to become an int8 B value. What the
// design does, after fp4_stream.cuh, whose helpers it uses as they are:
//   - split-k: the caller cuts kp into whole 256-deep steps over `splits`
//     CTAs of one output tile (ops/kernels/fused.py w4a8_splits, the FP4
//     stream's rule over the launch's CTAs); their int32 partials meet in a
//     workspace, and the tile's last CTA to arrive (a per-tile counter in
//     the buffer the FP4 16-row tiles share, reset by that CTA) sums them
//     in split order (reduce_splits_i32). int32 and not f32: a sum reaches
//     k * 127^2, 2.3e8 at k = 14336, past f32's 2^24;
//   - a ring of stages filled by 16-byte cp.async copies, zero-filled past
//     M, K and N (rows past M are copied as zeros, so every stage row holds
//     either A or 0), STAGES - 1 steps ahead, one barrier a step; the
//     deepest ring that lets two CTAs share an SM (113 KB);
//   - no B tile: each thread requantizes its own words straight into the
//     MMA's B fragments, two values per decode_pair and mul.rn.bf16x2,
//     four per requant4 (w4a8_wgmma.cuh), and each B fragment feeds G
//     MMAs, one per m-tile: the weight cache requantizes a weight once per
//     16G rows, as _fused_kernel_w4a8_wc does once per m-block.
//
// The step. Step s takes half h = s & 1 of the 128-deep block c = s >> 1 of
// every quarter j, natural k j*(kp/4) + 128c + 64h .. + 63, as
// fp4_wgmma.cuh's steps do: stage word row r <- word row 64c + 2h + 4(r >>
// 1) + (r & 1) (wg_load_ws's rows), stage R row 4j + A <- R row j*(kp/64)
// + 8c + 4h + A. By the word layout (fp4_gemm.cuh) the slot of quarter j in
// half e of stage row r holds quarter-local natural offset 16(2(r & 1) + e)
// + (r >> 1), under stage R row 4j + 2(r & 1) + e.
//
// Fragments. The k order inside a step is free (the int32 sums are exact),
// so it is chosen for cheap loads. The k32 chunk (j, p) is the quarter's
// natural offsets 32p .. 32p + 31, in order. Thread (g, tg) builds, for B
// column g of a slice, b[0] (MMA k 4tg .. 4tg + 3, offsets 32p + 4tg + i)
// from the half-0 slots of stage rows 8tg + p + 2i, i < 4, and b[1] (MMA k
// 16 + 4tg + i, offsets 32p + 16 + 4tg + i) from their half-1 slots: its 4
// words, made into half pairs by prmt (w8_words' pairs), give 32 values,
// the B fragments of the four chunks (j, p), j < 4. So A stays in natural
// order: a stage row holds its 256 k as the four quarters' 64-byte runs,
// and one ldmatrix.x4 at row (lane & 15), byte 64j + 32p + 16(lane >> 4)
// gives a chunk's A fragment. The A rows are 272 bytes apart, so the eight
// rows of an ldmatrix phase hit all 32 banks. The words' 16-byte chunks are
// swizzled by word_chunk, so the four tg of a warp (stage rows 8 apart,
// 2048 or 4096 bytes apart) read four bank groups.
//
// Column order (fp4_stream.cuh's): slice jn's column c is warp column c*NT
// + jn, so a thread's NT B columns are adjacent (one vector load of words,
// one of R) and its accumulators cover 2NT adjacent columns.
//
// Shared memory: a stage is 16G rows of 272 bytes, 32 word rows and 16 R
// rows of BN columns (14,592 bytes at (64, 1), 24,832 at (128, 1), 27,648
// at (64, 4), 37,888 at (128, 4)); 7, 4, 4 and 3 stages (static_asserts
// below).

#pragma once

#include "fp4_stream.cuh"
#include "w4a8_wgmma.cuh"

namespace {

constexpr int W8S_LDA = KSTEP + 16;          // bytes of an A stage row
constexpr int W8S_SMEM = 113 * 1024;         // two CTAs an SM

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the stage and ring of w4a8_stream_kernel<BN, G>: A [16G][W8S_LDA] int8,
// words [WROWS][BN] (16-byte chunks swizzled), R [WROWS / 2][BN] bf16
template <int BN, int G>
struct W8sPlan {
  static constexpr int rows = SBM * G;
  static constexpr int a_bytes = rows * W8S_LDA;
  static constexpr int w_bytes = WROWS * BN * 4;
  static constexpr int stage = a_bytes + w_bytes + WROWS / 2 * BN * 2;
  static constexpr int stages = W8S_SMEM / stage;
  static constexpr int bytes = stages * stage;
  static_assert(stages >= 2 && stage % 128 == 0, "ring");
};
static_assert(W8sPlan<64, 1>::stage == 14592 && W8sPlan<64, 1>::stages == 7 &&
                  W8sPlan<128, 1>::stage == 24832 && W8sPlan<128, 1>::stages == 4 &&
                  W8sPlan<64, 4>::stage == 27648 && W8sPlan<64, 4>::stages == 4 &&
                  W8sPlan<128, 4>::stage == 37888 && W8sPlan<128, 4>::stages == 3,
              "the plan in the note above");

template <int BN, int G>
constexpr int w4a8_stream_smem_bytes() { return W8sPlan<BN, G>::bytes; }

// cp.async the operands of `step` (A rows m0 .. m0 + 16G - 1, columns n0 ..)
// into the stage `st`
template <int BN, int G>
__device__ __forceinline__ void w8s_stage_load(unsigned char* st, const int8_t* __restrict__ A,
                                               const uint32_t* __restrict__ W,
                                               const __nv_bfloat16* __restrict__ R, int M,
                                               int N, int K, int KP, int m0, int n0,
                                               int step) {
  using P = W8sPlan<BN, G>;
  constexpr int WC = BN / 4, RC = BN / 8;   // 16-byte pieces of a word / R row
  static_assert((P::rows * 16) % THREADS == 0 && (WROWS * WC) % THREADS == 0 &&
                    (WROWS / 2 * RC) % THREADS == 0, "pieces per thread");
  uint32_t* Ws = reinterpret_cast<uint32_t*>(st + P::a_bytes);
  __nv_bfloat16* Rs = reinterpret_cast<__nv_bfloat16*>(Ws + WROWS * BN);
  const int tid = threadIdx.x;
  const int c = step >> 1, h = step & 1, kq = KP / 4, srq = KP / 64;
  // A: piece a (16 k) of row r is natural k (a >> 2) * kq + 128c + 64h +
  // 16(a & 3), at byte 16a of the row; zeros past M and K
#pragma unroll
  for (int i = 0; i < P::rows * 16 / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e >> 4, a = e & 15;
    const int kn = (a >> 2) * kq + 128 * c + 64 * h + 16 * (a & 3);
    const bool ok = m0 + r < M && kn < K;
    cp_async16(st + r * W8S_LDA + 16 * a, ok ? A + (size_t)(m0 + r) * K + kn : A, ok);
  }
  // words: stage row r <- word row 64c + 2h + 4(r >> 1) + (r & 1)
#pragma unroll
  for (int i = 0; i < WROWS * WC / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / WC, cc = e % WC;
    const int row = 64 * c + 2 * h + 4 * (r >> 1) + (r & 1);
    const bool ok = n0 + cc * 4 < N;   // N % 16 == 0: a piece is all in or all out
    cp_async16(Ws + r * BN + word_chunk(r, cc) * 4,
               ok ? W + (size_t)row * N + n0 + cc * 4 : W, ok);
  }
  // R: stage row 4j + t <- R row j*srq + 8c + 4h + t
#pragma unroll
  for (int i = 0; i < WROWS / 2 * RC / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / RC, cc = e % RC;
    const int row = (r >> 2) * srq + 8 * c + 4 * h + (r & 3);
    const bool ok = n0 + cc * 8 < N;
    cp_async16(Rs + r * BN + cc * 8, ok ? R + (size_t)row * N + n0 + cc * 8 : R, ok);
  }
}

// The k32 chunks (J, p) of every column slice and m-tile: lo[y] / hi[y] the
// half-0 / half-1 slot pairs of stage rows 8tg + p + 4y and + 2, r_ptr the
// thread's R columns at stage R row 2p
template <int J, int BN, int G>
__device__ __forceinline__ void w8s_chunk(int (&acc)[G][BN / 32][4],
                                          const uint32_t (&lo)[2][BN / 32],
                                          const uint32_t (&hi)[2][BN / 32],
                                          const unsigned char* a_ptr,
                                          const __nv_bfloat16* r_ptr) {
  constexpr int NT = BN / 32;
  uint32_t a[G][4], s0[NT / 2], s1[NT / 2];
#pragma unroll
  for (int mt = 0; mt < G; ++mt) ldmatrix_x4(a[mt], a_ptr + mt * SBM * W8S_LDA + 64 * J);
  lds(s0, r_ptr + 4 * J * BN);         // chunk 2p: b[0]
  lds(s1, r_ptr + (4 * J + 1) * BN);   // chunk 2p + 1: b[1]
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const uint32_t sel = (jn & 1) ? 0x3232u : 0x1010u;   // broadcast column jn's R
    const uint32_t r0 = prmt(s0[jn >> 1], 0u, sel), r1 = prmt(s1[jn >> 1], 0u, sel);
    uint32_t b[2];
    b[0] = requant4(mul_bf16x2(decode_pair<J>(lo[0][jn]), r0),
                    mul_bf16x2(decode_pair<J>(lo[1][jn]), r0));
    b[1] = requant4(mul_bf16x2(decode_pair<J>(hi[0][jn]), r1),
                    mul_bf16x2(decode_pair<J>(hi[1][jn]), r1));
#pragma unroll
    for (int mt = 0; mt < G; ++mt) mma_s8(acc[mt][jn], a[mt], b);
  }
}

// the 8 k32 chunks of one staged step
template <int BN, int G>
__device__ __forceinline__ void w8s_stage_mma(const unsigned char* st,
                                              int (&acc)[G][BN / 32][4]) {
  using P = W8sPlan<BN, G>;
  constexpr int NT = BN / 32;   // 8-column slices of a warp (BN / 4 columns)
  static_assert(NT == 2 || NT == 4, "BN");
  const uint32_t* Ws = reinterpret_cast<const uint32_t*>(st + P::a_bytes);
  const __nv_bfloat16* Rs = reinterpret_cast<const __nv_bfloat16*>(Ws + WROWS * BN);
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5, tg = lane & 3;
  const int wcol = wn * (BN / 4) + (lane >> 2) * NT;   // first of the thread's NT columns
  const unsigned char* a_ptr = st + (lane & 15) * W8S_LDA + (lane >> 4) * 16;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t lo[2][NT], hi[2][NT];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int r0 = 8 * tg + p + 4 * y, r1 = r0 + 2;
      uint32_t w0[NT], w1[NT];
      lds(w0, Ws + r0 * BN + word_chunk(r0, wcol >> 2) * 4 + (wcol & 3));
      lds(w1, Ws + r1 * BN + word_chunk(r1, wcol >> 2) * 4 + (wcol & 3));
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        lo[y][jn] = prmt(w0[jn], w1[jn], 0x5410u);
        hi[y][jn] = prmt(w0[jn], w1[jn], 0x7632u);
      }
    }
    const __nv_bfloat16* r_ptr = Rs + 2 * p * BN + wcol;
    w8s_chunk<0, BN, G>(acc, lo, hi, a_ptr + 32 * p, r_ptr);
    w8s_chunk<1, BN, G>(acc, lo, hi, a_ptr + 32 * p, r_ptr);
    w8s_chunk<2, BN, G>(acc, lo, hi, a_ptr + 32 * p, r_ptr);
    w8s_chunk<3, BN, G>(acc, lo, hi, a_ptr + 32 * p, r_ptr);
  }
}

// Steps [s_begin, s_end) of the (16G, BN) tile at (m0, n0) into acc, through
// the ring at smem
template <int BN, int G>
__device__ __forceinline__ void w8s_stream(unsigned char* smem, const int8_t* __restrict__ A,
                                           const uint32_t* __restrict__ W,
                                           const __nv_bfloat16* __restrict__ R, int M, int N,
                                           int K, int KP, int m0, int n0, int s_begin,
                                           int s_end, int (&acc)[G][BN / 32][4]) {
  using P = W8sPlan<BN, G>;
  const int n = s_end - s_begin;
#pragma unroll
  for (int i = 0; i < P::stages - 1; ++i) {
    if (i < n)
      w8s_stage_load<BN, G>(smem + i * P::stage, A, W, R, M, N, K, KP, m0, n0, s_begin + i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<P::stages - 2>();
    __syncthreads();   // step i has landed; every thread is done with step i - 1's stage
    const int nx = i + P::stages - 1;
    if (nx < n)
      w8s_stage_load<BN, G>(smem + (nx % P::stages) * P::stage, A, W, R, M, N, K, KP, m0, n0,
                            s_begin + nx);
    cp_async_commit();
    w8s_stage_mma<BN, G>(smem + (i % P::stages) * P::stage, acc);
  }
}

// reduce_splits (fp4_stream.cuh) on int32 partials: with splits > 1, store
// this CTA's acc (split `split` of its tile) to ws, the tile's
// [splits][G][2][NT/2][THREADS] int4 block (rows g + 8h of m-tile mt,
// skipped where past M), count it in *counter, and return false except in
// the tile's last CTA to arrive, which resets *counter to 0 and returns
// true with acc = the partials summed in split order. With splits == 1
// returns true and leaves acc as it is. last: a __shared__ int.
template <int G, int NT>
__device__ __forceinline__ bool reduce_splits_i32(int (&acc)[G][NT][4], int* __restrict__ ws,
                                                  int splits, int split, int* counter,
                                                  const bool (&row_ok)[G][2], int& last) {
  static_assert(NT % 2 == 0, "NT");
  if (splits == 1) return true;
  constexpr int P = NT / 2, BLOCK = G * 2 * P * THREADS;   // int4 a split
  const int tid = threadIdx.x;
  int4* part = reinterpret_cast<int4*>(ws);
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_ok[mt][h]) continue;
#pragma unroll
      for (int p = 0; p < P; ++p)
        part[(size_t)split * BLOCK + ((mt * 2 + h) * P + p) * THREADS + tid] =
            make_int4(acc[mt][2 * p][2 * h], acc[mt][2 * p][2 * h + 1],
                      acc[mt][2 * p + 1][2 * h], acc[mt][2 * p + 1][2 * h + 1]);
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  constexpr int BATCH = 8;   // partial loads in flight at once
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_ok[mt][h]) continue;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int4* src = part + ((mt * 2 + h) * P + p) * THREADS + tid;
        int4 sum = __ldcg(src);
        for (int s0 = 1; s0 < splits; s0 += BATCH) {
          int4 v[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            if (s0 + u < splits) v[u] = __ldcg(src + (size_t)(s0 + u) * BLOCK);
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            if (s0 + u < splits) {
              sum.x += v[u].x; sum.y += v[u].y; sum.z += v[u].z; sum.w += v[u].w;
            }
        }
        acc[mt][2 * p][2 * h] = sum.x;
        acc[mt][2 * p][2 * h + 1] = sum.y;
        acc[mt][2 * p + 1][2 * h] = sum.z;
        acc[mt][2 * p + 1][2 * h + 1] = sum.w;
      }
    }
  if (tid == 0) *counter = 0;
  return true;
}

// bf16(((f32(acc) * arow) * acol) * gs), the TPU kernel's order
// (fused.py:521-523), into C (M, N): the thread's 2NT adjacent columns from
// n0 + wn*BN/4 + 2tg*NT, rows m0 + 16mt + g and + 8
template <int BN, int G>
__device__ __forceinline__ void w8s_store(const int (&acc)[G][BN / 32][4],
                                          const float* __restrict__ arow,
                                          const float* __restrict__ acol, float gs,
                                          __nv_bfloat16* __restrict__ C, int M, int N, int m0,
                                          int n0) {
  constexpr int NT = BN / 32;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int col = n0 + wn * (BN / 4) + 2 * tg * NT;
  if (col >= N) return;   // N % 16 == 0: the 2NT columns are all in or all out
  float cs[2 * NT];
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) cs[q] = acol[col + q];
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + SBM * mt + g + 8 * h;
      if (row >= M) continue;
      const float ar = arow[row];
      uint32_t v[NT];   // columns 2i, 2i + 1: column q is acc[mt][q % NT][2h + q / NT]
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int q0 = 2 * i, q1 = 2 * i + 1;
        const float f0 = __fmul_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][q0 % NT][2 * h + q0 / NT]), ar),
                      cs[q0]),
            gs);
        const float f1 = __fmul_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][q1 % NT][2 * h + q1 / NT]), ar),
                      cs[q1]),
            gs);
        const __nv_bfloat162 b = __floats2bfloat162_rn(f0, f1);
        v[i] = *reinterpret_cast<const uint32_t*>(&b);
      }
      __nv_bfloat16* dst = C + (size_t)row * N + col;
      if constexpr (NT == 2)
        *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
}

}  // namespace
