// The FP4 dequant + GEMM tile body of fp4_gemm.cu's 16-row weight cache,
// its only launcher:
//     C[m, n] = bf16((A[m, :] @ dequant(W, S)[:, n]) * gs)
// for the (BM, BN) output tile at (m0, n0). Every other FP4 tile runs a
// later body on this layout and decode: every 64-row (prefill) tile the
// wgmma body of fp4_wgmma.cuh, which sums in another order, and the plain,
// grouped and hybrid 16-row (decode) tiles fp4_stream.cuh, which with one
// k-split gives this body's bits. Its constants, decode_slot and mma_bf16
// serve fp4_stream.cuh, fp4_gemm_hp.cu, fp4_gemm_w4a8.cu and fp4_dequant.cu.
// It reads the same packed bytes
// as the TPU kernels (petit_kernel_tpu/ops/kernels/fused.py):
//   W  (kp/8, n) 32-bit words, v6 q-coded layout (ops/layout.py): slot s of
//      word row r holds natural k = j*(kp/4) + (r/64)*128 + pi(2*(r%64)+h),
//      j = s&3, h = s>>2, pi(i) = (i%8)*16 + i/8;
//   S  (kp/16, n) bf16 scales, row g covering natural k [16g, 16g+16);
//   A  (m, k) bf16 in natural k order, k <= kp (k % 128 == 0).
//
// What bounds it: at decode (m <= 16) the weight stream, 0.625 bytes per
// weight (a 4-bit value and a bf16 scale per 16 k). This first version is
// simple:
// one CTA per (block_m, block_n) output tile walks kp in steps of 32 word
// rows (256 natural k). Each step stages A (zero past k and past m) and the
// step's 32 scale rows in shared memory, decodes the words into a bf16 B
// tile, and runs mma.sync m16n8k16 bf16 with f32 accumulators. No
// cp.async pipeline, TMA or wgmma yet.
//
// The weight-cache variant (fp4_gemm.cu, pk_fp4_gemm_wc) runs G = WC_GROUP
// consecutive block_m tiles of one n-tile in one CTA of 4*G warps: each
// step decodes B once into shared memory and every group of four warps runs
// the plain kernel's MMAs for its m-tile against it, so a weight word is
// decoded ceil(m / (G*block_m)) times instead of ceil(m / block_m). Each
// output element sees the plain kernel's MMA sequence, fragment for
// fragment, so the two agree bit for bit.
//
// Decode: a slot's sign and 3-bit q-code t sit pre-positioned per quarter
// (layout.py _v6_place). The nonzero magnitudes are the bf16 bit patterns
// 0x3F00 + t*0x40 (t = 0, 2..7); t = 1 is the stored zero and decodes to an
// exact 0 here. The TPU kernel left it as the subnormal 2^-127 and relied
// on its VPU's subnormal flush; nothing here relies on a flush. Value times
// scale is exact in bf16 (2 and 4 significant bits), so one multiply serves
// all scale paths: E4M3 scales (nvfp4), and the power-of-two scales that
// the TPU applied by exponent add (mxfp4, nvfp4p2, nvfp4p2z, mxfp4z).
//
// The 32 word rows of a step cover, per quarter j, the natural k
//     j*(kp/4) + c*128 + a*16 + 8*hf + x,  a, x in [0, 8)
// (c = step/2, hf = step%2). The kernel's local k order inside a step is
// L = j*64 + a*8 + x, so A loads are runs of 8 contiguous natural k (16
// bytes) and the word of row rr, slot s decodes into L with ii = 2*rr + h,
// a = ii%8, x = ii/8. Scale row = j*(kp/64) + c*8 + a.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSTEP = 256;         // natural k per main-loop step
constexpr int WROWS = KSTEP / 8;   // packed word rows per step
constexpr int LDS = KSTEP + 8;     // smem row stride in bf16 (+16 bytes: no bank conflicts)
constexpr int THREADS = 128;       // four warps per m-tile
constexpr int WC_GROUP = 4;        // m-tiles per CTA in the weight-cache kernels

// Decode the slot of quarter j held in a 16-bit half -> float value.
template <int J>
__device__ __forceinline__ float decode_slot(uint32_t half) {
  uint32_t t, sg;
  if (J == 0) {
    t = (half >> 6) & 7u; sg = (half >> 15) & 1u;
  } else if (J == 1) {
    t = (half >> 3) & 7u; sg = (half >> 12) & 1u;
  } else if (J == 2) {
    t = half & 7u; sg = (half >> 9) & 1u;
  } else {
    t = ((half >> 10) & 3u) | (((half >> 13) & 1u) << 2); sg = (half >> 14) & 1u;
  }
  uint32_t bits = (t == 1u) ? 0u : (((0x3F00u + (t << 6)) << 16) | (sg << 31));
  return __uint_as_float(bits);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int G = 1>
constexpr int smem_bytes() {
  return (G * BM + BN) * LDS * 2 + WROWS * BN * 4;
}

// The G tiles (m0 + i*BM, n0), i < G, of one matrix, run by one CTA of
// THREADS*G threads with smem_bytes<BM, BN, G>() of dynamic shared memory at
// `smem`. Warps 4i..4i+3 own m-tile i and lay out over it as the four warps
// of a G = 1 CTA do.
template <int BM, int BN, int G = 1>
__device__ __forceinline__ void fp4_gemm_tile(
    unsigned char* smem, const __nv_bfloat16* __restrict__ A,
    const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ S,
    const float* __restrict__ gs, __nv_bfloat16* __restrict__ C, int M, int N,
    int K, int KP, int m0, int n0) {
  constexpr int NTH = THREADS * G;
  constexpr int WM = (BM == 16) ? 1 : 2;   // warps along m
  constexpr int WN = 4 / WM;               // warps along n
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "tile");

  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [G*BM][LDS]
  __nv_bfloat16* Bs = As + G * BM * LDS;                         // [BN][LDS], n-major
  float* Ss = reinterpret_cast<float*>(Bs + BN * LDS);           // [32][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // m-tile of this warp, and the warp within it; G = 1 keeps the plain
  // kernel's own expressions, whose code measured 12% faster at decode than
  // an equivalent (warp & 3) form
  const int grp = (G == 1) ? 0 : warp >> 2;
  const int wq = (G == 1) ? warp : (warp & 3);
  const int wm = wq / WN, wn = wq % WN;
  const int wrow = grp * BM + wm * WTM;         // first A row of this warp
  const int g = lane >> 2, tg = lane & 3;
  const int kq = KP / 4;        // natural k per quarter
  const int srq = KP / 64;      // scale rows per quarter

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int step = 0; step < KP / KSTEP; ++step) {
    const int c = step >> 1, hf = step & 1;
    // A: G*BM rows x 32 runs (run = j*8 + a) of 8 contiguous natural k
    for (int e = tid; e < G * BM * 32; e += NTH) {
      const int m = e >> 5, run = e & 31;
      const int kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < M && kn < K)
        v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + kn);
      *reinterpret_cast<uint4*>(As + m * LDS + run * 8) = v;
    }
    // scales: row j*srq + c*8 + a -> Ss[j*8 + a][n]
    for (int e = tid; e < 32 * BN; e += NTH) {
      const int r = e / BN, n = e % BN;
      float v = 0.f;
      if (n0 + n < N)
        v = __bfloat162float(S[(size_t)((r >> 3) * srq + c * 8 + (r & 7)) * N + n0 + n]);
      Ss[r * BN + n] = v;
    }
    __syncthreads();
    // B: decode 32 word rows x BN columns into Bs[n][L]
    for (int e = tid; e < WROWS * BN; e += NTH) {
      const int rr = e / BN, n = e % BN;
      uint32_t w = 0u;
      if (n0 + n < N) w = W[(size_t)(step * WROWS + rr) * N + n0 + n];
      __nv_bfloat16* brow = Bs + n * LDS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t half = (w >> (16 * h)) & 0xFFFFu;
        const int ii = 2 * rr + h, a = ii & 7, x = ii >> 3;
        const float v0 = decode_slot<0>(half), v1 = decode_slot<1>(half);
        const float v2 = decode_slot<2>(half), v3 = decode_slot<3>(half);
        brow[0 * 64 + a * 8 + x] = __float2bfloat16_rn(v0 * Ss[(0 * 8 + a) * BN + n]);
        brow[1 * 64 + a * 8 + x] = __float2bfloat16_rn(v1 * Ss[(1 * 8 + a) * BN + n]);
        brow[2 * 64 + a * 8 + x] = __float2bfloat16_rn(v2 * Ss[(2 * 8 + a) * BN + n]);
        brow[3 * 64 + a * 8 + x] = __float2bfloat16_rn(v3 * Ss[(3 * 8 + a) * BN + n]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = As + (wrow + i * 16 + g) * LDS + kk * 16 + tg * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = Bs + (wn * WTN + j * 8 + g) * LDS + kk * 16 + tg * 2;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

  // epilogue: bf16(acc * gs), the TPU kernel's order (fused.py:254-256)
  const float s = *gs;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wrow + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + tg * 2;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[i][j][0] * s, acc[i][j][1] * s);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[i][j][2] * s, acc[i][j][3] * s);
    }
}

}  // namespace
