// W4A8 GEMM for Hopper (sm_90a): FP4 weights requantized to int8 in the
// kernel, int8 activations, int8 tensor-core products with int32 sums:
//     B8[k, n] = rne(bf16(decode(W)[k, n] * R[k / 16, n]))      (|B8| <= 127)
//     C[m, n]  = bf16(((f32(sum_k A8[m, k] * B8[k, n]) * arow[m]) * acol[n]) * gs)
//
// pk_fp4_gemm_w4a8 replaces the TPU kernel
// petit_kernel_tpu/ops/kernels/fused.py:_fused_kernel_w4a8 and
// pk_fp4_gemm_w4a8_wc its weight-cache variant _fused_kernel_w4a8_wc (both
// reached through fused_mul_w4a8). The operands are fused_mul's: the packed
// words W (kp/8, n) of fp4_gemm.cuh's layout, with R (kp/16, n) bf16 =
// scales * 127 / colmax in place of the scales (w4a8_requant_constants in
// ops/kernels/fused.py); A8 (m, k) int8 and arow (m,) f32 are the per-token
// activation quantization, acol (n,) f32 = colmax / 127 the per-column
// weight scale, gs the global scale, all in device memory.
//
// Numerics: value times R is exact in f32 (a 2-bit by an 8-bit
// significand) and is rounded to bf16 once, as the TPU kernel's bf16
// multiply does; __float2int_rn of that bf16 value is the TPU kernel's
// magic-constant round to nearest even (|b| <= 127 by the construction of
// R). The int32 sums are exact, so the result does not depend on the order
// of k: this kernel, its weight-cache variant and the plain PyTorch twin
// (fused_mul_w4a8_reference) agree bit for bit.
//
// What bounds it: at prefill the int8 tensor cores. At m = 2048, n =
// 28672, k = 4096 (Llama-3-8B's fused gate/up) it does 481 G integer
// operations against 0.2 GB of operands: 0.24 ms at 1,979 TOP/s int8, 0.06
// ms at 3.35 TB/s. Every 64-row tile runs the int8 wgmma body of
// w4a8_wgmma.cuh (fp4_gemm_w4a8_wgmma_kernel<BN, G>: a warpgroup a 64-row
// m-tile, a cp.async ring, the weights requantized two values per 32-bit
// operation into swizzled K-major int8 B rows; its note gives the design
// and the shared memory): the plain kernel's (the only ones an engine
// reaches: W4A8 routes m >= 256) at G = 1, the weight cache's at G =
// WC_GROUP = 4 m-tiles a CTA, which share one requantization of each
// weight block. The requantization's integer operations set the plain
// tile's time (PERF.md, section 6), so the weight cache divides them by G.
// Why G = 4 at both widths:
//   - G = 4 is 512 threads a CTA; __launch_bounds__(512, 1) caps a thread
//     at 128 registers, where the G = 1 tile uses 176 at BN = 128. The
//     shared cut needs 8 words a thread, not 32, beside 64 accumulators:
//     ptxas (CUDA 12.9) gives <128, 4> 128 registers and a 16-byte
//     spill, <64, 4> 107 and none;
//   - G = 2 leaves 255 registers, and two blocks an SM at BN = 64, and
//     gives m = 512's wo and w_down 128 CTAs where G = 4 gives 64;
//   - shared memory fits either way (W8Plan): one block an SM at G = 4,
//     140,288 bytes (one) and 95,232 (two) at G = 2;
//   - on the card G = 4 was the faster at both widths and both m of the
//     Llama-3-8B projections (m = 2048, 64x128: 1.70 ms against 2.48 at G
//     = 2; m = 512: 0.63 against 0.67; PERF.md, section 6).
//
// The 16-row tiles of both kernels keep the first version below, built
// on fp4_gemm.cuh's step structure: one CTA per (block_m, block_n) tile
// (THREADS threads) walks kp in steps of 32 word rows (256 natural k);
// each step stages the int8 A rows (8-byte runs of contiguous k) and the
// step's 32 R rows in shared memory, requantizes the words into an
// n-major int8 B tile (one thread per four word rows of a column writes 8
// contiguous int8 values at a time, about ten scalar operations a
// weight), and runs mma.sync m16n8k32 s8 with s32 accumulators. No
// cp.async pipeline, TMA or wgmma. The 16-row weight cache runs WC_GROUP
// m-tiles of one n-tile per CTA of 4*WC_GROUP warps and requantizes each
// weight block once for all of them (fp4_gemm.cu explains why there is no
// k-resident cache). The int32 sums are exact, so the bodies agree bit for
// bit.
//
// The mma.sync body's operands use fp4_gemm.cuh's local k order inside a
// step, L = j*64 + a*8 + x; the int8 row stride LDB8 = 272 bytes puts the
// eight rows of an MMA fragment load four banks apart, so the loads are
// free of bank conflicts.

#include <stdint.h>

#include "fp4_gemm.cuh"
#include "w4a8_wgmma.cuh"

namespace {

constexpr int LDB8 = KSTEP + 16;   // int8 smem row stride in bytes

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The requantized int8 value of quarter J's slot in a 16-bit half, as the
// low byte of a word.
template <int J>
__device__ __forceinline__ uint32_t requant(uint32_t half, float r) {
  const float b = __bfloat162float(__float2bfloat16_rn(__fmul_rn(decode_slot<J>(half), r)));
  return static_cast<uint32_t>(__float2int_rn(b)) & 0xFFu;
}

template <int BM, int BN, int G>
constexpr int w4a8_smem_bytes() {
  return (G * BM + BN) * LDB8 + WROWS * BN * 4;
}

template <int BM, int BN, int G>
__global__ void __launch_bounds__(THREADS * G)
fp4_gemm_w4a8_kernel(const int8_t* __restrict__ A, const float* __restrict__ arow,
                     const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ R,
                     const float* __restrict__ acol, const float* __restrict__ gs,
                     __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP) {
  constexpr int NTH = THREADS * G;
  constexpr int WM = (BM == 16) ? 1 : 2;   // warps along m
  constexpr int WN = 4 / WM;               // warps along n
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                                  // [G*BM][LDB8]
  unsigned char* Bs = As + G * BM * LDB8;                    // [BN][LDB8], n-major
  float* Rs = reinterpret_cast<float*>(Bs + BN * LDB8);      // [32][BN]

  const int m0 = blockIdx.y * (G * BM), n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = (G == 1) ? 0 : warp >> 2;     // m-tile of this warp
  const int wq = (G == 1) ? warp : (warp & 3);  // warp within its m-tile
  const int wm = wq / WN, wn = wq % WN;
  const int wrow = grp * BM + wm * WTM;         // first A row of this warp
  const int g = lane >> 2, tg = lane & 3;
  const int kq = KP / 4;        // natural k per quarter
  const int srq = KP / 64;      // R rows per quarter

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int step = 0; step < KP / KSTEP; ++step) {
    const int c = step >> 1, hf = step & 1;
    // A: G*BM rows x 32 runs (run = j*8 + a) of 8 contiguous natural k
    for (int e = tid; e < G * BM * 32; e += NTH) {
      const int m = e >> 5, run = e & 31;
      const int kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8;
      uint2 v = make_uint2(0u, 0u);
      if (m0 + m < M && kn < K)
        v = *reinterpret_cast<const uint2*>(A + (size_t)(m0 + m) * K + kn);
      *reinterpret_cast<uint2*>(As + m * LDB8 + run * 8) = v;
    }
    // R: row j*srq + c*8 + a -> Rs[j*8 + a][n]
    for (int e = tid; e < 32 * BN; e += NTH) {
      const int r = e / BN, n = e % BN;
      float v = 0.f;
      if (n0 + n < N)
        v = __bfloat162float(R[(size_t)((r >> 3) * srq + c * 8 + (r & 7)) * N + n0 + n]);
      Rs[r * BN + n] = v;
    }
    __syncthreads();
    // B: word rows r0 + 4x (x < 8) of column n hold, in half h, the natural
    // k of L = j*64 + (2*r0 + h)*8 + x: 8 contiguous int8 values per (j, h)
    for (int e = tid; e < 4 * BN; e += NTH) {
      const int r0 = e / BN, n = e % BN;
      uint32_t w[8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        w[x] = (n0 + n < N) ? W[(size_t)(step * WROWS + r0 + 4 * x) * N + n0 + n] : 0u;
      unsigned char* brow = Bs + n * LDB8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 2 * r0 + h;
        const float q0 = Rs[(0 * 8 + a) * BN + n], q1 = Rs[(1 * 8 + a) * BN + n];
        const float q2 = Rs[(2 * 8 + a) * BN + n], q3 = Rs[(3 * 8 + a) * BN + n];
        uint32_t b0[2] = {0u, 0u}, b1[2] = {0u, 0u}, b2[2] = {0u, 0u}, b3[2] = {0u, 0u};
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const uint32_t half = (w[x] >> (16 * h)) & 0xFFFFu;
          const int sh = 8 * (x & 3);
          b0[x >> 2] |= requant<0>(half, q0) << sh;
          b1[x >> 2] |= requant<1>(half, q1) << sh;
          b2[x >> 2] |= requant<2>(half, q2) << sh;
          b3[x >> 2] |= requant<3>(half, q3) << sh;
        }
        *reinterpret_cast<uint2*>(brow + 0 * 64 + a * 8) = make_uint2(b0[0], b0[1]);
        *reinterpret_cast<uint2*>(brow + 1 * 64 + a * 8) = make_uint2(b1[0], b1[1]);
        *reinterpret_cast<uint2*>(brow + 2 * 64 + a * 8) = make_uint2(b2[0], b2[1]);
        *reinterpret_cast<uint2*>(brow + 3 * 64 + a * 8) = make_uint2(b3[0], b3[1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 32; ++kk) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned char* p = As + (wrow + i * 16 + g) * LDB8 + kk * 32 + tg * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDB8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDB8 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* p = Bs + (wn * WTN + j * 8 + g) * LDB8 + kk * 32 + tg * 4;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

  // epilogue: bf16(((f32(acc) * arow) * acol) * gs), the TPU kernel's order
  // (fused.py:521-523)
  const float s = *gs;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wrow + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + tg * 2;
      if (col >= N) continue;
      const float c0 = acol[col], c1 = acol[col + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row + 8 * hr;
        if (r >= M) continue;
        const float ar = arow[r];
        const float v0 = __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hr]), ar), c0), s);
        const float v1 =
            __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hr + 1]), ar), c1), s);
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * N + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <int BM, int BN, int G>
cudaError_t launch(const void* a, const void* arow, const void* w, const void* r,
                   const void* acol, const void* gs, void* out, int m, int n, int k, int kp,
                   cudaStream_t stream) {
  constexpr int bytes = w4a8_smem_bytes<BM, BN, G>();
  cudaError_t err = cudaFuncSetAttribute(fp4_gemm_w4a8_kernel<BM, BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + G * BM - 1) / (G * BM));
  fp4_gemm_w4a8_kernel<BM, BN, G><<<grid, THREADS * G, bytes, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(arow),
      static_cast<const uint32_t*>(w), static_cast<const __nv_bfloat16*>(r),
      static_cast<const float*>(acol), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

// the 64-row tiles: G m-tiles of one n-tile a CTA, one warpgroup each, the
// int8 wgmma body
template <int BN, int G>
__global__ void __launch_bounds__(w4a8_wgmma_threads<BN, G>(), 1)
fp4_gemm_w4a8_wgmma_kernel(const int8_t* __restrict__ A, const float* __restrict__ arow,
                           const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ R,
                           const float* __restrict__ acol, const float* __restrict__ gs,
                           __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  w4a8_wgmma_tile<BN, G>(smem, A, arow, W, R, acol, gs, C, M, N, K, KP,
                         blockIdx.x * (G * WG_BM), blockIdx.y * BN);
}

template <int BN, int G>
cudaError_t launch_wgmma(const void* a, const void* arow, const void* w, const void* r,
                         const void* acol, const void* gs, void* out, int m, int n, int k,
                         int kp, cudaStream_t stream) {
  constexpr int bytes = w4a8_wgmma_smem_bytes<BN, G>();
  cudaError_t err = cudaFuncSetAttribute(fp4_gemm_w4a8_wgmma_kernel<BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((m + G * WG_BM - 1) / (G * WG_BM), (n + BN - 1) / BN);   // m-groups first
  fp4_gemm_w4a8_wgmma_kernel<BN, G><<<grid, w4a8_wgmma_threads<BN, G>(), bytes, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(arow),
      static_cast<const uint32_t*>(w), static_cast<const __nv_bfloat16*>(r),
      static_cast<const float*>(acol), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

// G: m-tiles a CTA, 1 or WC_GROUP (the weight cache)
template <int G>
int dispatch(const void* a, const void* arow, const void* w, const void* r, const void* acol,
             const void* gs, void* out, int m, int n, int k, int kp, int block_m, int block_n,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch<16, 64, G>(a, arow, w, r, acol, gs, out, m, n, k, kp, st);
  else if (block_m == 16 && block_n == 128)
    err = launch<16, 128, G>(a, arow, w, r, acol, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 64)
    err = launch_wgmma<64, G>(a, arow, w, r, acol, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch_wgmma<128, G>(a, arow, w, r, acol, gs, out, m, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int pk_fp4_gemm_w4a8(const void* a, const void* arow, const void* w, const void* r,
                                const void* acol, const void* gs, void* out, int m, int n,
                                int k, int kp, int block_m, int block_n, void* stream) {
  return dispatch<1>(a, arow, w, r, acol, gs, out, m, n, k, kp, block_m, block_n, stream);
}

extern "C" int pk_fp4_gemm_w4a8_wc(const void* a, const void* arow, const void* w,
                                   const void* r, const void* acol, const void* gs, void* out,
                                   int m, int n, int k, int kp, int block_m, int block_n,
                                   void* stream) {
  return dispatch<WC_GROUP>(a, arow, w, r, acol, gs, out, m, n, k, kp, block_m, block_n,
                            stream);
}
