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
// multiply does; requant4's f32 add of 1.5 * 2^23 (w4a8_wgmma.cuh) rounds
// that bf16 value to nearest even, as the TPU kernel's magic-constant
// round does (|b| <= 127 by the construction of R). The int32 sums are
// exact, so the result does not depend on the order of k: this kernel, its
// weight-cache variant and the plain PyTorch twin
// (fused_mul_w4a8_reference) agree bit for bit, at every tile and split
// count.
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
// The 16-row tiles of both kernels (the decode block sizes, m <= 32 by
// the heuristic, and the weight cache's explicit ids) run the split-k
// stream body of w4a8_stream.cuh (w4a8_stream_kernel<BN, G>): a CTA of four
// warps streams the words and R of its split's steps through a cp.async
// ring, requantizes them straight into mma.sync m16n8k32 s8 B fragments
// and feeds each to its G m-tiles' MMAs; the splits' int32 partials meet
// in a workspace and the tile's last CTA sums them. That header's note
// gives the design and the shared memory. The plain kernel runs it at G =
// 1, the weight cache at G = WC_GROUP = 4 m-tiles of one n-tile a CTA
// (fp4_gemm.cu explains why there is no k-resident cache), so each weight
// is requantized once per 64 rows. The int32 sums are exact, so every
// body, tile and split count gives the same bits.

#include <stdint.h>

#include "fp4_gemm.cuh"
#include "w4a8_stream.cuh"
#include "w4a8_wgmma.cuh"

namespace {

// ---- the 16-row tiles: the split-k stream ----------------------------------

// grid (n_tiles * splits, ceil(M / 16G)), x tile-major, split-minor. ws:
// [ceil(M/16G)][gridDim.x] blocks of 16G*BN int32 (read only when splits >
// 1); counters: one int per (m-group, n-tile), zero before and after the
// launch.
template <int BN, int G>
__global__ void __launch_bounds__(THREADS, 2)
w4a8_stream_kernel(const int8_t* __restrict__ A, const float* __restrict__ arow,
                   const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ R,
                   const float* __restrict__ acol, const float* __restrict__ gs,
                   __nv_bfloat16* __restrict__ C, int* __restrict__ ws,
                   int* __restrict__ counters, int M, int N, int K, int KP, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int NT = BN / 32;
  const int x = blockIdx.x, mg = blockIdx.y, m0 = mg * (SBM * G);
  const int tile = x / splits, split = x % splits;
  const int steps = KP / KSTEP;
  const int n0 = tile * BN;

  int acc[G][NT][4];
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  w8s_stream<BN, G>(smem, A, W, R, M, N, K, KP, m0, n0, split * steps / splits,
                    (split + 1) * steps / splits, acc);

  const int g = (threadIdx.x & 31) >> 2;
  bool row_ok[G][2];
#pragma unroll
  for (int mt = 0; mt < G; ++mt) {
    row_ok[mt][0] = m0 + SBM * mt + g < M;
    row_ok[mt][1] = m0 + SBM * mt + g + 8 < M;
  }
  int* ws_tile = ws + ((size_t)mg * gridDim.x + (x - split)) * (SBM * G * BN);
  int* counter = counters + mg * (gridDim.x / splits) + tile;
  if (!reduce_splits_i32<G, NT>(acc, ws_tile, splits, split, counter, row_ok, last)) return;
  w8s_store<BN, G>(acc, arow, acol, *gs, C, M, N, m0, n0);
}

template <int BN, int G>
cudaError_t launch_stream(const void* a, const void* arow, const void* w, const void* r,
                          const void* acol, const void* gs, void* out, void* ws,
                          void* counters, int m, int n, int k, int kp, int splits,
                          cudaStream_t stream) {
  constexpr int bytes = w4a8_stream_smem_bytes<BN, G>();
  cudaError_t err = cudaFuncSetAttribute(w4a8_stream_kernel<BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(w4a8_stream_kernel<BN, G>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN * splits, (m + SBM * G - 1) / (SBM * G));
  w4a8_stream_kernel<BN, G><<<grid, THREADS, bytes, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(arow),
      static_cast<const uint32_t*>(w), static_cast<const __nv_bfloat16*>(r),
      static_cast<const float*>(acol), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), static_cast<int*>(ws), static_cast<int*>(counters),
      m, n, k, kp, splits);
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
             const void* gs, void* out, void* ws, void* counters, int m, int n, int k, int kp,
             int block_m, int block_n, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = kp / KSTEP;
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0 || splits < 1 ||
      splits > steps || (splits != 1 && block_m != 16) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch_stream<64, G>(a, arow, w, r, acol, gs, out, ws, counters, m, n, k, kp, splits,
                               st);
  else if (block_m == 16 && block_n == 128)
    err = launch_stream<128, G>(a, arow, w, r, acol, gs, out, ws, counters, m, n, k, kp,
                                splits, st);
  else if (block_m == 64 && block_n == 64)
    err = launch_wgmma<64, G>(a, arow, w, r, acol, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch_wgmma<128, G>(a, arow, w, r, acol, gs, out, m, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// ws: (ceil(m / (16G)) * ceil(n / block_n) * splits * 16G * block_n) int32
// and counters: (ceil(m / (16G)) * ceil(n / block_n)) int32 zeros, G = 1
// (pk_fp4_gemm_w4a8) or WC_GROUP (pk_fp4_gemm_w4a8_wc), both needed only
// where splits > 1 (block_m = 16 only).
extern "C" int pk_fp4_gemm_w4a8(const void* a, const void* arow, const void* w, const void* r,
                                const void* acol, const void* gs, void* out, void* ws,
                                void* counters, int m, int n, int k, int kp, int block_m,
                                int block_n, int splits, void* stream) {
  return dispatch<1>(a, arow, w, r, acol, gs, out, ws, counters, m, n, k, kp, block_m, block_n,
                     splits, stream);
}

extern "C" int pk_fp4_gemm_w4a8_wc(const void* a, const void* arow, const void* w,
                                   const void* r, const void* acol, const void* gs, void* out,
                                   void* ws, void* counters, int m, int n, int k, int kp,
                                   int block_m, int block_n, int splits, void* stream) {
  return dispatch<WC_GROUP>(a, arow, w, r, acol, gs, out, ws, counters, m, n, k, kp, block_m,
                            block_n, splits, stream);
}
