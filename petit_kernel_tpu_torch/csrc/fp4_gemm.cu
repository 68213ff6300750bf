// Fused FP4 dequant + GEMM for Hopper (sm_90a):
//     C[m, n] = bf16((A[m, :] @ dequant(W, S)[:, n]) * gs)
//
// pk_fp4_gemm replaces the TPU kernel
// petit_kernel_tpu/ops/kernels/fused.py:_fused_kernel (reached through
// fused_mul): one CTA per (block_m, block_n) output tile. pk_fp4_gemm_wc
// replaces _fused_kernel_wc (fused_mul with a weight_cache solution id),
// which decodes each weight block once into a k-resident VMEM cache for
// every m-block. That cache would be kp * block_n * 2 bytes (3.7 MB at
// k = 14336, block_n = 128) against 227 KB of shared memory, so here the
// property carries over instead: one CTA of 4*WC_GROUP warps runs
// WC_GROUP = 4 consecutive m-tiles of one n-tile and decodes each k-step's
// weights once for all of them. The 16-row (decode) tiles run the body of
// fp4_gemm.cuh, the 64-row (prefill) tiles the wgmma body of
// fp4_wgmma.cuh, both shared with the grouped (per-expert) kernel; those
// headers hold the layout, the decode and what bounds each.

#include "fp4_wgmma.cuh"

namespace {

template <int BM, int BN, int G>
__global__ void __launch_bounds__(THREADS * G)
fp4_gemm_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  fp4_gemm_tile<BM, BN, G>(smem, A, W, S, gs, C, M, N, K, KP, blockIdx.y * (G * BM),
                           blockIdx.x * BN);
}

template <int BM, int BN, int G>
cudaError_t launch(const void* a, const void* w, const void* s, const void* gs, void* out,
                   int m, int n, int k, int kp, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM, BN, G>();
  cudaError_t err = cudaFuncSetAttribute(fp4_gemm_kernel<BM, BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + G * BM - 1) / (G * BM));
  fp4_gemm_kernel<BM, BN, G><<<grid, THREADS * G, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

// the 64-row tiles: G m-tiles of one n-tile, one warpgroup each
template <int BN, int G>
__global__ void __launch_bounds__(fp4_wgmma_threads<BN, G>(), 1)
fp4_wgmma_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                 const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                 __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  fp4_wgmma_tile<BN, G>(smem, A, W, S, gs, C, M, N, K, KP, blockIdx.y * (G * WG_BM),
                        blockIdx.x * BN);
}

template <int BN, int G>
cudaError_t launch_wgmma(const void* a, const void* w, const void* s, const void* gs,
                         void* out, int m, int n, int k, int kp, cudaStream_t stream) {
  constexpr int bytes = fp4_wgmma_smem_bytes<BN, G>();
  cudaError_t err = cudaFuncSetAttribute(fp4_wgmma_kernel<BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + G * WG_BM - 1) / (G * WG_BM));
  fp4_wgmma_kernel<BN, G><<<grid, fp4_wgmma_threads<BN, G>(), bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

template <int G>
int dispatch(const void* a, const void* w, const void* s, const void* gs, void* out, int m,
             int n, int k, int kp, int block_m, int block_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch<16, 64, G>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 16 && block_n == 128)
    err = launch<16, 128, G>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 64)
    err = launch_wgmma<64, G>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch_wgmma<128, G>(a, w, s, gs, out, m, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int pk_fp4_gemm(const void* a, const void* w, const void* s, const void* gs,
                           void* out, int m, int n, int k, int kp, int block_m,
                           int block_n, void* stream) {
  return dispatch<1>(a, w, s, gs, out, m, n, k, kp, block_m, block_n, stream);
}

extern "C" int pk_fp4_gemm_wc(const void* a, const void* w, const void* s, const void* gs,
                              void* out, int m, int n, int k, int kp, int block_m,
                              int block_n, void* stream) {
  return dispatch<WC_GROUP>(a, w, s, gs, out, m, n, k, kp, block_m, block_n, stream);
}
