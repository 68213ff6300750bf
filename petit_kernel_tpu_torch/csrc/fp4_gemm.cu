// Fused FP4 dequant + GEMM for Hopper (sm_90a):
//     C[m, n] = bf16((A[m, :] @ dequant(W, S)[:, n]) * gs)
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/fused.py:_fused_kernel
// (reached through fused_mul). One CTA per (block_m, block_n) output tile;
// the tile body, its layout, decode and what bounds it are in fp4_gemm.cuh,
// shared with the grouped (per-expert) kernel.

#include "fp4_gemm.cuh"

namespace {

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
fp4_gemm_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                __nv_bfloat16* __restrict__ C, int M, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  fp4_gemm_tile<BM, BN>(smem, A, W, S, gs, C, M, N, K, KP, blockIdx.y * BM,
                        blockIdx.x * BN);
}

template <int BM, int BN>
cudaError_t launch(const void* a, const void* w, const void* s, const void* gs, void* out,
                   int m, int n, int k, int kp, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(fp4_gemm_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  fp4_gemm_kernel<BM, BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), m, n, k, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pk_fp4_gemm(const void* a, const void* w, const void* s, const void* gs,
                           void* out, int m, int n, int k, int kp, int block_m,
                           int block_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch<16, 64>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 16 && block_n == 128)
    err = launch<16, 128>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 64)
    err = launch<64, 64>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch<64, 128>(a, w, s, gs, out, m, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
