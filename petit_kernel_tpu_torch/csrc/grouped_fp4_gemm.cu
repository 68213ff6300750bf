// Grouped (per-expert) fused FP4 dequant + GEMM for Hopper (sm_90a):
//     C[e] = bf16((X[e] @ dequant(W[e], S[e])) * gs[e]),  e in [0, E)
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/grouped.py:
// _grouped_kernel (reached through grouped_mul), which runs the fused body
// over a grid whose outermost axis is the expert. Here blockIdx.z is the
// expert: each CTA offsets the stacked operands to its expert,
//     X  (E, cap, k) bf16        + e*cap*k
//     W  (E, kp/8, n) words      + e*(kp/8)*n
//     S  (E, kp/16, n) bf16      + e*(kp/16)*n
//     C  (E, cap, n) bf16        + e*cap*n
//     gs (E,) f32 in device memory, read as gs[e],
// and runs fused_mul's tile body unchanged (fp4_gemm.cuh at 16 rows,
// fp4_wgmma.cuh's wgmma body at 64), so at the same (block_m, block_n)
// each expert's output equals fused_mul's on its slice bit for bit. The
// activations are read in natural k order: the TPU kernel's pi-interleave
// of A (grouped.py:109-110) served its MXU chunking and is not carried
// over.
//
// What bounds it: at decode (cap 8, Mixtral-8x7B) the weight stream of all
// E experts, 0.625 bytes per weight, 293.6 MB for one (4096, 14336)
// projection over 8 experts; at prefill (cap 128 and up) the tensor cores.
// Every expert runs its cap rows, even an empty bucket, as on the TPU:
// skipping empty experts needs device-side bucket counts (later work).

#include "fp4_wgmma.cuh"

namespace {

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
grouped_fp4_gemm_kernel(const __nv_bfloat16* __restrict__ X, const uint32_t* __restrict__ W,
                        const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                        __nv_bfloat16* __restrict__ C, int cap, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t e = blockIdx.z;
  if constexpr (BM == WG_BM)
    fp4_wgmma_tile<BN, 1>(smem, X + e * cap * K, W + e * (KP / 8) * N,
                          S + e * (KP / 16) * N, gs + e, C + e * cap * N, cap, N, K,
                          KP, blockIdx.y * BM, blockIdx.x * BN);
  else
    fp4_gemm_tile<BM, BN>(smem, X + e * cap * K, W + e * (KP / 8) * N,
                          S + e * (KP / 16) * N, gs + e, C + e * cap * N, cap, N, K,
                          KP, blockIdx.y * BM, blockIdx.x * BN);
}

template <int BM, int BN>
cudaError_t launch(const void* x, const void* w, const void* s, const void* gs, void* out,
                   int experts, int cap, int n, int k, int kp, cudaStream_t stream) {
  static_assert(BM != WG_BM || fp4_wgmma_threads<BN, 1>() == THREADS, "threads");
  constexpr int bytes = BM == WG_BM ? fp4_wgmma_smem_bytes<BN, 1>() : smem_bytes<BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(grouped_fp4_gemm_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (cap + BM - 1) / BM, experts);
  grouped_fp4_gemm_kernel<BM, BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), cap, n, k, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pk_grouped_fp4_gemm(const void* x, const void* w, const void* s,
                                   const void* gs, void* out, int experts, int cap, int n,
                                   int k, int kp, int block_m, int block_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0 || experts < 1 ||
      experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch<16, 64>(x, w, s, gs, out, experts, cap, n, k, kp, st);
  else if (block_m == 16 && block_n == 128)
    err = launch<16, 128>(x, w, s, gs, out, experts, cap, n, k, kp, st);
  else if (block_m == 64 && block_n == 64)
    err = launch<64, 64>(x, w, s, gs, out, experts, cap, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch<64, 128>(x, w, s, gs, out, experts, cap, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
