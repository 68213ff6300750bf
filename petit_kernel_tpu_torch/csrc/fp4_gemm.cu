// Fused FP4 dequant + GEMM for Hopper (sm_90a):
//     C[m, n] = bf16((A[m, :] @ dequant(W, S)[:, n]) * gs)
//
// pk_fp4_gemm replaces the TPU kernel
// petit_kernel_tpu/ops/kernels/fused.py:_fused_kernel (reached through
// fused_mul). pk_fp4_gemm_wc replaces _fused_kernel_wc (fused_mul with a
// weight_cache solution id), which decodes each weight block once into a
// k-resident VMEM cache for every m-block. That cache would be kp * block_n
// * 2 bytes (3.7 MB at k = 14336, block_n = 128) against 227 KB of shared
// memory, so here the property carries over instead: one CTA of 4*WC_GROUP
// warps runs WC_GROUP = 4 consecutive m-tiles of one n-tile and decodes
// each k-step's weights once for all of them.
//
// The 16-row (decode) tiles of pk_fp4_gemm: fp4_stream_kernel. What bounds
// them is the weight stream, 0.625 bytes a weight (a 4-bit value and a bf16
// scale per 16 k): 136.3 MB a Llama-3-8B layer (wqkv, wo, w_gate_up,
// w_down), 0.041 ms at 3.35 TB/s. To stream at that rate the card needs a
// few MB in flight on every SM at once, and each CTA's fixed costs (the
// ring's fill, the epilogue) must be small beside its bytes. What the
// design does: each output tile's kp is cut into `splits` CTAs of whole
// 256-deep steps (the wrapper's rule, ops/kernels/fused.py stream_splits:
// at least two CTAs an SM, so wo and w_down, 64 tiles each, still fill the
// card); each CTA runs fp4_stream.cuh's body (a cp.async ring STAGES - 1
// steps ahead, FP4 decoded straight into the mma.sync B fragments) and the
// partials meet in reduce_splits, summed in split order by the tile's last
// CTA, so every launch repeats its bits. The grouped GEMM's 16-row tiles
// (grouped_fp4_gemm.cu) run the same body, steps and sum, so at one tile
// and split count each expert's output equals this kernel's bit for bit;
// with one split both equal fp4_gemm_tile<16, BN, 1>'s (the 16-row weight
// cache's at the same tile). The 64-row (prefill) tiles
// run the wgmma body of fp4_wgmma.cuh; the 16-row weight cache runs
// fp4_gemm.cuh's body. Those headers hold the layout, the decode and what
// bounds each.

#include "fp4_wgmma.cuh"

namespace {

// the 16-row weight-cache tiles: G m-tiles of one n-tile, four warps each
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

// ---- the 16-row tiles: the split-k stream ----------------------------------

// grid (n_tiles * splits, ceil(M / 16)), x tile-major, split-minor. ws:
// [ceil(M/16)][gridDim.x] blocks of 16*BN floats (read only when splits >
// 1); counters: one int per (m-tile, n-tile), zero before and after the
// launch.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
fp4_stream_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                  const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                  __nv_bfloat16* __restrict__ C, float* __restrict__ ws,
                  int* __restrict__ counters, int M, int N, int K, int KP, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int NT = BN / 32;
  const int x = blockIdx.x, mt = blockIdx.y, m0 = mt * SBM;
  const int tile = x / splits, split = x % splits;
  const int steps = KP / KSTEP;
  const int n0 = tile * BN;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  fp4_stream<BN, stream_stages<BN>()>(smem, fp4_stage_bytes<BN>(), A, W, S, M, N, K, KP, m0,
                                      n0, split * steps / splits,
                                      (split + 1) * steps / splits, acc);

  const int g = (threadIdx.x & 31) >> 2;
  const bool row_ok[2] = {m0 + g < M, m0 + g + 8 < M};
  float* ws_tile = ws + ((size_t)mt * gridDim.x + (x - split)) * (SBM * BN);
  int* counter = counters + mt * (gridDim.x / splits) + tile;
  if (!reduce_splits<NT>(acc, ws_tile, splits, split, counter, row_ok, last)) return;
  fp4_stream_store<BN>(acc, *gs, C, M, N, m0, n0);
}

template <int BN>
cudaError_t launch_stream(const void* a, const void* w, const void* s, const void* gs,
                          void* out, void* ws, void* counters, int m, int n, int k, int kp,
                          int splits, cudaStream_t stream) {
  constexpr int bytes = stream_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(fp4_stream_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fp4_stream_kernel<BN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN * splits, (m + SBM - 1) / SBM);
  fp4_stream_kernel<BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
      m, n, k, kp, splits);
  return cudaGetLastError();
}

// the 16-row tiles: the stream for the plain GEMM (G = 1), fp4_gemm_tile
// for the weight cache
template <int BN, int G>
cudaError_t launch_decode(const void* a, const void* w, const void* s, const void* gs,
                          void* out, void* ws, void* counters, int m, int n, int k, int kp,
                          int splits, cudaStream_t stream) {
  if constexpr (G == 1)
    return launch_stream<BN>(a, w, s, gs, out, ws, counters, m, n, k, kp, splits, stream);
  else
    return launch<16, BN, G>(a, w, s, gs, out, m, n, k, kp, stream);
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
int dispatch(const void* a, const void* w, const void* s, const void* gs, void* out, void* ws,
             void* counters, int m, int n, int k, int kp, int block_m, int block_n,
             int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = kp / KSTEP;
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0 || splits < 1 ||
      splits > steps || (splits != 1 && (G != 1 || block_m != 16)) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch_decode<64, G>(a, w, s, gs, out, ws, counters, m, n, k, kp, splits, st);
  else if (block_m == 16 && block_n == 128)
    err = launch_decode<128, G>(a, w, s, gs, out, ws, counters, m, n, k, kp, splits, st);
  else if (block_m == 64 && block_n == 64)
    err = launch_wgmma<64, G>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch_wgmma<128, G>(a, w, s, gs, out, m, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// ws: (ceil(m/16) * ceil(n/block_n) * splits * 16 * block_n) f32 and
// counters: (ceil(m/16) * ceil(n/block_n)) int32 zeros, both needed only
// where splits > 1 (block_m = 16 only).
extern "C" int pk_fp4_gemm(const void* a, const void* w, const void* s, const void* gs,
                           void* out, void* ws, void* counters, int m, int n, int k, int kp,
                           int block_m, int block_n, int splits, void* stream) {
  return dispatch<1>(a, w, s, gs, out, ws, counters, m, n, k, kp, block_m, block_n, splits,
                     stream);
}

extern "C" int pk_fp4_gemm_wc(const void* a, const void* w, const void* s, const void* gs,
                              void* out, int m, int n, int k, int kp, int block_m,
                              int block_n, void* stream) {
  return dispatch<WC_GROUP>(a, w, s, gs, out, nullptr, nullptr, m, n, k, kp, block_m, block_n,
                            1, stream);
}
