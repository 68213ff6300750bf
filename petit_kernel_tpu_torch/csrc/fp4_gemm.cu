// Fused FP4 dequant + GEMM for Hopper (sm_90a):
//     C[m, n] = bf16((A[m, :] @ dequant(W, S)[:, n]) * gs)
//
// pk_fp4_gemm replaces the TPU kernel
// petit_kernel_tpu/ops/kernels/fused.py:_fused_kernel (reached through
// fused_mul). pk_fp4_gemm_wc replaces _fused_kernel_wc (fused_mul with a
// weight_cache solution id), which decodes each weight block once into a
// k-resident VMEM cache for every m-block. That cache would be kp * block_n
// * 2 bytes (3.7 MB at k = 14336, block_n = 128) against 227 KB of shared
// memory, so here the property carries over instead: one CTA runs WC_GROUP
// = 4 consecutive m-tiles of one n-tile and decodes each k-step's weights
// once for all of them.
//
// The 16-row (decode) tiles of both entries: fp4_stream_kernel<BN, G>, G =
// 1 for pk_fp4_gemm, WC_GROUP for pk_fp4_gemm_wc. What bounds them is the
// weight stream, 0.625 bytes a weight (a 4-bit value and a bf16 scale per
// 16 k): 136.3 MB a Llama-3-8B layer (wqkv, wo, w_gate_up, w_down), 0.041
// ms at 3.35 TB/s; the weight cache at m = 64 also reads A from L2 once per
// n-tile. To stream at that rate the card needs a few MB in flight on
// every SM at once, and each CTA's fixed costs (the ring's fill, the
// epilogue) must be small beside its bytes. What the design does: each
// output tile's kp is cut into `splits` CTAs of whole 256-deep steps (the
// wrapper's rules, ops/kernels/fused.py stream_splits and fp4_wc_splits:
// the most splits whose CTAs fit one wave of the CTAs an SM the plan
// allows, so wo and w_down, 64 tiles each, still fill the card); each CTA
// runs fp4_stream.cuh's body (a cp.async ring STAGES - 1 steps ahead, FP4
// decoded straight into the mma.sync B fragments, each feeding the MMAs of
// the warp's m-tiles) and the partials meet in reduce_splits, summed in
// split order by the tile's last CTA, so every launch repeats its bits.
// Every m-tile sees the same MMA sequence, so at one split count the
// weight cache's output equals the plain tile's bit for bit, and the
// grouped GEMM's 16-row tiles (grouped_fp4_gemm.cu), which run the same
// body, steps and sum, give each expert this kernel's bits. The 64-row
// (prefill) tiles run the wgmma body of fp4_wgmma.cuh. Those headers hold
// the layout, the decode, the shared memory and what bounds each.

#include "fp4_wgmma.cuh"

namespace {

// ---- the 16-row tiles: the split-k stream ----------------------------------

// grid (n_tiles * splits, ceil(M / 16G)), x tile-major, split-minor: G
// m-tiles of 16 rows of one n-tile a CTA. ws: [ceil(M/16G)][gridDim.x]
// blocks of 16G*BN floats (read only when splits > 1); counters: one int
// per (m-group, n-tile), zero before and after the launch.
template <int BN, int G>
__global__ void __launch_bounds__(THREADS, FsPlan<BN, G>::per_sm)
fp4_stream_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                  const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                  __nv_bfloat16* __restrict__ C, float* __restrict__ ws,
                  int* __restrict__ counters, int M, int N, int K, int KP, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  using P = FsPlan<BN, G>;
  constexpr int NT = BN / 32;
  const int x = blockIdx.x, mg = blockIdx.y, m0 = mg * (SBM * G);
  const int tile = x / splits, split = x % splits;
  const int steps = KP / KSTEP;
  const int n0 = tile * BN;

  float acc[G][NT][4];
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  fp4_stream<BN, P::stages, G>(smem, P::stage, A, W, S, M, N, K, KP, m0, n0,
                               split * steps / splits, (split + 1) * steps / splits, acc);

  const int g = (threadIdx.x & 31) >> 2;
  bool row_ok[G][2];
#pragma unroll
  for (int mt = 0; mt < G; ++mt) {
    row_ok[mt][0] = m0 + SBM * mt + g < M;
    row_ok[mt][1] = m0 + SBM * mt + g + 8 < M;
  }
  float* ws_tile = ws + ((size_t)mg * gridDim.x + (x - split)) * (SBM * G * BN);
  int* counter = counters + mg * (gridDim.x / splits) + tile;
  if (!reduce_splits<NT, G>(acc, ws_tile, splits, split, counter, row_ok, last)) return;
  fp4_stream_store<BN, G>(acc, *gs, C, M, N, m0, n0);
}

template <int BN, int G>
cudaError_t launch_stream(const void* a, const void* w, const void* s, const void* gs,
                          void* out, void* ws, void* counters, int m, int n, int k, int kp,
                          int splits, cudaStream_t stream) {
  using P = FsPlan<BN, G>;
  cudaError_t err = cudaFuncSetAttribute(fp4_stream_kernel<BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fp4_stream_kernel<BN, G>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN * splits, (m + SBM * G - 1) / (SBM * G));
  fp4_stream_kernel<BN, G><<<grid, THREADS, P::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
      m, n, k, kp, splits);
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
int dispatch(const void* a, const void* w, const void* s, const void* gs, void* out, void* ws,
             void* counters, int m, int n, int k, int kp, int block_m, int block_n,
             int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = kp / KSTEP;
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0 || splits < 1 ||
      splits > steps || (splits != 1 && block_m != 16) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch_stream<64, G>(a, w, s, gs, out, ws, counters, m, n, k, kp, splits, st);
  else if (block_m == 16 && block_n == 128)
    err = launch_stream<128, G>(a, w, s, gs, out, ws, counters, m, n, k, kp, splits, st);
  else if (block_m == 64 && block_n == 64)
    err = launch_wgmma<64, G>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch_wgmma<128, G>(a, w, s, gs, out, m, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// ws: (ceil(m / (16G)) * ceil(n / block_n) * splits * 16G * block_n) f32
// and counters: (ceil(m / (16G)) * ceil(n / block_n)) int32 zeros, G = 1
// (pk_fp4_gemm) or WC_GROUP (pk_fp4_gemm_wc), both needed only where
// splits > 1 (block_m = 16 only).
extern "C" int pk_fp4_gemm(const void* a, const void* w, const void* s, const void* gs,
                           void* out, void* ws, void* counters, int m, int n, int k, int kp,
                           int block_m, int block_n, int splits, void* stream) {
  return dispatch<1>(a, w, s, gs, out, ws, counters, m, n, k, kp, block_m, block_n, splits,
                     stream);
}

extern "C" int pk_fp4_gemm_wc(const void* a, const void* w, const void* s, const void* gs,
                              void* out, void* ws, void* counters, int m, int n, int k, int kp,
                              int block_m, int block_n, int splits, void* stream) {
  return dispatch<WC_GROUP>(a, w, s, gs, out, ws, counters, m, n, k, kp, block_m, block_n,
                            splits, stream);
}
