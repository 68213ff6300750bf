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
// and runs fused_mul's tile bodies unchanged (at 16 rows fp4_stream.cuh's
// stream, k-split sum and store, as fp4_gemm.cu's fp4_stream_kernel does;
// at 64 fp4_wgmma.cuh's wgmma body), so at the same (block_m, block_n) and
// split count each expert's output equals fused_mul's on its slice bit for
// bit. The activations are read in natural
// k order: the TPU kernel's pi-interleave of A (grouped.py:109-110) served
// its MXU chunking and is not carried over.
//
// What bounds it: at decode (cap 8, Mixtral-8x7B) the weight stream of the
// experts, 0.625 bytes a weight: 880.8 MB for one layer's w_gate, w_up and
// w_down over 8 experts, 0.263 ms at 3.35 TB/s, less the weights of the
// experts whose tiles skip; at prefill (cap 128 and up) the tensor cores.
// What the design does at decode (block_m = 16): each expert's output
// tiles run the split-k stream of the plain decode GEMM (a cp.async ring,
// FP4 decoded straight into the mma.sync B fragments, partials summed in
// split order; the wrapper picks the splits by fused_mul's rule over the
// CTAs of all experts), and a tile whose bucket rows are all empty reads
// no weight at all: `rows` (optional, (E,) int32 in device memory) holds
// each bucket's filled rows, which fill from row 0 up, and a tile that
// starts at or past them writes bf16(0 * gs[e]), the bits its zero rows
// would give, without streaming anything. With rows == nullptr every tile
// runs, as on the TPU. The 64-row tiles ignore rows and do not split.

#include "fp4_wgmma.cuh"

namespace {

// the 16-row tiles: grid (n_tiles * splits, ceil(cap / 16), E), x
// tile-major, split-minor. ws: [E][ceil(cap/16)][gridDim.x] blocks of
// 16*BN floats (read only when splits > 1); counters: one int per (expert,
// m-tile, n-tile), zero before and after the launch. The body repeats
// fp4_stream_kernel's instead of sharing a tile function with it: each
// shared form tried changed that kernel's registers (102 to 100 or 116)
// and cost it 1-4% on the card.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
grouped_stream_kernel(const __nv_bfloat16* __restrict__ X, const uint32_t* __restrict__ W,
                      const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                      __nv_bfloat16* __restrict__ C, float* __restrict__ ws,
                      int* __restrict__ counters, const int* __restrict__ rows, int cap, int N,
                      int K, int KP, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int NT = BN / 32;
  const size_t e = blockIdx.z;
  const int x = blockIdx.x, mt = blockIdx.y, m0 = mt * SBM;
  const int tile = x / splits, split = x % splits;
  const int steps = KP / KSTEP;
  const int n0 = tile * BN;
  if (rows != nullptr && m0 >= rows[e]) {
    // every row of the tile is an empty bucket slot: split 0 writes what
    // the stream would, no split copies or counts anything
    if (split == 0) {
      const float zero[NT][4] = {};
      fp4_stream_store<BN>(zero, gs[e], C + e * cap * N, cap, N, m0, n0);
    }
    return;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  fp4_stream<BN, stream_stages<BN>()>(smem, fp4_stage_bytes<BN>(), X + e * cap * K,
                                      W + e * (KP / 8) * N, S + e * (KP / 16) * N, cap, N, K,
                                      KP, m0, n0, split * steps / splits,
                                      (split + 1) * steps / splits, acc);

  const int g = (threadIdx.x & 31) >> 2;
  const bool row_ok[2] = {m0 + g < cap, m0 + g + 8 < cap};
  const size_t mt_all = e * gridDim.y + mt;   // the m-tile over all experts
  float* ws_tile = ws + (mt_all * gridDim.x + (x - split)) * (SBM * BN);
  int* counter = counters + mt_all * (gridDim.x / splits) + tile;
  if (!reduce_splits<NT>(acc, ws_tile, splits, split, counter, row_ok, last)) return;
  fp4_stream_store<BN>(acc, gs[e], C + e * cap * N, cap, N, m0, n0);
}

// the 64-row tiles: one CTA an output tile
template <int BN>
__global__ void __launch_bounds__(THREADS)
grouped_wgmma_kernel(const __nv_bfloat16* __restrict__ X, const uint32_t* __restrict__ W,
                     const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                     __nv_bfloat16* __restrict__ C, int cap, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t e = blockIdx.z;
  fp4_wgmma_tile<BN, 1>(smem, X + e * cap * K, W + e * (KP / 8) * N, S + e * (KP / 16) * N,
                        gs + e, C + e * cap * N, cap, N, K, KP, blockIdx.y * WG_BM,
                        blockIdx.x * BN);
}

template <int BN>
cudaError_t launch_stream(const void* x, const void* w, const void* s, const void* gs,
                          void* out, void* ws, void* counters, const void* rows, int experts,
                          int cap, int n, int k, int kp, int splits, cudaStream_t stream) {
  constexpr int bytes = stream_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(grouped_stream_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(grouped_stream_kernel<BN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN * splits, (cap + SBM - 1) / SBM, experts);
  grouped_stream_kernel<BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
      static_cast<const int*>(rows), cap, n, k, kp, splits);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, const void* s, const void* gs,
                         void* out, int experts, int cap, int n, int k, int kp,
                         cudaStream_t stream) {
  static_assert(fp4_wgmma_threads<BN, 1>() == THREADS, "threads");
  constexpr int bytes = fp4_wgmma_smem_bytes<BN, 1>();
  cudaError_t err = cudaFuncSetAttribute(grouped_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (cap + WG_BM - 1) / WG_BM, experts);
  grouped_wgmma_kernel<BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<__nv_bfloat16*>(out), cap, n, k, kp);
  return cudaGetLastError();
}

}  // namespace

// ws: (E * ceil(cap/16) * ceil(n/block_n) * splits * 16 * block_n) f32 and
// counters: (E * ceil(cap/16) * ceil(n/block_n)) int32 zeros, both needed
// only where splits > 1 (block_m = 16 only); rows: nullptr or (E,) int32,
// read at block_m = 16 only.
extern "C" int pk_grouped_fp4_gemm(const void* x, const void* w, const void* s,
                                   const void* gs, void* out, void* ws, void* counters,
                                   const void* rows, int experts, int cap, int n, int k,
                                   int kp, int block_m, int block_n, int splits,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % KSTEP != 0 || k > kp || k % 128 != 0 || n % 16 != 0 || experts < 1 ||
      experts > 65535 || splits < 1 || splits > kp / KSTEP ||
      (splits != 1 && block_m != 16) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch_stream<64>(x, w, s, gs, out, ws, counters, rows, experts, cap, n, k, kp,
                            splits, st);
  else if (block_m == 16 && block_n == 128)
    err = launch_stream<128>(x, w, s, gs, out, ws, counters, rows, experts, cap, n, k, kp,
                             splits, st);
  else if (block_m == 64 && block_n == 64)
    err = launch_wgmma<64>(x, w, s, gs, out, experts, cap, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch_wgmma<128>(x, w, s, gs, out, experts, cap, n, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
