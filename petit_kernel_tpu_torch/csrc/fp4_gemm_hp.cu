// High-precision fused FP4 dequant + GEMM for Hopper (sm_90a):
//     C[m, n] = f32((A[m, :] @ dequant(W, S)[:, n]) * gs),  A and C f32
//
// pk_fp4_gemm_hp replaces the high_precision=True instance of
// petit_kernel_tpu/ops/kernels/fused.py:_fused_kernel (fused.py:230-252: f32
// A, each 128-deep dot at Precision.HIGHEST); pk_fp4_gemm_hp_wc replaces that
// of _fused_kernel_wc (fused.py:302-312: the bf16 decoded cache, f32 A). Both
// are reached through fused_mul with a high-precision solution id
// (ops/gemm.py: SolutionHints.require_high_precision or an explicit hp id).
//
// The decoded weight (value x scale) is exact in bf16 (fp4_gemm.cuh), so only
// A needs more than bf16's 8 significant bits. At fragment load each f32 A
// value splits into three bf16 parts (split3, fp4_stream.cuh):
//     hi = a truncated to bf16, mid = (a - hi) truncated to bf16,
//     lo = bf16_rn(a - hi - mid).
// Both subtractions are exact in f32 and lo keeps the last 8 bits, so the
// parts sum to a exactly for 2^-110 <= |a| <= FLT_MAX (below 2^-110, lo
// rounds on bf16's subnormal grid: an error under 2^-133). Truncation, not
// rounding, keeps hi finite for the largest f32 values. Each part times a
// weight is exact in f32, and three bf16 MMAs per fragment (mma.sync
// m16n8k16 in the 16-row tiles, register-A wgmma in the 64-row ones; lo,
// then mid, then hi, small parts first) add them into fresh f32
// accumulators, added to the running sum with one rounding: an f32-accurate
// product for three times the tensor-core work of the bf16 kernel, fewer
// than the six passes an f32 split of both operands would take.
//
// The 16-row tiles of both entries run fp4_hp_stream_kernel<BN, G> (G = 1
// for pk_fp4_gemm_hp, HP_WC_GROUP = 2 m-tiles a CTA for pk_fp4_gemm_hp_wc)
// on the f32 form of fp4_stream.cuh's split-k stream body: each output
// tile's kp cut into `splits` CTAs of whole 256-deep steps (ops/kernels/
// fused.py hp_splits: the most splits whose CTAs fit one wave of the CTAs
// an SM its plan HpPlan allows), a cp.async ring, FP4 decoded straight
// into the MMA's B fragments, each feeding 3G MMAs, and f32 split partials
// summed in split order by the tile's last CTA, so every launch repeats its
// bits. What bounds them is not the weight stream (0.625 bytes a weight:
// 19% of the time at m = 8) but the instructions: the three MMAs a
// fragment, then each warp's split of its A fragments and the decode
// (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W: edited copies
// without the MMAs take 0.59 of the time, without the split 0.74, without
// the decode 0.77).
//
// The 64-row tiles of both entries run fp4_hp_wgmma_kernel<BN, G> on
// fp4_hp_wgmma.cuh, the wgmma form of the same numerics (G = 1, or
// HP_WC_GROUP = 2 m-tiles a CTA, one warpgroup each, sharing each decoded
// B). Their bound is the tensor cores' (three bf16 passes over every
// weight, 2.710 ms at 989 TFLOP/s for the four Llama-3-8B projections at
// m = 2048); what holds them at 28-42% of it is each chunk's add of its
// part between one group and the next, with one or two warpgroups an SM
// (PERF.md section 6). The design reuses fp4_wgmma.cuh's ring and decode
// (a cp.async ring, B decoded two values an operation into
// 128-byte-swizzled shared memory one unit ahead), copies f32 A by
// cp.async into padded rows, and issues register-A wgmmas: each warp
// splits its A fragment into hi, mid and lo, three wgmmas (lo, mid, hi)
// write a fresh part, and the part is added to acc with one rounding
// while the next group runs. Both bodies
// give every output element one MMA sequence whatever the m-tiles a CTA,
// so each weight cache agrees with its plain tile bit for bit (the 16-row
// tiles at the same split count). The two bodies sum k in other orders
// (the 16-row tiles by step, the 64-row ones by unit), so their bits
// differ; both meet the same high-precision rule.

#include "fp4_hp_wgmma.cuh"

namespace {

// ---- the 16-row tiles: the split-k stream ----------------------------------

// grid (n_tiles * splits, ceil(M / 16G)), x tile-major, split-minor: G
// m-tiles of 16 rows of one n-tile a CTA (fp4_stream_kernel's grid). ws:
// [ceil(M/16G)][gridDim.x] blocks of 16G*BN floats (read only when splits >
// 1); counters: one int per (m-group, n-tile), zero before and after the
// launch.
template <int BN, int G>
__global__ void __launch_bounds__(THREADS, HpPlan<BN, G>::per_sm)
fp4_hp_stream_kernel(const float* __restrict__ A, const uint32_t* __restrict__ W,
                     const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                     float* __restrict__ C, float* __restrict__ ws, int* __restrict__ counters,
                     int M, int N, int K, int KP, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
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

  hp_stream<BN, G>(smem, A, W, S, M, N, K, KP, m0, n0, split * steps / splits,
                   (split + 1) * steps / splits, acc);

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
  hp_stream_store<BN, G>(acc, *gs, C, M, N, m0, n0);
}

template <int BN, int G>
cudaError_t launch_stream(const void* a, const void* w, const void* s, const void* gs,
                          void* out, void* ws, void* counters, int m, int n, int k, int kp,
                          int splits, cudaStream_t stream) {
  using P = HpPlan<BN, G>;
  cudaError_t err = cudaFuncSetAttribute(fp4_hp_stream_kernel<BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fp4_hp_stream_kernel<BN, G>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN * splits, (m + SBM * G - 1) / (SBM * G));
  fp4_hp_stream_kernel<BN, G><<<grid, THREADS, P::bytes, stream>>>(
      static_cast<const float*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(counters), m, n, k,
      kp, splits);
  return cudaGetLastError();
}

// ---- the 64-row tiles: the wgmma body ---------------------------------------

// G m-tiles of 64 rows of one n-tile a CTA, one warpgroup each
template <int BN, int G>
__global__ void __launch_bounds__(THREADS * G, 1)
fp4_hp_wgmma_kernel(const float* __restrict__ A, const uint32_t* __restrict__ W,
                    const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                    float* __restrict__ C, int M, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  fp4_hp_wgmma_tile<BN, G>(smem, A, W, S, gs, C, M, N, K, KP, blockIdx.y * (G * WG_BM),
                           blockIdx.x * BN);
}

template <int BN, int G>
cudaError_t launch_wgmma(const void* a, const void* w, const void* s, const void* gs,
                         void* out, int m, int n, int k, int kp, cudaStream_t stream) {
  using P = HpWgPlan<BN, G>;
  cudaError_t err = cudaFuncSetAttribute(fp4_hp_wgmma_kernel<BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + G * WG_BM - 1) / (G * WG_BM));
  fp4_hp_wgmma_kernel<BN, G><<<grid, P::threads, P::bytes, stream>>>(
      static_cast<const float*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<float*>(out), m, n, k, kp);
  return cudaGetLastError();
}

// The tiles this file compiles (ops/solution.py TILE_SHAPES; a CPU test
// holds the two lists equal).
template <int G>
int dispatch(const void* a, const void* w, const void* s, const void* gs, void* out, void* ws,
             void* counters, int m, int n, int k, int kp, int block_m, int block_n, int splits,
             void* stream) {
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
// (pk_fp4_gemm_hp) or HP_WC_GROUP (pk_fp4_gemm_hp_wc), both needed only
// where splits > 1 (block_m = 16 only).
extern "C" int pk_fp4_gemm_hp(const void* a, const void* w, const void* s, const void* gs,
                              void* out, void* ws, void* counters, int m, int n, int k, int kp,
                              int block_m, int block_n, int splits, void* stream) {
  return dispatch<1>(a, w, s, gs, out, ws, counters, m, n, k, kp, block_m, block_n, splits,
                     stream);
}

extern "C" int pk_fp4_gemm_hp_wc(const void* a, const void* w, const void* s,
                                 const void* gs, void* out, void* ws, void* counters, int m,
                                 int n, int k, int kp, int block_m, int block_n, int splits,
                                 void* stream) {
  return dispatch<HP_WC_GROUP>(a, w, s, gs, out, ws, counters, m, n, k, kp, block_m, block_n,
                               splits, stream);
}
