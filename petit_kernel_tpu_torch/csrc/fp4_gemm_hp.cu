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
// weight is exact in f32, and three mma.sync m16n8k16 bf16 MMAs per fragment
// (lo, then mid, then hi, small parts first) add them into fresh f32
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
// The 64-row tiles run fp4_gemm_hp_tile below, the first FP4 tile body's
// loop: each step stages A and the scales, decodes the words into a bf16 B
// tile in shared memory and runs mma.sync on it, with no cp.async pipeline,
// TMA or wgmma. A is staged as f32, LDS floats a row, and split as fragments
// load, so the budget is hp_smem_bytes below. Its weight cache runs
// HP_WC_GROUP = 2 consecutive m-tiles per CTA (4, as the bf16 cache kernel
// runs, would ask for 270,336 bytes at block_m = 64, over the 232,448 a
// Hopper block may use). Both bodies give every output element the same MMA
// sequence whatever the m-tiles a CTA, so each weight cache agrees with its
// plain tile bit for bit (the 16-row tiles at the same split count). What
// bounds the 64-row tiles: the tensor cores, three passes, and the serial
// copies.

#include "fp4_stream.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a Hopper block may use

template <int BM, int BN, int G>
constexpr int hp_smem_bytes() {
  return G * BM * LDS * 4 + BN * LDS * 2 + WROWS * BN * 4;
}

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

// ---- the 64-row tiles ----------------------------------------------------------

// The G tiles (m0 + i*BM, n0), i < G, run by one CTA of THREADS*G threads
// with hp_smem_bytes<BM, BN, G>() of dynamic shared memory at `smem`; warps
// 4i..4i+3 own m-tile i, a 2 x 2 grid of warps over its 64 rows.
template <int BM, int BN, int G>
__device__ __forceinline__ void fp4_gemm_hp_tile(
    unsigned char* smem, const float* __restrict__ A, const uint32_t* __restrict__ W,
    const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
    float* __restrict__ C, int M, int N, int K, int KP, int m0, int n0) {
  static_assert(BM == 64, "the 16-row tiles run fp4_hp_stream_kernel");
  constexpr int NTH = THREADS * G;
  constexpr int WM = 2;                    // warps along m
  constexpr int WN = 4 / WM;               // warps along n
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "tile");

  float* As = reinterpret_cast<float*>(smem);                            // [G*BM][LDS] f32
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(As + G * BM * LDS);  // [BN][LDS]
  float* Ss = reinterpret_cast<float*>(Bs + BN * LDS);                   // [32][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wq = warp & 3;
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
    // A: G*BM rows x 32 runs (run = j*8 + a) of 8 contiguous natural k, each
    // run two 16-byte words of f32
    for (int e = tid; e < G * BM * 64; e += NTH) {
      const int m = e >> 6, run = (e >> 1) & 31, q = e & 1;
      const int kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8 + q * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + m < M && kn < K)
        v = *reinterpret_cast<const float4*>(A + (size_t)(m0 + m) * K + kn);
      *reinterpret_cast<float4*>(As + m * LDS + run * 8 + q * 4) = v;
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
    // B: decode 32 word rows x BN columns into Bs[n][L] (local k order)
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
      uint32_t ahi[MT][4], amid[MT][4], alo[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = As + (wrow + i * 16 + g) * LDS + kk * 16 + tg * 2;
        split3(*reinterpret_cast<const float2*>(p), ahi[i][0], amid[i][0], alo[i][0]);
        split3(*reinterpret_cast<const float2*>(p + 8 * LDS), ahi[i][1], amid[i][1],
               alo[i][1]);
        split3(*reinterpret_cast<const float2*>(p + 8), ahi[i][2], amid[i][2], alo[i][2]);
        split3(*reinterpret_cast<const float2*>(p + 8 * LDS + 8), ahi[i][3], amid[i][3],
               alo[i][3]);
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
        for (int j = 0; j < NT; ++j) {
          // the 16-deep chunk in fresh accumulators, then one rounded add:
          // the MMA's own accumulation truncates, and over k / 16 chunks
          // that bias would outgrow an f32 sum's error
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, alo[i], bfr[j]);
          mma_bf16(part, amid[i], bfr[j]);
          mma_bf16(part, ahi[i], bfr[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[e]);
        }
    }
    __syncthreads();
  }

  // epilogue: f32(acc * gs), the TPU kernel's order (fused.py:254-256)
  const float s = *gs;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wrow + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + tg * 2;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<float2*>(C + (size_t)row * N + col) =
            make_float2(acc[i][j][0] * s, acc[i][j][1] * s);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(C + (size_t)(row + 8) * N + col) =
            make_float2(acc[i][j][2] * s, acc[i][j][3] * s);
    }
}

template <int BM, int BN, int G>
__global__ void __launch_bounds__(THREADS * G)
fp4_gemm_hp_kernel(const float* __restrict__ A, const uint32_t* __restrict__ W,
                   const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                   float* __restrict__ C, int M, int N, int K, int KP) {
  extern __shared__ __align__(16) unsigned char smem[];
  fp4_gemm_hp_tile<BM, BN, G>(smem, A, W, S, gs, C, M, N, K, KP, blockIdx.y * (G * BM),
                              blockIdx.x * BN);
}

template <int BM, int BN, int G>
cudaError_t launch(const void* a, const void* w, const void* s, const void* gs, void* out,
                   int m, int n, int k, int kp, cudaStream_t stream) {
  constexpr int bytes = hp_smem_bytes<BM, BN, G>();
  static_assert(bytes <= MAX_SMEM, "tile exceeds the shared memory of a block");
  cudaError_t err = cudaFuncSetAttribute(fp4_gemm_hp_kernel<BM, BN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + G * BM - 1) / (G * BM));
  fp4_gemm_hp_kernel<BM, BN, G><<<grid, THREADS * G, bytes, stream>>>(
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
    err = launch<64, 64, G>(a, w, s, gs, out, m, n, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch<64, 128, G>(a, w, s, gs, out, m, n, k, kp, st);
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
