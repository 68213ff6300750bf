// Hybrid FP4 + BF16 GEMM for Hopper (sm_90a): one weight matrix split by
// columns into FP4 columns and dense bf16 columns, both products in one
// launch:
//     CF[m, nf] = bf16((A[m, :] @ dequant(W, S)[:, nf]) * gs)
//     CD[m, nd] = bf16(A[m, :] @ WD[:, nd])
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/hybrid.py:
// _hybrid_kernel (reached through hybrid_mul), which runs both halves in
// each grid step so that the TPU's DMA-bound dense stream and VPU-bound FP4
// decode overlap. Here the two halves are different CTAs of one grid: the
// x axis spans the FP4 tiles, then the dense tiles, and the card runs them
// side by side. Both read the same A, which stays in L2.
//
// Operands: W (kp/8, nf) words and S (kp/16, nf) bf16 scales in
// fp4_gemm.cuh's layout; WD (kp, nd) bf16 in NATURAL k order (rows past k
// are zero), not the TPU's pi-permuted order, since A is read in natural k;
// A (m, k) bf16; gs one f32 in device memory.
//
// What bounds it: at decode the weight stream, 0.625 bytes per FP4 weight
// and 2 per dense weight (for Llama-3-8B's 3:1 split, 211 MB a layer
// against nvfp4's 136 MB); at prefill the tensor cores.
//
// Decode tiles (block_m = 16): hybrid_stream_kernel. Each output tile's k
// range is cut into splits_f (FP4) or splits_d (dense) CTAs of whole
// 256-deep steps, so that the small projections fill the card; partial
// sums meet through fp4_stream.cuh's reduce_splits, in split order. FP4
// CTAs run fp4_stream.cuh (cp.async ring, FP4 decoded into the MMA
// fragments); with one split their output equals fused_mul's at the same
// tile bit for bit. Dense CTAs stream (DK, BN) blocks of WD rows and the
// matching A columns through the same ring and read B fragments with
// ldmatrix.trans. One launch serves both kinds: each stage slot holds the
// larger of their two stages, and a CTA keeps under 113 KB of shared
// memory so that two fit on an SM.
//
// Prefill tiles (block_m = 64): hybrid_gemm_kernel, one CTA per output
// tile, one warpgroup each. FP4 CTAs run fp4_wgmma.cuh's wgmma body,
// fp4_wgmma_tile<BN, 1>, so CF equals fused_mul's output bit for bit;
// dense CTAs run dense_wgmma.cuh's, dense_wgmma_tile<BN>: bf16 wgmma with
// A K-major and WD's rows copied as they are stored into MN-major
// 128-byte-swizzled blocks read through B's transpose bit, in a 4-slot
// ring that the tensor memory accelerator fills (two tensor maps, encoded
// here on the host for each launch). What bounds the FP4 CTAs is their
// decode; what bounds the dense ones, which hold a quarter of the
// operations, is how fast a CTA can pull its operands from L2, which the
// TMA copies raise over 16-byte cp.async copies. The grid puts the FP4
// tiles first in x, so the heavier CTAs start first, and the launch's
// shared memory is the FP4 body's, which the dense plan never exceeds:
// two blocks an SM at BN = 128, three at 64.

#include "dense_wgmma.cuh"

namespace {

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
hybrid_gemm_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                   const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                   const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_wd, __nv_bfloat16* __restrict__ CF,
                   __nv_bfloat16* __restrict__ CD, int M, int NF, int ND, int K, int KP,
                   int f_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(BM == WG_BM, "prefill tiles only");
  const int m0 = blockIdx.y * BM;
  if (static_cast<int>(blockIdx.x) < f_tiles)
    fp4_wgmma_tile<BN, 1>(smem, A, W, S, gs, CF, M, NF, K, KP, m0, blockIdx.x * BN);
  else
    dense_wgmma_tile<BN>(smem, &map_a, &map_wd, CD, M, ND, K, m0,
                         (static_cast<int>(blockIdx.x) - f_tiles) * BN);
}

// the tensor map of a (rows, cols) row-major bf16 matrix at `base` for
// dense_wgmma.cuh: 64 x 64 boxes with the 128-byte swizzle, zeros past
// the edges. The driver's encoder comes through the runtime, so the
// library links no driver library.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
cudaError_t encode_map(CUtensorMap* map, const void* base, int rows, int cols) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {DW_BOX, DW_BOX}, unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, row_bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM, int BN>
cudaError_t launch(const void* a, const void* w, const void* s, const void* gs,
                   const void* wd, void* outf, void* outd, int m, int nf, int nd, int k,
                   int kp, cudaStream_t stream) {
  static_assert(fp4_wgmma_threads<BN, 1>() == THREADS, "threads");
  // the FP4 body's budget, which the dense plan never raises
  constexpr int bytes = fp4_wgmma_smem_bytes<BN, 1>();
  static_assert(dense_wgmma_smem_bytes<BN>() <= bytes, "the dense plan raises the launch's smem");
  CUtensorMap map_a{}, map_wd{};
  cudaError_t err;
  if (nd > 0 && ((err = encode_map(&map_a, a, m, k)) != cudaSuccess ||
                 (err = encode_map(&map_wd, wd, kp, nd)) != cudaSuccess))
    return err;
  err = cudaFuncSetAttribute(hybrid_gemm_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int f_tiles = (nf + BN - 1) / BN, d_tiles = (nd + BN - 1) / BN;
  dim3 grid(f_tiles + d_tiles, (m + BM - 1) / BM);
  hybrid_gemm_kernel<BM, BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs), map_a, map_wd,
      static_cast<__nv_bfloat16*>(outf), static_cast<__nv_bfloat16*>(outd), m, nf, nd, k, kp,
      f_tiles);
  return cudaGetLastError();
}

// ---- decode tiles: the split-k stream --------------------------------------

// natural k of a dense stage: its WD block ((DK, BN) bf16) is 16 KB at
// either width
template <int BN>
__host__ __device__ constexpr int dense_depth() { return BN == 64 ? 128 : 64; }

// dense stage: A [SBM][DK + 8] bf16 (natural k), WD rows [DK][BN] whose
// 16-byte chunks are swizzled (dense_chunk), so that the block needs no
// padding
template <int BN>
__host__ __device__ constexpr int dense_stage_bytes() {
  return SBM * (dense_depth<BN>() + 8) * 2 + dense_depth<BN>() * BN * 2;
}

// physical chunk of WD chunk c (8 columns) in stage row kk: the eight rows
// of an ldmatrix land in eight different bank groups
__device__ __forceinline__ int dense_chunk(int kk, int c) { return c ^ (kk & 7); }

// one ring slot: the larger of the two kinds' stages, in 128-byte units
template <int BN>
__host__ __device__ constexpr int stream_slot_bytes() {
  constexpr int b = fp4_stage_bytes<BN>() > dense_stage_bytes<BN>() ? fp4_stage_bytes<BN>()
                                                                    : dense_stage_bytes<BN>();
  return (b + 127) / 128 * 128;
}

// the ring: fp4_stream.cuh's depth, stream_stages, in slots of either kind
template <int BN>
__host__ __device__ constexpr int hybrid_smem_bytes() {
  return stream_stages<BN>() * stream_slot_bytes<BN>();
}

// two CTAs an SM: 2 * (bytes + 1 KB reserved) <= 228 KB
static_assert(hybrid_smem_bytes<64>() <= 113 * 1024, "smem (16, 64)");
static_assert(hybrid_smem_bytes<128>() <= 113 * 1024, "smem (16, 128)");

// cp.async natural k [k0, k0 + DK) of A rows m0.. and WD rows k0.., columns
// n0.., into `st`
template <int BN>
__device__ __forceinline__ void dense_stage_load(unsigned char* st,
                                                 const __nv_bfloat16* __restrict__ A,
                                                 const __nv_bfloat16* __restrict__ WD, int M,
                                                 int N, int K, int m0, int n0, int k0) {
  constexpr int DK = dense_depth<BN>(), LDA = DK + 8;
  constexpr int AR = DK / 8, BR = BN / 8;   // 16-byte pieces of an A / WD row
  static_assert((SBM * AR) % THREADS == 0 && (DK * BR) % THREADS == 0, "pieces per thread");
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(st);
  __nv_bfloat16* Bs = As + SBM * LDA;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < SBM * AR / THREADS; ++i) {
    const int e = tid + i * THREADS, m = e / AR, run = e % AR;
    const int kn = k0 + run * 8;   // < K: K % 128 == 0 and k0 + DK <= K
    if (m0 + m < M) cp_async16(As + m * LDA + run * 8, A + (size_t)(m0 + m) * K + kn, true);
  }
  // rows k0 .. k0 + DK - 1 < K <= KP: never past WD's rows
#pragma unroll
  for (int i = 0; i < DK * BR / THREADS; ++i) {
    const int e = tid + i * THREADS, kk = e / BR, cc = e % BR;
    const bool ok = n0 + cc * 8 < N;
    cp_async16(Bs + kk * BN + dense_chunk(kk, cc) * 8,
               ok ? WD + (size_t)(k0 + kk) * N + n0 + cc * 8 : WD, ok);
  }
}

// the MMAs of one dense stage: warp wn owns columns wn*BN/4 .. in NT slices
// of 8 (natural order)
template <int BN>
__device__ __forceinline__ void dense_stage_mma(const unsigned char* st,
                                                float (&acc)[BN / 32][4]) {
  constexpr int DK = dense_depth<BN>(), LDA = DK + 8;
  constexpr int NT = BN / 32;
  const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(st);
  const __nv_bfloat16* Bs = As + SBM * LDA;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int brow = lane & 15;                          // + 16kk: (brow + 16kk) & 7 == brow & 7
  const int bchunk = wn * (BN / 32) + (lane >> 4);     // + 2jp: slices 2jp (lanes < 16), 2jp + 1
  const __nv_bfloat16* a_ptr = As + (lane & 15) * LDA + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_ptr + kk * 16);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];   // slices 2jp and 2jp + 1
      ldmatrix_x4_trans(b, Bs + (kk * 16 + brow) * BN + dense_chunk(brow, bchunk + 2 * jp) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[2 * jp], a, b0);
      mma_bf16(acc[2 * jp + 1], a, b1);
    }
  }
}

// natural k [k_begin, k_end) of the dense tile at (m0, n0) into acc
template <int BN>
__device__ __forceinline__ void dense_stream(unsigned char* smem, int stage_bytes,
                                             const __nv_bfloat16* __restrict__ A,
                                             const __nv_bfloat16* __restrict__ WD, int M,
                                             int N, int K, int m0, int n0, int k_begin,
                                             int k_end, float (&acc)[BN / 32][4]) {
  constexpr int STAGES = stream_stages<BN>(), DK = dense_depth<BN>();
  const int n = k_end > k_begin ? (k_end - k_begin) / DK : 0;
  zero_rows(smem, stage_bytes, STAGES, M - m0, (DK + 8) * 2);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n)
      dense_stage_load<BN>(smem + i * stage_bytes, A, WD, M, N, K, m0, n0, k_begin + i * DK);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < n)
      dense_stage_load<BN>(smem + (nx % STAGES) * stage_bytes, A, WD, M, N, K, m0, n0,
                           k_begin + nx * DK);
    cp_async_commit();
    dense_stage_mma<BN>(smem + (i % STAGES) * stage_bytes, acc);
  }
}

// grid (f_tiles*sf + d_tiles*sd, ceil(M / 16)); x = FP4 tiles (tile-major,
// split-minor), then dense tiles. ws: [ceil(M/16)][gridDim.x] blocks of
// 16*BN floats (read only where a kind has more than one split); counters:
// one int per (m-tile, tile), zero before and after the launch.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
hybrid_stream_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                     const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                     const __nv_bfloat16* __restrict__ WD, __nv_bfloat16* __restrict__ CF,
                     __nv_bfloat16* __restrict__ CD, float* __restrict__ ws,
                     int* __restrict__ counters, int M, int NF, int ND, int K, int KP,
                     int f_tiles, int d_tiles, int sf, int sd) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int NT = BN / 32, SLOT = stream_slot_bytes<BN>();
  const int x = blockIdx.x, mt = blockIdx.y, m0 = mt * SBM;
  const bool fp4 = x < f_tiles * sf;
  const int splits = fp4 ? sf : sd;
  const int local = fp4 ? x : x - f_tiles * sf;
  const int tile = local / splits, split = local % splits;
  const int steps = KP / KSTEP;
  const int s_begin = split * steps / splits, s_end = (split + 1) * steps / splits;
  const int n0 = tile * BN;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (fp4)
    fp4_stream<BN, stream_stages<BN>()>(smem, SLOT, A, W, S, M, NF, K, KP, m0, n0, s_begin,
                                        s_end, acc);
  else
    dense_stream<BN>(smem, SLOT, A, WD, M, ND, K, m0, n0, s_begin * KSTEP,
                     min(s_end * KSTEP, K), acc);

  const int g = (threadIdx.x & 31) >> 2;
  const bool row_ok[2] = {m0 + g < M, m0 + g + 8 < M};
  float* ws_tile = ws + ((size_t)mt * gridDim.x + (x - split)) * (SBM * BN);
  int* counter = counters + mt * (f_tiles + d_tiles) + (fp4 ? tile : f_tiles + tile);
  if (!reduce_splits<NT>(acc, ws_tile, splits, split, counter, row_ok, last)) return;

  if (fp4) {
    fp4_stream_store<BN>(acc, *gs, CF, M, NF, m0, n0);
    return;
  }
  // dense: bf16(acc), slices in natural column order
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * (BN / 4) + j * 8 + tg * 2;
    if (col >= ND) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row_ok[h])
        *reinterpret_cast<__nv_bfloat162*>(CD + (size_t)(m0 + g + 8 * h) * ND + col) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int BN>
cudaError_t launch_stream(const void* a, const void* w, const void* s, const void* gs,
                          const void* wd, void* outf, void* outd, void* ws, void* counters,
                          int m, int nf, int nd, int k, int kp, int sf, int sd,
                          cudaStream_t stream) {
  constexpr int bytes = hybrid_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(hybrid_stream_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hybrid_stream_kernel<BN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int f_tiles = (nf + BN - 1) / BN, d_tiles = (nd + BN - 1) / BN;
  dim3 grid(f_tiles * sf + d_tiles * sd, (m + SBM - 1) / SBM);
  hybrid_stream_kernel<BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<const __nv_bfloat16*>(wd), static_cast<__nv_bfloat16*>(outf),
      static_cast<__nv_bfloat16*>(outd), static_cast<float*>(ws), static_cast<int*>(counters),
      m, nf, nd, k, kp, f_tiles, d_tiles, sf, sd);
  return cudaGetLastError();
}

}  // namespace

// ws: (ceil(m/16) * (ceil(nf/bn)*splits_f + ceil(nd/bn)*splits_d) * 16 * bn)
// f32 and counters: (ceil(m/16) * (ceil(nf/bn) + ceil(nd/bn))) int32 zeros,
// both needed only where a split count is above 1 (block_m = 16 only).
extern "C" int pk_hybrid_gemm(const void* a, const void* w, const void* s, const void* gs,
                              const void* wd, void* outf, void* outd, void* ws,
                              void* counters, int m, int nf, int nd, int k, int kp,
                              int block_m, int block_n, int splits_f, int splits_d,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = kp / KSTEP;
  if (m <= 0 || kp % KSTEP != 0 || k > kp || k % 128 != 0 || nf % 16 != 0 ||
      nd % 16 != 0 || nf + nd <= 0 || splits_f < 1 || splits_d < 1 || splits_f > steps ||
      splits_d > steps || (block_m != 16 && (splits_f != 1 || splits_d != 1)) ||
      ((splits_f > 1 || splits_d > 1) && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch_stream<64>(a, w, s, gs, wd, outf, outd, ws, counters, m, nf, nd, k, kp,
                            splits_f, splits_d, st);
  else if (block_m == 16 && block_n == 128)
    err = launch_stream<128>(a, w, s, gs, wd, outf, outd, ws, counters, m, nf, nd, k, kp,
                             splits_f, splits_d, st);
  else if (block_m == 64 && block_n == 64)
    err = launch<64, 64>(a, w, s, gs, wd, outf, outd, m, nf, nd, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch<64, 128>(a, w, s, gs, wd, outf, outd, m, nf, nd, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
