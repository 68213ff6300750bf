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
// x axis spans ceil(nf/BN) FP4 tiles, then ceil(nd/BN) dense tiles, and the
// card runs them side by side. Both read the same A, which stays in L2.
//
// Operands: W (kp/8, nf) words and S (kp/16, nf) bf16 scales in
// fp4_gemm.cuh's layout; WD (kp, nd) bf16 in NATURAL k order (rows past k
// are zero), not the TPU's pi-permuted order, since A is read in natural k;
// A (m, k) bf16; gs one f32 in device memory.
//
// FP4 CTAs run fp4_gemm_tile<BM, BN, 1> unchanged, so CF equals fused_mul's
// output at the same (block_m, block_n) bit for bit. Dense CTAs stage the
// same A rows as that tile does, copy a (256, BN) block of WD rows into a
// k-major shared tile in 16-byte pieces, read B fragments with
// ldmatrix.trans and run mma.sync m16n8k16 bf16 with f32 sums; their
// epilogue is bf16(acc), with no gs.
//
// What bounds it: at decode the weight stream, 0.625 bytes per FP4 weight
// and 2 per dense weight (for Llama-3-8B's 3:1 split, 211 MB a layer
// against nvfp4's 136 MB); at prefill the tensor cores. This first version
// is simple, like fp4_gemm.cuh: no cp.async pipeline, TMA or wgmma.

#include "fp4_gemm.cuh"

namespace {

// dense tile: k-major B rows of BN + DENSE_PAD bf16 (16 bytes of padding
// put the eight rows of an ldmatrix four banks apart: no bank conflicts)
constexpr int DENSE_PAD = 8;

template <int BM, int BN>
constexpr int dense_smem_bytes() {
  return BM * LDS * 2 + KSTEP * (BN + DENSE_PAD) * 2;
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// The (BM, BN) tile at (m0, n0) of C = bf16(A @ WD), WD (KP, N) row-major;
// four warps laid out over the tile as in fp4_gemm_tile<BM, BN, 1>.
template <int BM, int BN>
__device__ __forceinline__ void dense_gemm_tile(unsigned char* smem,
                                                const __nv_bfloat16* __restrict__ A,
                                                const __nv_bfloat16* __restrict__ WD,
                                                __nv_bfloat16* __restrict__ C, int M, int N,
                                                int K, int KP, int m0, int n0) {
  constexpr int WM = (BM == 16) ? 1 : 2;
  constexpr int WN = 4 / WM;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int LDB = BN + DENSE_PAD;
  constexpr int RUNS = BN / 8;   // 16-byte pieces of a WD row in the tile
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "tile");

  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][LDS], natural k
  __nv_bfloat16* Bs = As + BM * LDS;                             // [KSTEP][LDB], k-major

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, tg = lane & 3;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KSTEP) {
    // A: BM rows x 32 runs of 8 contiguous natural k (zero past K and M)
    for (int e = tid; e < BM * 32; e += THREADS) {
      const int m = e >> 5, run = e & 31;
      const int kn = k0 + run * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < M && kn < K)
        v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + kn);
      *reinterpret_cast<uint4*>(As + m * LDS + run * 8) = v;
    }
    // B: KSTEP rows of WD x RUNS pieces of 8 columns (N % 8 == 0)
    for (int e = tid; e < KSTEP * RUNS; e += THREADS) {
      const int kk = e / RUNS, nn = (e % RUNS) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < KP && n0 + nn < N)
        v = *reinterpret_cast<const uint4*>(WD + (size_t)(k0 + kk) * N + n0 + nn);
      *reinterpret_cast<uint4*>(Bs + kk * LDB + nn) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = As + (wm * WTM + i * 16 + g) * LDS + kk * 16 + tg * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ldmatrix_x2_trans(bfr[j], Bs + (kk * 16 + (lane & 15)) * LDB + wn * WTN + j * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wm * WTM + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + tg * 2;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
}

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
hybrid_gemm_kernel(const __nv_bfloat16* __restrict__ A, const uint32_t* __restrict__ W,
                   const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs,
                   const __nv_bfloat16* __restrict__ WD, __nv_bfloat16* __restrict__ CF,
                   __nv_bfloat16* __restrict__ CD, int M, int NF, int ND, int K, int KP,
                   int f_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM;
  if (static_cast<int>(blockIdx.x) < f_tiles)
    fp4_gemm_tile<BM, BN, 1>(smem, A, W, S, gs, CF, M, NF, K, KP, m0, blockIdx.x * BN);
  else
    dense_gemm_tile<BM, BN>(smem, A, WD, CD, M, ND, K, KP, m0,
                            (static_cast<int>(blockIdx.x) - f_tiles) * BN);
}

template <int BM, int BN>
cudaError_t launch(const void* a, const void* w, const void* s, const void* gs,
                   const void* wd, void* outf, void* outd, int m, int nf, int nd, int k,
                   int kp, cudaStream_t stream) {
  static_assert(dense_smem_bytes<BM, BN>() <= smem_bytes<BM, BN, 1>(), "smem");
  constexpr int bytes = smem_bytes<BM, BN, 1>();
  cudaError_t err = cudaFuncSetAttribute(hybrid_gemm_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int f_tiles = (nf + BN - 1) / BN, d_tiles = (nd + BN - 1) / BN;
  dim3 grid(f_tiles + d_tiles, (m + BM - 1) / BM);
  hybrid_gemm_kernel<BM, BN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(gs),
      static_cast<const __nv_bfloat16*>(wd), static_cast<__nv_bfloat16*>(outf),
      static_cast<__nv_bfloat16*>(outd), m, nf, nd, k, kp, f_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pk_hybrid_gemm(const void* a, const void* w, const void* s, const void* gs,
                              const void* wd, void* outf, void* outd, int m, int nf, int nd,
                              int k, int kp, int block_m, int block_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || kp % KSTEP != 0 || k > kp || k % 128 != 0 || nf % 16 != 0 ||
      nd % 16 != 0 || nf + nd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (block_m == 16 && block_n == 64)
    err = launch<16, 64>(a, w, s, gs, wd, outf, outd, m, nf, nd, k, kp, st);
  else if (block_m == 16 && block_n == 128)
    err = launch<16, 128>(a, w, s, gs, wd, outf, outd, m, nf, nd, k, kp, st);
  else if (block_m == 64 && block_n == 64)
    err = launch<64, 64>(a, w, s, gs, wd, outf, outd, m, nf, nd, k, kp, st);
  else if (block_m == 64 && block_n == 128)
    err = launch<64, 128>(a, w, s, gs, wd, outf, outd, m, nf, nd, k, kp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
