// The hybrid GEMM's dense prefill tile body for Hopper (sm_90a):
//     C[m, n] = bf16(A[m, :] @ WD[:, n])
// for the (64, BN) output tile of one CTA: the dense half of
// petit_kernel_tpu/ops/kernels/hybrid.py:34 _hybrid_kernel (:48-51), whose
// FP4 half hybrid_gemm.cu's other CTAs run (fp4_wgmma.cuh). A (m, k) bf16
// in natural k order; WD (kp, nd) bf16 as stored, natural k order with
// rows past k zero (the decode tiles read it so too).
//
// What bounds it: the copies into shared memory, then the tensor cores.
// The dense quarter of the seven unfused Llama-3-8B projections at m = 512
// is 5.58e10 operations, 0.0565 ms at 989 TFLOP/s; its bytes (WD 109 MB, A
// 40 MB, C 11 MB) take 0.048 ms at 3.35 TB/s, but a (64, BN) tile reads
// 64 + BN rows of 128 bytes for every 64 k it multiplies, so each WD block
// is read again by every 64-row m-tile, from L2. With 16-byte cp.async
// copies (128 threads, 12 pieces a stage each) one CTA pulled about 48
// GB/s from L2 however deep its ring, and the copies alone took 90% of the
// time. What the design does:
//   - one warpgroup a tile: wgmma.mma_async m64nBNk16 bf16, f32
//     accumulators in registers, both operands from shared memory;
//   - a stage is 64 natural k, copied by the tensor memory accelerator:
//     one thread asks for a 64 x 64 box of A (64 rows of 128 bytes) and
//     BN / 64 boxes of WD (64 k rows of 64 columns each) with the 128-byte
//     swizzle, zero past the tensor maps' edges (M, N), and the stage's
//     mbarrier counts the bytes in. A lands K-major (sw128_desc); WD's rows
//     land as they are stored, MN-major, chunk c of row k at chunk c ^
//     (k & 7), and are read through the transpose bit of B (wgmma.cuh:
//     sw128_mn_desc, wgmma_bf16_tb), so WD needs no transposed copy in
//     memory or in shared memory. The copies and the wgmmas both run in
//     the async proxy: no proxy fence;
//   - a ring of DW_STAGES slots, DW_AHEAD stages in flight past the one
//     read, one wgmma group left in flight: stage i + DW_AHEAD is asked for
//     after stage i's wgmmas are issued and every warp has waited for
//     stage i - 1's (one barrier a stage), into the slot stage i - 1 read;
//   - the k loop stops at K: WD's rows past it are zero and add nothing.
//     Each output element sums its k in natural order, 16 at a time;
//   - the plan, mbarriers included, fits inside the FP4 CTAs' shared memory
//     at the same BN, so the hybrid launch keeps two blocks an SM at BN =
//     128, three at 64 (hybrid_gemm.cu asserts it).
// The launcher encodes the two tensor maps on the host (hybrid_gemm.cu:
// encode_map) and passes them as __grid_constant__ parameters.

#pragma once

#include <cuda.h>

#include "fp4_wgmma.cuh"

namespace {

constexpr int DW_DK = 64;                    // natural k a stage: one 64 x 64 box of A
constexpr int DW_BOX = 64;                   // rows and columns of a box (128-byte rows)
constexpr int DW_STAGES = 4;                 // ring slots
constexpr int DW_AHEAD = DW_STAGES - 1;      // stages in flight past the one read

// shared-memory plan of dense_wgmma_tile<BN>: each slot A [64][128 bytes],
// then BN / 64 blocks of B [DW_DK][128 bytes], all 1024-byte aligned; then
// one mbarrier a slot
template <int BN>
struct DwPlan {
  static constexpr int a_bytes = WG_BM * WG_ROW;     // 8 KB
  static constexpr int b_block = DW_DK * WG_ROW;     // one 64-column block: the LBO
  static constexpr int stage = a_bytes + BN / DW_BOX * b_block;
  static constexpr int bytes = DW_STAGES * stage + DW_STAGES * 8 + 1024;   // + alignment
};

template <int BN>
__host__ __device__ constexpr int dense_wgmma_smem_bytes() { return DwPlan<BN>::bytes; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the one arrival of the barrier's phase, and the bytes it waits for
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a copy that never
// lands traps after about 2^24 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls >= (1u << 24)) __trap();
  }
}

// the box at (x, y) (x the inner, contiguous coordinate) of `map` into
// `dst`, its bytes counted on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// ask for natural k k0 .. k0 + 63 into the slot `st`: A rows m0 .. m0 + 63
// (map_a: (M, K)) and WD rows k0 .., columns n0 .. n0 + BN - 1 (map_wd:
// (KP, N)), one box a 64-column block
template <int BN>
__device__ __forceinline__ void dw_stage(unsigned char* st, uint64_t* bar,
                                         const CUtensorMap* map_a, const CUtensorMap* map_wd,
                                         int m0, int n0, int k0) {
  using P = DwPlan<BN>;
  mbar_expect_bytes(bar, P::stage);
  tma_box(st, map_a, k0, m0, bar);
#pragma unroll
  for (int j = 0; j < BN / DW_BOX; ++j)
    tma_box(st + P::a_bytes + j * P::b_block, map_wd, n0 + DW_BOX * j, k0, bar);
}

// The tile (m0, n0) of C (M, N) = bf16(A @ WD[:K]), by one warpgroup
// (THREADS threads) with dense_wgmma_smem_bytes<BN>() bytes of dynamic
// shared memory at `smem`; map_a and map_wd as encode_map makes them;
// K % 128 == 0.
template <int BN>
__device__ __forceinline__ void dense_wgmma_tile(unsigned char* smem, const CUtensorMap* map_a,
                                                 const CUtensorMap* map_wd,
                                                 __nv_bfloat16* __restrict__ C, int M, int N,
                                                 int K, int m0, int n0) {
  using P = DwPlan<BN>;
  static_assert(BN == 64 || BN == 128, "BN");
  const uint32_t base = smem_addr(smem);
  unsigned char* ring = smem + ((1024u - (base & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + DW_STAGES * P::stage);
  const bool leader = threadIdx.x == 0;
  const int n = K / DW_DK;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  if (leader) {
#pragma unroll
    for (int s = 0; s < DW_STAGES; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (leader) {
#pragma unroll
    for (int s = 0; s < DW_AHEAD; ++s)
      if (s < n) dw_stage<BN>(ring + s * P::stage, bars + s, map_a, map_wd, m0, n0, s * DW_DK);
  }
  for (int i = 0; i < n; ++i) {
    const int slot = i % DW_STAGES;
    mbar_wait(bars + slot, (i / DW_STAGES) & 1);   // stage i has landed
    unsigned char* st = ring + slot * P::stage;
    const uint64_t desc_a = sw128_desc(st);
    const uint64_t desc_b = sw128_mn_desc<P::b_block>(st + P::a_bytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < DW_DK / 16; ++q)   // 16 k: A 32 bytes along its rows, B two atoms on
      wgmma_bf16_tb(acc, desc_a + (32 >> 4) * q, desc_b + (2048 >> 4) * q);
    wgmma_commit();
    wgmma_wait<1>();                 // this warp is past wgmma(i - 1)
    fence_acc(acc);
    __syncthreads();                 // every warp is
    const int nx = i + DW_AHEAD;     // into the slot stage i - 1 read
    if (leader && nx < n)
      dw_stage<BN>(ring + (nx % DW_STAGES) * P::stage, bars + nx % DW_STAGES, map_a, map_wd,
                   m0, n0, nx * DW_DK);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: bf16(acc). acc[4i + e] of warp w, lane l: row 16w + l/4 (+ 8
  // for e >= 2), column 8i + 2(l % 4) + (e & 1)
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row = m0 + 16 * w + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    if (col >= N) continue;
    if (row < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
          __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    if (row + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

}  // namespace
