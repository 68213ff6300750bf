// The FP4 packed layout, its decode and the constants shared by the FP4
// kernels: the 16-row stream body fp4_stream.cuh, the 64-row wgmma body
// fp4_wgmma.cuh, fp4_gemm_hp.cu, fp4_gemm_w4a8.cu and fp4_dequant.cu. They
// read the same packed bytes as the TPU kernels
// (petit_kernel_tpu/ops/kernels/fused.py):
//   W  (kp/8, n) 32-bit words, v6 q-coded layout (ops/layout.py): slot s of
//      word row r holds natural k = j*(kp/4) + (r/64)*128 + pi(2*(r%64)+h),
//      j = s&3, h = s>>2, pi(i) = (i%8)*16 + i/8;
//   S  (kp/16, n) bf16 scales, row g covering natural k [16g, 16g+16);
//   A  (m, k) bf16 in natural k order, k <= kp (k % 128 == 0).
//
// Decode: a slot's sign and 3-bit q-code t sit pre-positioned per quarter
// (layout.py _v6_place). The nonzero magnitudes are the bf16 bit patterns
// 0x3F00 + t*0x40 (t = 0, 2..7); t = 1 is the stored zero and decodes to an
// exact 0 here. The TPU kernel left it as the subnormal 2^-127 and relied
// on its VPU's subnormal flush; nothing here relies on a flush. Value times
// scale is exact in bf16 (2 and 4 significant bits), so one multiply serves
// all scale paths: E4M3 scales (nvfp4), and the power-of-two scales that
// the TPU applied by exponent add (mxfp4, nvfp4p2, nvfp4p2z, mxfp4z).
//
// The kernels walk kp in steps of KSTEP = 256 natural k, WROWS = 32 word
// rows. The 32 word rows of a step cover, per quarter j, the natural k
//     j*(kp/4) + c*128 + a*16 + 8*hf + x,  a, x in [0, 8)
// (c = step/2, hf = step%2). The step's local k order is L = j*64 + a*8 +
// x, so A loads are runs of 8 contiguous natural k (16 bytes) and the word
// of row rr, slot s decodes into L with ii = 2*rr + h, a = ii%8, x = ii/8.
// Scale row = j*(kp/64) + c*8 + a.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSTEP = 256;         // natural k per main-loop step
constexpr int WROWS = KSTEP / 8;   // packed word rows per step
constexpr int LDS = KSTEP + 8;     // smem row stride in bf16 (+16 bytes: no bank conflicts)
constexpr int THREADS = 128;       // four warps: a stream CTA, an hp m-tile
constexpr int WC_GROUP = 4;        // m-tiles a CTA of the weight-cache kernels
constexpr int HP_WC_GROUP = 2;     // m-tiles a CTA of the high-precision weight cache

// Decode the slot of quarter j held in a 16-bit half -> float value.
template <int J>
__device__ __forceinline__ float decode_slot(uint32_t half) {
  uint32_t t, sg;
  if (J == 0) {
    t = (half >> 6) & 7u; sg = (half >> 15) & 1u;
  } else if (J == 1) {
    t = (half >> 3) & 7u; sg = (half >> 12) & 1u;
  } else if (J == 2) {
    t = half & 7u; sg = (half >> 9) & 1u;
  } else {
    t = ((half >> 10) & 3u) | (((half >> 13) & 1u) << 2); sg = (half >> 14) & 1u;
  }
  uint32_t bits = (t == 1u) ? 0u : (((0x3F00u + (t << 6)) << 16) | (sg << 31));
  return __uint_as_float(bits);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
