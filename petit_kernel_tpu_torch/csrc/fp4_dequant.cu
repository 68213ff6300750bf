// Standalone FP4 dequant for Hopper (sm_90a):
//     out[k, n] = bf16(decode(W)[k, n] * S[k / 16, n]),  k in [0, kp)
// in natural k order, padded rows included.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/fused.py:
// _dequant_kernel (reached through dequant_tpu_layout), whose caller on a
// model path is the backward pass of mul_fp4_diff: every quantized linear
// of a training step dequantizes its weights once for dA = g @ W^T. The
// TPU kernel writes each quarter's pi-interleaved rows and its wrapper
// undoes the interleave with a transpose; here every thread writes its
// values at their natural k directly.
//
// Layout (fp4_gemm.cuh): slot s = j + 4h of word row r holds natural
//     k = j*(kp/4) + (r/64)*128 + pi(2*(r%64) + h),  pi(i) = (i%8)*16 + i/8.
// Decode is fp4_gemm.cuh's decode_slot<J>: stored zeros give +0.0, so
// padded rows (stored zeros times the 2^-126 pad scale) give +0.0 too.
// The value (2 significant bits) times the bf16 scale (8) is exact in f32
// and rounds once to bf16, as the plain twin's f32 product does: the two
// agree bit for bit.
//
// What bounds it: the bytes. It reads 0.625 bytes per weight (a 4-bit
// value and a bf16 scale per 16) and writes 2, so it is write-bound:
// about 572 MB for the four Llama-3-8B projections of one layer, 0.17 ms
// at 3.35 TB/s. The design keeps the writes coalesced and does nothing
// else: one thread per packed word, adjacent threads on adjacent columns,
// so each of a thread's 8 stores lands beside its neighbours' along n.

#include "fp4_gemm.cuh"

namespace {

constexpr int DQ_THREADS = 256;

template <int J>
__device__ __forceinline__ void dequant_slot(uint32_t half, int k, int n, int c,
                                             const __nv_bfloat16* __restrict__ S,
                                             __nv_bfloat16* __restrict__ out) {
  const float s = __bfloat162float(S[(size_t)(k >> 4) * n + c]);
  out[(size_t)k * n + c] = __float2bfloat16_rn(decode_slot<J>(half) * s);
}

__global__ void __launch_bounds__(DQ_THREADS)
fp4_dequant_kernel(const uint32_t* __restrict__ W, const __nv_bfloat16* __restrict__ S,
                   __nv_bfloat16* __restrict__ out, int kp, int n) {
  const size_t idx = (size_t)blockIdx.x * DQ_THREADS + threadIdx.x;
  if (idx >= (size_t)(kp / 8) * n) return;
  const int r = static_cast<int>(idx / n), c = static_cast<int>(idx % n);
  const uint32_t w = W[idx];
  const int kq = kp / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t half = (w >> (16 * h)) & 0xFFFFu;
    const int i = 2 * (r & 63) + h;
    const int k0 = (r >> 6) * 128 + (i & 7) * 16 + (i >> 3);
    dequant_slot<0>(half, k0, n, c, S, out);
    dequant_slot<1>(half, kq + k0, n, c, S, out);
    dequant_slot<2>(half, 2 * kq + k0, n, c, S, out);
    dequant_slot<3>(half, 3 * kq + k0, n, c, S, out);
  }
}

}  // namespace

extern "C" int pk_fp4_dequant(const void* w, const void* s, void* out, int kp, int n,
                              void* stream) {
  if (kp <= 0 || kp % KSTEP != 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t words = (size_t)(kp / 8) * n;
  const unsigned blocks = static_cast<unsigned>((words + DQ_THREADS - 1) / DQ_THREADS);
  fp4_dequant_kernel<<<blocks, DQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const __nv_bfloat16*>(s),
      static_cast<__nv_bfloat16*>(out), kp, n);
  return static_cast<int>(cudaGetLastError());
}
