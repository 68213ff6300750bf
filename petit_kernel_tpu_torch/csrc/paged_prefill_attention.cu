// Causal flash prefill over a headed KV layout, paged or contiguous, bf16
// or fp8 e4m3 (sm_90a). Query t of sequence b sits at position pos0[b] + t
// and attends the positions p <= pos0[b] + t with p < window; the chunk's
// own K/V is already written when the kernel runs.
//
// Replaces the TPU kernels petit_kernel_tpu/ops/kernels/attention.py:504
// _prefill_kernel_paged (reached through flash_prefill_paged) and the
// headed variant of :445 _prefill_kernel (flash_prefill_attention(
// headed=True)), with their numerics (flash_prefill.cuh); fp8 converts
// exactly (subnormals kept), as the TPU kernel's astype did.
//
// Addressing as in paged_decode_attention.cu: position p of sequence b and
// kv head h lies at element
//     bt[b * max_pages + p / ps] * page_stride + h * head_stride + (p % ps) * d.
// The paged pool passes its block table; a contiguous headed cache
// (B, Hkv, S, d) is one page of S positions per sequence (entry b*Hkv,
// page and head stride S*d). A 64-position KV tile spans several pages at
// ps = 16: each row of it looks its page up.
//
// What bounds it: at the Llama-3-8B kernels-phase shape (B = 2, T = 256,
// pos0 = (0, 256), H = 32, Hkv = 8, d = 128) the bytes: q and the output
// (8.4 MB) and the K/V rows of the causal range (1.6 MB in fp8), 10.0 MB
// in 3.0 us at 3.35 TB/s. What the design does: the tile body of
// flash_prefill.cuh (wgmma from swizzled shared memory, each K/V tile read
// once for the G query heads of its kv head, fp8 converted in registers on
// its way to shared memory, the next tile's loads under this tile's MMAs).

#include "flash_prefill.cuh"

namespace {

template <typename KV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const PagedKV& addr,
                   const void* pos0, void* out, int B, int T, int H, int Hkv, int d, int window,
                   float sm_scale, cudaStream_t st) {
  if (d == 128)
    return flash_prefill_launch<KV, 128>(q, kp, vp, pos0, out, B, T, H, Hkv, window, sm_scale,
                                         addr, st);
  if (d == 64)
    return flash_prefill_launch<KV, 64>(q, kp, vp, pos0, out, B, T, H, Hkv, window, sm_scale,
                                        addr, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// kv_fp8: 0 for bf16 K/V, 1 for fp8 e4m3. window <= max_pages * ps.
extern "C" int pk_paged_prefill_attention(const void* q, const void* kp, const void* vp,
                                          const void* bt, const void* pos0, void* out, int B,
                                          int T, int H, int Hkv, int d, int max_pages, int ps,
                                          long long page_stride, long long head_stride,
                                          int window, int kv_fp8, float sm_scale,
                                          void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || ps <= 0 || window > max_pages * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedKV addr{static_cast<const int*>(bt), max_pages, ps, d, page_stride, head_stride};
  const cudaError_t err =
      kv_fp8 ? launch<__nv_fp8_storage_t>(q, kp, vp, addr, pos0, out, B, T, H, Hkv, d, window,
                                          sm_scale, st)
             : launch<__nv_bfloat16>(q, kp, vp, addr, pos0, out, B, T, H, Hkv, d, window,
                                     sm_scale, st);
  return static_cast<int>(err);
}
