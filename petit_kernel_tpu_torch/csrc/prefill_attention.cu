// Causal flash prefill over a flat (B, S, Hkv, d) bf16 KV cache (sm_90a).
// Query t of sequence b sits at position pos0[b] + t and attends the cache
// positions p <= pos0[b] + t with p < window; the chunk's own K/V is
// already in the cache when the kernel runs.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/attention.py:445
// _prefill_kernel (reached through flash_prefill_attention, flat layout),
// with its numerics (flash_prefill.cuh).
//
// What bounds it: at the Llama-3-8B kernels-phase shape (B = 2, T = 256,
// pos0 = (0, 256), H = 32, Hkv = 8, d = 128) the bytes: q and the output
// (8.4 MB) and the K/V rows of the causal range (3.1 MB), 11.5 MB in
// 3.4 us at 3.35 TB/s, above the 2.2 us of its 2.15 GFLOP at 989 TFLOP/s.
// What the design does: the tile body of flash_prefill.cuh, one
// warpgroup a 64-row tile of one kv head, so each K/V tile is read once
// for all G query heads; S and P.V on wgmma from swizzled shared memory;
// the next KV tile's loads under the current tile's MMAs; no tile above
// the diagonal visited.

#include "flash_prefill.cuh"

extern "C" int pk_prefill_attention(const void* q, const void* ck, const void* cv,
                                    const void* pos0, void* out, int B, int T, int H,
                                    int Hkv, int S, int d, int window, float sm_scale,
                                    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(ck) |
       reinterpret_cast<uintptr_t>(cv)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlatKV addr{S, Hkv, d};
  window = window < S ? window : S;
  cudaError_t err;
  if (d == 128)
    err = flash_prefill_launch<__nv_bfloat16, 128>(q, ck, cv, pos0, out, B, T, H, Hkv, window,
                                                   sm_scale, addr, st);
  else if (d == 64)
    err = flash_prefill_launch<__nv_bfloat16, 64>(q, ck, cv, pos0, out, B, T, H, Hkv, window,
                                                  sm_scale, addr, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
