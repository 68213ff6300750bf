// One-token GQA decode attention over a headed KV layout, paged or
// contiguous, bf16 or fp8 e4m3 (sm_90a):
//     out[b, h] = softmax_p(q[b, h] . k[b, h/G, p] / sqrt(d)) @ v[b, h/G, p]
// over the positions p <= pos[b] and p < window.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/attention.py:87
// _decode_kernel_headed (reached through paged_decode_attention(headed=True)
// and decode_attention_contiguous_headed). The body is the split-KV
// tensor-core body of decode_attention.cuh, its rows found by PagedKV:
//     bt[b * max_pages + p / ps] * page_stride + h * head_stride + (p % ps) * d
// (64-bit offsets). The paged pool (P + 1, Hkv, ps, d) passes its block
// table with page stride Hkv*ps*d and head stride ps*d; a contiguous
// headed cache (B, Hkv, S, d) is one page of S positions per sequence,
// table entry b*Hkv, page and head stride S*d. fp8 converts exactly to
// bf16 (subnormals kept; the TPU kernel's SWAR upcast flushed them to zero
// and permuted positions even/odd, neither of which is carried over).

#include "decode_attention.cuh"

// kv_fp8: 0 for bf16 K/V, 1 for fp8 e4m3. window <= max_pages * ps. ws,
// counters, splits and chunk as pk_decode_attention's.
extern "C" int pk_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const void* bt, const void* pos, void* out, void* ws,
                                         void* counters, int B, int H, int Hkv, int d,
                                         int max_pages, int ps, long long page_stride,
                                         long long head_stride, int window, int kv_fp8,
                                         int splits, int chunk, float sm_scale, void* stream) {
  if (!decode_split_args_ok(B, H, Hkv, window, splits, chunk, ws, counters) || ps <= 0 ||
      window > static_cast<long long>(max_pages) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedKV addr{static_cast<const int*>(bt), max_pages, ps, d, page_stride, head_stride};
#define PK_DECODE(D, F8)                                                                     \
  decode_split_launch<D, F8, 1>(q, kp, vp, pos, out, ws, counters, B, H, Hkv, window, splits, \
                                chunk, sm_scale, addr, st)
  cudaError_t err;
  if (d == 128)
    err = kv_fp8 ? PK_DECODE(128, 1) : PK_DECODE(128, 0);
  else if (d == 64)
    err = kv_fp8 ? PK_DECODE(64, 1) : PK_DECODE(64, 0);
  else
    err = cudaErrorInvalidValue;
#undef PK_DECODE
  return static_cast<int>(err);
}
