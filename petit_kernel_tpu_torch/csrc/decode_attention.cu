// One-token GQA decode attention over a flat bf16 KV cache (sm_90a):
//     out[b, h] = softmax_p(q[b, h] . k[b, p, h/G] / sqrt(d)) @ v[b, p, h/G]
// over the positions p <= pos[b] and p < window.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/attention.py:169
// _decode_kernel (reached through decode_attention_contiguous). The body is
// the split-KV tensor-core body of decode_attention.cuh, its rows found by
// FlatKV: position p of sequence b, kv head h at ((b*S + p)*Hkv + h)*d. The
// TPU kernel's G-to-8 padding and page coarsening are Mosaic rules and are
// not carried over.

#include "decode_attention.cuh"

// ws: B*H*splits*(d + 2) floats when splits > 1 (else unused); counters:
// B*Hkv ints, zero, left zero. (splits, chunk): attention.py
// decode_split_plan of (B, Hkv, window). window <= S.
extern "C" int pk_decode_attention(const void* q, const void* ck, const void* cv,
                                   const void* pos, void* out, void* ws, void* counters, int B,
                                   int H, int Hkv, int S, int d, int window, int splits,
                                   int chunk, float sm_scale, void* stream) {
  if (!decode_split_args_ok(B, H, Hkv, window, splits, chunk, ws, counters) || window > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlatKV addr{S, Hkv, d};
  if (d == 128)
    return static_cast<int>(decode_split_launch<128, 0, 0>(
        q, ck, cv, pos, out, ws, counters, B, H, Hkv, window, splits, chunk, sm_scale, addr, st));
  if (d == 64)
    return static_cast<int>(decode_split_launch<64, 0, 0>(
        q, ck, cv, pos, out, ws, counters, B, H, Hkv, window, splits, chunk, sm_scale, addr, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
