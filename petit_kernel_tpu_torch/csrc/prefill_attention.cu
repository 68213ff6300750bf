// Causal flash prefill over a flat bf16 KV cache (sm_90a). Query t of
// sequence b sits at position pos0[b] + t and attends the cache positions
// p <= pos0[b] + t with p < window; the chunk's own K/V is already in the
// cache when the kernel runs.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/attention.py:
// _prefill_kernel (reached through flash_prefill_attention, flat layout).
// Numerics as there: bf16 q.k products summed in f32, times 1/sqrt(d),
// online softmax and V sum in f32, one cast of the output to bf16.
//
// What bounds it: at a 256-token chunk, issue rate rather than bytes (each
// K/V row is used by the G * 8 query rows of a CTA). This first version
// is simple: one warp per query row, eight consecutive query rows of one
// kv head per CTA, so the CTA's warps stream the same K/V rows and share
// them through L1. Each warp walks its own causal range, which skips every
// block above the diagonal without a mask. No shared-memory tiles or
// tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr float NEG = -1e30f;

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
    out[e] = f.x;
    out[e + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ ck,
                         const __nv_bfloat16* __restrict__ cv,
                         const int* __restrict__ pos0, __nv_bfloat16* __restrict__ out,
                         int T, int H, int Hkv, int S, int window, float sm_scale) {
  constexpr int E = D / 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = H / Hkv;
  const int r = blockIdx.x * NWARPS + warp;     // query row of this kv head: t*G + g
  if (r >= T * G) return;
  const int t = r / G, h = kh * G + r % G;
  int limit = min(pos0[b] + t + 1, window);
  limit = min(limit, S);

  const size_t qoff = (((size_t)b * T + t) * H + h) * D + lane * E;
  float qr[E], acc[E];
  load_row<E>(q + qoff, qr);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m_i = NEG, l_i = 0.f;

  for (int p = 0; p < limit; ++p) {
    const size_t off = (((size_t)b * S + p) * Hkv + kh) * D + lane * E;
    float kf[E], vf[E];
    load_row<E>(ck + off, kf);
    load_row<E>(cv + off, vf);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s = fmaf(qr[e], kf[e], s);
    s = warp_sum(s) * sm_scale;
    const float m_new = fmaxf(m_i, s);
    const float alpha = expf(m_i - m_new);
    const float pe = expf(s - m_new);
    l_i = l_i * alpha + pe;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(acc[e], alpha, pe * vf[e]);
    m_i = m_new;
  }
  const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
#pragma unroll
  for (int e = 0; e < E; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(out + qoff + e) =
        __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
}

}  // namespace

extern "C" int pk_prefill_attention(const void* q, const void* ck, const void* cv,
                                    const void* pos0, void* out, int B, int T, int H,
                                    int Hkv, int S, int d, int window, float sm_scale,
                                    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  dim3 grid((T * G + NWARPS - 1) / NWARPS, Hkv, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(ck);
  const auto* vp = static_cast<const __nv_bfloat16*>(cv);
  const auto* pp = static_cast<const int*>(pos0);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (d == 128)
    prefill_attention_kernel<128><<<grid, NWARPS * 32, 0, st>>>(qp, kp, vp, pp, op, T, H, Hkv,
                                                               S, window, sm_scale);
  else if (d == 64)
    prefill_attention_kernel<64><<<grid, NWARPS * 32, 0, st>>>(qp, kp, vp, pp, op, T, H, Hkv,
                                                              S, window, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
