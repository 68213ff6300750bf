// One-token GQA decode attention over a flat bf16 KV cache (sm_90a):
//     out[b, h] = softmax_p(q[b, h] . k[b, p, h/G] / sqrt(d)) @ v[b, p, h/G]
// over the positions p <= pos[b] and p < window.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/attention.py:
// _decode_kernel (reached through decode_attention_contiguous). Numerics as
// there: logits are bf16 q.k products summed in f32, times 1/sqrt(d); the
// softmax and the V sum run in f32 and the output is cast to bf16 once.
//
// What bounds it: the KV stream, 2 * S_b * Hkv * d * 2 bytes per sequence
// at two flops per byte. One CTA per (kv head, sequence) holds the G query
// rows of that kv head in registers; its eight warps take interleaved
// positions, so every K/V row is read once, by one warp in one coalesced
// pass (d/32 elements per lane), and used for all G queries. Each warp keeps its own
// online softmax (max, sum, accumulator per query row); the CTA merges the
// eight states in shared memory at the end. The TPU kernel's G-to-8
// padding and page coarsening are Mosaic rules and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int MAXG = 8;         // query rows per kv head (H / Hkv)
constexpr float NEG = -1e30f;

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p + e);
    const float2 f = __bfloat1622float2(v);
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
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ cv,
                        const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                        int H, int Hkv, int S, int window, float sm_scale) {
  constexpr int E = D / 32;     // elements per lane
  __shared__ float sm_m[NWARPS][MAXG], sm_l[NWARPS][MAXG];
  __shared__ float sm_acc[NWARPS][MAXG][D];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = H / Hkv;
  int limit = min(pos[b] + 1, window);
  limit = min(limit, S);

  float qr[MAXG][E], m_i[MAXG], l_i[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_i[g] = NEG;
    l_i[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) { qr[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < G) load_row<E>(q + ((size_t)b * H + kh * G + g) * D + lane * E, qr[g]);
  }

  for (int p = warp; p < limit; p += NWARPS) {
    const size_t off = (((size_t)b * S + p) * Hkv + kh) * D + lane * E;
    float kf[E], vf[E];
    load_row<E>(ck + off, kf);
    load_row<E>(cv + off, vf);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kf[e], s);
      s = warp_sum(s) * sm_scale;
      const float m_new = fmaxf(m_i[g], s);
      const float alpha = expf(m_i[g] - m_new);
      const float pe = expf(s - m_new);
      l_i[g] = l_i[g] * alpha + pe;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(acc[g][e], alpha, pe * vf[e]);
      m_i[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) { sm_m[warp][g] = m_i[g]; sm_l[warp][g] = l_i[g]; }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NWARPS * 32) {
    const int g = idx / D, e = idx % D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      O += sm_acc[w][g][e] * f;
    }
    out[((size_t)b * H + kh * G + g) * D + e] = __float2bfloat16_rn(L > 0.f ? O / L : 0.f);
  }
}

}  // namespace

extern "C" int pk_decode_attention(const void* q, const void* ck, const void* cv,
                                   const void* pos, void* out, int B, int H, int Hkv,
                                   int S, int d, int window, float sm_scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(Hkv, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(ck);
  const auto* vp = static_cast<const __nv_bfloat16*>(cv);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (d == 128)
    decode_attention_kernel<128><<<grid, NWARPS * 32, 0, st>>>(qp, kp, vp, pp, op, H, Hkv, S,
                                                              window, sm_scale);
  else if (d == 64)
    decode_attention_kernel<64><<<grid, NWARPS * 32, 0, st>>>(qp, kp, vp, pp, op, H, Hkv, S,
                                                             window, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
