// One-token GQA decode attention over a headed KV layout, paged or
// contiguous, bf16 or fp8 e4m3 (sm_90a):
//     out[b, h] = softmax_p(q[b, h] . k[b, h/G, p] / sqrt(d)) @ v[b, h/G, p]
// over the positions p <= pos[b] and p < window.
//
// Replaces the TPU kernel petit_kernel_tpu/ops/kernels/attention.py:
// _decode_kernel_headed (reached through paged_decode_attention(headed=True)
// and decode_attention_contiguous_headed).
//
// Addressing: position p of sequence b and kv head h lies at element
//     bt[b * max_pages + p / ps] * page_stride + h * head_stride + (p % ps) * d
// (64-bit offsets). The paged pool (P + 1, Hkv, ps, d) passes its block
// table with page stride Hkv*ps*d and head stride ps*d; a contiguous
// headed cache (B, Hkv, S, d) is one page of S positions per sequence,
// table entry b*Hkv, page and head stride S*d.
//
// Numerics: fp8 converts exactly to f32 (through half, subnormals kept;
// the TPU kernel's SWAR upcast flushed them to zero and permuted positions
// even/odd, neither of which is carried over). Logits are q.k products of
// bf16 q and exact K summed in f32, times 1/sqrt(d); softmax and the V sum
// in f32, one cast of the output to bf16.
//
// What bounds it: the KV stream, 2 * len * Hkv * d * (1 or 2) bytes per
// sequence at two flops per byte per query row. One CTA per (kv head,
// sequence) holds that head's G query rows in registers; its eight warps
// take interleaved positions, so every K/V row is read once, by one warp
// in one coalesced pass (d/32 elements per lane), and used for all G
// rows. The CTA walks the block table page by page (one table load per
// page), its warps splitting each page's positions; at a 16-position page
// each warp takes two rows per page. Each warp keeps its own online
// softmax; the CTA merges the eight states in shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int MAXG = 8;         // query rows per kv head (H / Hkv)
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

template <int E>
__device__ __forceinline__ void load_row(const __nv_fp8_storage_t* p, float (&out)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(*reinterpret_cast<const __nv_fp8x2_storage_t*>(p + e), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    out[e] = f.x;
    out[e + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename KV, int D>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int H,
                    int Hkv, int max_pages, int ps, long long page_stride,
                    long long head_stride, int window, float sm_scale) {
  constexpr int E = D / 32;     // elements per lane
  __shared__ float sm_m[NWARPS][MAXG], sm_l[NWARPS][MAXG];
  __shared__ float sm_acc[NWARPS][MAXG][D];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = H / Hkv;
  const int limit = min(pos[b] + 1, window);
  const int* row_bt = bt + (size_t)b * max_pages;
  const long long head_off = (long long)kh * head_stride + lane * E;

  float qr[MAXG][E], m_i[MAXG], l_i[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_i[g] = NEG;
    l_i[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) { qr[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < G) load_row<E>(q + ((size_t)b * H + kh * G + g) * D + lane * E, qr[g]);
  }

  for (int p0 = 0, i = 0; p0 < limit; p0 += ps, ++i) {   // page by page
    const long long page = (long long)row_bt[i] * page_stride + head_off;
    const int n = min(ps, limit - p0);
    for (int j = warp; j < n; j += NWARPS) {
      float kf[E], vf[E];
      load_row<E>(kp + page + (long long)j * D, kf);
      load_row<E>(vp + page + (long long)j * D, vf);
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

template <typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* bt, const void* pos,
           void* out, int B, int H, int Hkv, int d, int max_pages, int ps,
           long long page_stride, long long head_stride, int window, float sm_scale,
           cudaStream_t st) {
  dim3 grid(Hkv, B);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const KV*>(kp);
  const auto* vv = static_cast<const KV*>(vp);
  const auto* tt = static_cast<const int*>(bt);
  const auto* pp = static_cast<const int*>(pos);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  if (d == 128)
    paged_decode_kernel<KV, 128><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, tt, pp, oo, H, Hkv, max_pages, ps, page_stride, head_stride, window,
        sm_scale);
  else if (d == 64)
    paged_decode_kernel<KV, 64><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, tt, pp, oo, H, Hkv, max_pages, ps, page_stride, head_stride, window,
        sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_fp8: 0 for bf16 K/V, 1 for fp8 e4m3. window <= max_pages * ps.
extern "C" int pk_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const void* bt, const void* pos, void* out, int B,
                                         int H, int Hkv, int d, int max_pages, int ps,
                                         long long page_stride, long long head_stride,
                                         int window, int kv_fp8, float sm_scale,
                                         void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG || ps <= 0 || window > max_pages * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_fp8)
    return launch<__nv_fp8_storage_t>(q, kp, vp, bt, pos, out, B, H, Hkv, d, max_pages, ps,
                                      page_stride, head_stride, window, sm_scale, st);
  return launch<__nv_bfloat16>(q, kp, vp, bt, pos, out, B, H, Hkv, d, max_pages, ps,
                               page_stride, head_stride, window, sm_scale, st);
}
