// Causal flash prefill over a headed KV layout, paged or contiguous, bf16
// or fp8 e4m3 (sm_90a). Query t of sequence b sits at position pos0[b] + t
// and attends the positions p <= pos0[b] + t with p < window; the chunk's
// own K/V is already written when the kernel runs.
//
// Replaces the TPU kernels petit_kernel_tpu/ops/kernels/attention.py:
// _prefill_kernel_paged (reached through flash_prefill_paged) and the
// headed variant of _prefill_kernel (flash_prefill_attention(headed=True)).
// The flat bf16 layout keeps its own kernel (prefill_attention.cu).
//
// Addressing as in paged_decode_attention.cu: position p of sequence b and
// kv head h lies at element
//     bt[b * max_pages + p / ps] * page_stride + h * head_stride + (p % ps) * d.
// The paged pool passes its block table; a contiguous headed cache
// (B, Hkv, S, d) is one page of S positions per sequence (entry b*Hkv,
// page and head stride S*d). fp8 converts exactly to f32 (subnormals
// kept), as the TPU kernel's astype did.
//
// Numerics as in the TPU kernel: bf16 q times exact K summed in f32, times
// 1/sqrt(d), online softmax and V sum in f32, one cast to bf16.
//
// What bounds it: at a 256-token chunk, issue rate rather than bytes (each
// K/V row serves the G * 8 query rows of a CTA). Simple first version, the
// design of prefill_attention.cu: one warp per query row, eight
// consecutive query rows of one kv head per CTA (so the CTA's warps stream
// the same K/V rows through L1), each warp walking its own causal range
// page by page (one block-table lookup per page). No shared-memory tiles
// or tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
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
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const int* __restrict__ bt,
                     const int* __restrict__ pos0, __nv_bfloat16* __restrict__ out, int T,
                     int H, int Hkv, int max_pages, int ps, long long page_stride,
                     long long head_stride, int window, float sm_scale) {
  constexpr int E = D / 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = H / Hkv;
  const int r = blockIdx.x * NWARPS + warp;     // query row of this kv head: t*G + g
  if (r >= T * G) return;
  const int t = r / G, h = kh * G + r % G;
  const int limit = min(pos0[b] + t + 1, window);
  const int* row_bt = bt + (size_t)b * max_pages;
  const long long head_off = (long long)kh * head_stride + lane * E;

  const size_t qoff = (((size_t)b * T + t) * H + h) * D + lane * E;
  float qr[E], acc[E];
  load_row<E>(q + qoff, qr);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m_i = NEG, l_i = 0.f;

  for (int p0 = 0, i = 0; p0 < limit; p0 += ps, ++i) {   // page by page
    const long long page = (long long)row_bt[i] * page_stride + head_off;
    const KV* kr = kp + page;
    const KV* vr = vp + page;
    const int n = min(ps, limit - p0);
    for (int j = 0; j < n; ++j) {
      float kf[E], vf[E];
      load_row<E>(kr + (size_t)j * D, kf);
      load_row<E>(vr + (size_t)j * D, vf);
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
  }
  const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
#pragma unroll
  for (int e = 0; e < E; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(out + qoff + e) =
        __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
}

template <typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* bt, const void* pos0,
           void* out, int B, int T, int H, int Hkv, int d, int max_pages, int ps,
           long long page_stride, long long head_stride, int window, float sm_scale,
           cudaStream_t st) {
  const int G = H / Hkv;
  dim3 grid((T * G + NWARPS - 1) / NWARPS, Hkv, B);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const KV*>(kp);
  const auto* vv = static_cast<const KV*>(vp);
  const auto* tt = static_cast<const int*>(bt);
  const auto* pp = static_cast<const int*>(pos0);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  if (d == 128)
    paged_prefill_kernel<KV, 128><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, tt, pp, oo, T, H, Hkv, max_pages, ps, page_stride, head_stride, window,
        sm_scale);
  else if (d == 64)
    paged_prefill_kernel<KV, 64><<<grid, NWARPS * 32, 0, st>>>(
        qq, kk, vv, tt, pp, oo, T, H, Hkv, max_pages, ps, page_stride, head_stride, window,
        sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_fp8)
    return launch<__nv_fp8_storage_t>(q, kp, vp, bt, pos0, out, B, T, H, Hkv, d, max_pages,
                                      ps, page_stride, head_stride, window, sm_scale, st);
  return launch<__nv_bfloat16>(q, kp, vp, bt, pos0, out, B, T, H, Hkv, d, max_pages, ps,
                               page_stride, head_stride, window, sm_scale, st);
}
