// The causal flash prefill tile body for Hopper (sm_90a), launched by
// prefill_attention.cu (flat bf16 cache) and paged_prefill_attention.cu
// (headed or paged, bf16 or fp8 e4m3). Query t of sequence b sits at
// position pos0[b] + t and attends the positions p <= pos0[b] + t with
// p < window; the chunk's own K/V is already in the cache. It replaces the
// TPU kernel petit_kernel_tpu/ops/kernels/attention.py:445 _prefill_kernel
// (and :504 _prefill_kernel_paged), with its numerics: q.k exact bf16
// products summed in f32 and scaled by 1/sqrt(d), the online softmax in
// f32, P.V summed in f32, one cast of the output to bf16. A row with no
// valid position gives 0.
//
// The tile. One warpgroup (one CTA of 128 threads) takes 64 query rows of
// one kv head, row r = t*G + g of the G = H / Hkv query heads, so every K/V
// tile serves all G heads. Q is staged once into shared memory, 128-byte
// swizzled and K-major (d = 128 is two swizzle quarters of 64 d). The body
// walks the KV positions in tiles of 64, from 0 up to the tile's causal and
// window limit, so no tile above the diagonal is visited:
//   - S = Q K^T: wgmma m64n64k16, d / 16 of them, K staged K-major as it
//     lies in the cache (rows = positions, d contiguous);
//   - the online softmax on the accumulator fragment (wgmma.cuh): a thread
//     holds rows 16w + l/4 and + 8, 16 positions each; the row max reduces
//     over the lane quad (shfl_xor 1, 2), the row sum stays per thread until
//     the end; positions at or past a row's limit are masked to p = 0;
//   - O += P V: wgmma m64n{d}k16 from shared memory, P written as bf16 into
//     a swizzled tile and V stored transposed (V^T: d rows of 64
//     positions), so both operands are K-major and read by sw128_desc. P is
//     split as hi = bf16(p), lo = bf16(p - hi), two wgmmas into the same
//     accumulator: p is carried to about 2^-17, where one bf16 rounding
//     would err by up to 2^-9 max|v| (the TPU kernel multiplies f32 P by f32
//     V). The second wgmma is cheap: the tile is far from compute-bound.
// Loads. bf16 K comes by cp.async; fp8 K and V, and every V (it is stored
// transposed), pass through registers, where fp8 converts exactly to bf16
// (subnormals kept) and each thread transposes its d/16 positions of 8
// values into one store a value (fp_store_v: no bank conflicts). K and V^T
// are double-buffered. The order of tile j,
// with S(j) and P.V(j - 1) in flight: queue tile j + 1's global loads;
// wait for the wgmmas; the softmax into P(j); store fp8 K(j + 1); one
// barrier; issue P.V(j) and S(j + 1) as one group; store V^T(j + 1) under
// them. So one barrier and one wait a tile, and the tensor cores get the
// two products back to back. Positions at or past the tile's limit are
// zero-filled, never read; rows past T*G are zero and never written.
// Addressing (the only difference between the layouts): FlatKV and PagedKV
// map (b, h, p) to the element offset of a K/V row. 64 threads fill a KV
// tile's row table with them two tiles ahead, so a paged tile's division
// and block-table read run once a position, not once a copy.
//
// Shared memory (FpPlan): Q, K and V^T double-buffered, P hi and lo, two
// row tables: 98 KB at d = 128, two blocks an SM. The grid is
// (ceil(T*G / 64), Hkv, B), and blockIdx.x walks the row tiles in reverse
// so the longest causal walks start first.
//
// Visibility: wgmma reads shared memory through the async proxy, and the
// cp.async copies and the stores of Q, K, V^T and P are generic-proxy
// writes, so each writer runs fence.proxy.async before the barrier that
// precedes the wgmmas.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int FP_ROWS = 64;            // query rows of a tile (wgmma m)
constexpr int FP_KV = 64;              // KV positions of a tile
constexpr int FP_THREADS = 128;        // one warpgroup
constexpr int FP_ROW = 128;            // bytes of a swizzled row: 64 bf16
constexpr int FP_QUARTER = 64 * FP_ROW;   // 64 swizzled rows
constexpr int FP_SMEM_LIMIT = 232448;  // shared memory a block may use
constexpr int FP_SMEM_SM = 233472;     // an SM's, 1 KB of it reserved per block
constexpr float FP_NEG = -1e30f;       // finite: exp(m_prev - m_new) stays a number
constexpr float FP_LOG2E = 1.4426950408889634f;

// shared-memory plan at head dim D; every buffer a multiple of 1024 bytes
template <int D>
struct FpPlan {
  static constexpr int q_bytes = D / 64 * FP_QUARTER;   // Q: 64 rows, D/64 quarters
  static constexpr int k_bytes = D / 64 * FP_QUARTER;   // a K buffer: 64 positions
  static constexpr int v_bytes = D * FP_ROW;            // a V^T buffer: D rows of 64 positions
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + 2 * k_bytes;
  static constexpr int p_off = v_off + 2 * v_bytes;     // P hi, then P lo
  static constexpr int t_off = p_off + 2 * FP_QUARTER;  // two row tables
  static constexpr int bytes = t_off + 2 * FP_KV * 8 + 1024;   // + alignment
  static_assert(D == 64 || D == 128, "head dim");
  static_assert(bytes <= FP_SMEM_LIMIT, "shared memory");
  static_assert(2 * (bytes + 1024) <= FP_SMEM_SM, "two blocks an SM");
};

// ---- addressing --------------------------------------------------------------

// flat (B, S, Hkv, d): row ((b*S + p)*Hkv + h)
struct FlatKV {
  int S, Hkv, d;
  __device__ __forceinline__ long long operator()(int b, int h, int p) const {
    return ((static_cast<long long>(b) * S + p) * Hkv + h) * d;
  }
};

// headed pages: bt[b*max_pages + p/ps]*page_stride + h*head_stride + (p%ps)*d
// (a contiguous (B, Hkv, S, d) cache is one page of S positions a sequence)
struct PagedKV {
  const int* bt;
  int max_pages, ps, d;
  long long page_stride, head_stride;
  __device__ __forceinline__ long long operator()(int b, int h, int p) const {
    const int page = __ldg(bt + static_cast<long long>(b) * max_pages + p / ps);
    return page * page_stride + h * head_stride + static_cast<long long>(p % ps) * d;
  }
};

// ---- copies and conversions ----------------------------------------------------

// 16 bytes global -> shared; zeros when !valid (source size 0)
__device__ __forceinline__ void fp_cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// byte offset of 16-byte chunk c (8 values) of row r in a K-major operand of
// D/64 quarters: quarter c / 8, chunk (c % 8) ^ (r & 7) of the swizzled row
__device__ __forceinline__ int fp_chunk(int r, int c) {
  return (c >> 3) * FP_QUARTER + r * FP_ROW + (((c & 7) ^ (r & 7)) << 4);
}

// 8 K/V values as they lie in the cache: 16 bytes of bf16, 8 of fp8
template <typename KV>
struct FpRaw;
template <>
struct FpRaw<__nv_bfloat16> {
  using T = uint4;
};
template <>
struct FpRaw<__nv_fp8_storage_t> {
  using T = uint2;
};

__device__ __forceinline__ uint4 fp_load(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint2 fp_load(const __nv_fp8_storage_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ uint4 fp_bf16x8(uint4 x) { return x; }

// two fp8 e4m3 -> two bf16, exact: e4m3 -> f16 (hardware, subnormals kept)
// -> f32 -> bf16, every value representable at each step
__device__ __forceinline__ uint32_t fp8x2_bf16x2(uint32_t x) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(x), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  const __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 fp_bf16x8(uint2 x) {
  return make_uint4(fp8x2_bf16x2(x.x & 0xFFFFu), fp8x2_bf16x2(x.x >> 16),
                    fp8x2_bf16x2(x.y & 0xFFFFu), fp8x2_bf16x2(x.y >> 16));
}

// 2^x, flushing results below 2^-126 to 0 (p that small adds nothing)
__device__ __forceinline__ float fp_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t fp_prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// ---- K and V tiles -------------------------------------------------------------

// K (64 positions from kp0) and V^T of one kv head, each position's row
// found in the tile's row table (fp_fill_rows). Thread mapping:
//   K: element e = tid + 128i is position e / (D/8), chunk e % (D/8): a
//      warp copies whole rows;
//   V: thread t takes chunk c = t / (64/VP) (8 values of d) of the VP =
//      D/16 positions VP * (t % (64/VP)) + k, which it transposes in
//      registers into one VP-position store a value.
// Positions at or past `lim` are zeros.
template <typename KV, int D>
struct FpKV {
  static constexpr int C8 = D / 8;                     // 8-value chunks of a row
  static constexpr int KN = FP_KV * C8 / FP_THREADS;   // K chunks a thread
  static constexpr int VP = D / 16;                    // V positions a thread
  static constexpr int VB = FP_KV / VP;                // V position blocks a chunk
  using Raw = typename FpRaw<KV>::T;
  Raw k[KN];
  Raw v[VP];
};

// the tile's row table: tab[p] = the element offset of position kp0 + p
// (0 at or past lim), one position a thread of the first 64, so the
// addressing (a division and a block-table read when paged) runs once a
// position
template <typename Addr>
__device__ __forceinline__ void fp_fill_rows(long long* tab, const Addr& addr, int b, int h,
                                             int kp0, int lim) {
  const int p = kp0 + threadIdx.x;
  if (threadIdx.x < FP_KV) tab[threadIdx.x] = p < lim ? addr(b, h, p) : 0;
}

// bf16 K straight into the swizzled buffer
template <int D>
__device__ __forceinline__ void fp_copy_k(unsigned char* kbuf, const __nv_bfloat16* __restrict__ ck,
                                          const long long* tab, int kp0, int lim) {
  using F = FpKV<__nv_bfloat16, D>;
#pragma unroll
  for (int i = 0; i < F::KN; ++i) {
    const int e = threadIdx.x + i * FP_THREADS, p = e / F::C8, c = e % F::C8;
    const bool ok = kp0 + p < lim;
    fp_cp_async16(kbuf + fp_chunk(p, c), ck + tab[p] + c * 8, ok);
  }
}

// the global loads of one KV tile into registers: V, and fp8 K
template <typename KV, int D>
__device__ __forceinline__ void fp_load_kv(FpKV<KV, D>& r, const KV* __restrict__ ck,
                                           const KV* __restrict__ cv, const long long* tab,
                                           int kp0, int lim) {
  using F = FpKV<KV, D>;
  if constexpr (!std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < F::KN; ++i) {
      const int e = threadIdx.x + i * FP_THREADS, p = e / F::C8, c = e % F::C8;
      r.k[i] = kp0 + p < lim ? fp_load(ck + tab[p] + c * 8) : typename F::Raw{};
    }
  }
  const int c = threadIdx.x / F::VB, p0 = F::VP * (threadIdx.x % F::VB);
#pragma unroll
  for (int k = 0; k < F::VP; ++k)
    r.v[k] = kp0 + p0 + k < lim ? fp_load(cv + tab[p0 + k] + c * 8) : typename F::Raw{};
}

// fp8 K from the registers into the swizzled K buffer (bf16 K came by
// cp.async)
template <typename KV, int D>
__device__ __forceinline__ void fp_store_k(const FpKV<KV, D>& r, unsigned char* kbuf) {
  using F = FpKV<KV, D>;
  if constexpr (!std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < F::KN; ++i) {
      const int e = threadIdx.x + i * FP_THREADS, p = e / F::C8, c = e % F::C8;
      *reinterpret_cast<uint4*>(kbuf + fp_chunk(p, c)) = fp_bf16x8(r.k[i]);
    }
  }
}

// V from the registers into the V^T buffer: value j of the thread's chunk
// c is V^T row dd = 8c + j, and its VP positions p0 .. p0 + VP - 1 are
// 2*VP contiguous bytes of that row, at chunk (p0 / 8) ^ (dd & 7), byte
// 2 (p0 % 8): one 16-byte (d = 128) or 8-byte (d = 64) store a value. A
// warp's stores of one value cover whole rows: no bank conflicts.
template <typename KV, int D>
__device__ __forceinline__ void fp_store_v(const FpKV<KV, D>& r, unsigned char* vbuf) {
  using F = FpKV<KV, D>;
  const int c = threadIdx.x / F::VB, p0 = F::VP * (threadIdx.x % F::VB);
  uint32_t w[F::VP][4];   // the VP positions' 8 values as bf16x2 words
#pragma unroll
  for (int k = 0; k < F::VP; ++k) {
    const uint4 x = fp_bf16x8(r.v[k]);
    w[k][0] = x.x;
    w[k][1] = x.y;
    w[k][2] = x.z;
    w[k][3] = x.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dd = 8 * c + j;
    uint32_t t[F::VP / 2];   // positions (2m, 2m + 1) of value j
#pragma unroll
    for (int m = 0; m < F::VP / 2; ++m)
      t[m] = fp_prmt(w[2 * m][j >> 1], w[2 * m + 1][j >> 1], (j & 1) ? 0x7632u : 0x5410u);
    unsigned char* dst = vbuf + dd * FP_ROW + (((p0 >> 3) ^ (dd & 7)) << 4) + 2 * (p0 & 7);
    if constexpr (F::VP == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(t[0], t[1], t[2], t[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(t[0], t[1]);
  }
}

// S += Q K^T over d: D / 16 wgmma m64n64k16, chunk c 32 bytes along
// quarter c / 4 of both operands
template <int D>
__device__ __forceinline__ void fp_qk(float (&sc)[32], uint64_t dq, uint64_t dk) {
  constexpr int QD = FP_QUARTER >> 4;   // a quarter in descriptor units
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int off = (c >> 2) * QD + 2 * (c & 3);
    wgmma_bf16(sc, dq + off, dk + off);
  }
}

// ---- the tile --------------------------------------------------------------------

// The 64 query rows of row tile `tile` of (sequence b, kv head h), by one
// CTA of FP_THREADS threads with FpPlan<D>::bytes of dynamic shared memory
// at `smem`. window <= the cache's positions.
template <typename KV, int D, typename Addr>
__device__ __forceinline__ void flash_prefill_tile(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q, const KV* __restrict__ ck,
    const KV* __restrict__ cv, const int* __restrict__ pos0, __nv_bfloat16* __restrict__ out,
    int T, int H, int Hkv, int window, float sm_scale, const Addr& addr, int tile, int h,
    int b) {
  using P = FpPlan<D>;
  constexpr bool kBf16 = std::is_same<KV, __nv_bfloat16>::value;
  const int G = H / Hkv, rows = T * G, r0 = tile * FP_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = pos0[b];
  // the tile's limit: its last row's, as far as the window allows
  const int last = min(r0 + FP_ROWS, rows) - 1;
  const int lim = min(p0 + last / G + 1, window);
  const int ntiles = lim > 0 ? (lim + FP_KV - 1) / FP_KV : 0;

  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* s = smem + ((1024u - (base & 1023u)) & 1023u);
  unsigned char* qs = s;
  unsigned char* ks = s + P::k_off;   // K buffer i at ks + i * k_bytes
  unsigned char* vs = s + P::v_off;   // V^T buffer i at vs + i * v_bytes
  unsigned char* ph = s + P::p_off;
  unsigned char* pl = ph + FP_QUARTER;
  long long* tabs = reinterpret_cast<long long*>(s + P::t_off);   // tile j's: tabs + 64 (j & 1)

  // this thread's two rows: their limits (0 past T*G: every position
  // masked); the tile's first row has the smallest
  const int min_lim = min(p0 + r0 / G + 1, window);
  int row_lim[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * x;
    row_lim[x] = r < rows ? min(p0 + r / G + 1, window) : 0;
  }

  // Q, zero past T*G; the first KV tile
#pragma unroll
  for (int i = 0; i < FP_ROWS * (D / 8) / FP_THREADS; ++i) {
    const int e = tid + i * FP_THREADS, r = e / (D / 8), c = e % (D / 8);
    const int row = r0 + r;
    const bool ok = row < rows;
    const int t = ok ? row / G : 0, g = ok ? row % G : 0;
    const long long qrow = (static_cast<long long>(b) * T + t) * H + h * G + g;
    fp_cp_async16(qs + fp_chunk(r, c), q + qrow * D + c * 8, ok);
  }
  // descriptors: buffer i of K and V^T is i * bytes / 16 further on
  const uint64_t dq = sw128_desc(qs), dk = sw128_desc(ks), dv = sw128_desc(vs);
  const uint64_t dph = sw128_desc(ph), dpl = sw128_desc(pl);

  float o[D / 2], sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_run[2] = {FP_NEG, FP_NEG}, l_run[2] = {0.f, 0.f};
  const float scale2 = sm_scale * FP_LOG2E;   // logits to log2 units

  // the row tables of tiles 0 and 1; the first KV tile, then S(0)
  fp_fill_rows(tabs, addr, b, h, 0, lim);
  fp_fill_rows(tabs + FP_KV, addr, b, h, FP_KV, lim);
  __syncthreads();
  FpKV<KV, D> nxt;
  if (ntiles > 0) {
    if constexpr (kBf16) fp_copy_k<D>(ks, ck, tabs, 0, lim);
    fp_load_kv<KV, D>(nxt, ck, cv, tabs, 0, lim);
    fp_store_k<KV, D>(nxt, ks);
    fp_store_v<KV, D>(nxt, vs);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fence_proxy_async();
  __syncthreads();
  fence_acc(o);
  fence_acc(sc);
  if (ntiles > 0) {
    wgmma_fence();
    fp_qk<D>(sc, dq, dk);
    wgmma_commit();
  }

  // Tile j: S(j) and P.V(j - 1) are in flight. Queue tile j + 1's loads,
  // wait, run the softmax into P(j), then issue P.V(j) and S(j + 1)
  // together and store tile j + 1's V^T under them.
  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1, kp0 = j * FP_KV;
    const bool more = j + 1 < ntiles;
    unsigned char* kn = ks + (buf ^ 1) * P::k_bytes;   // S(j - 1) read it: done
    unsigned char* vn = vs + (buf ^ 1) * P::v_bytes;   // P.V(j - 1) read it: done below
    if (more) {
      const long long* tab = tabs + (buf ^ 1) * FP_KV;
      if constexpr (kBf16) fp_copy_k<D>(kn, ck, tab, kp0 + FP_KV, lim);
      fp_load_kv<KV, D>(nxt, ck, cv, tab, kp0 + FP_KV, lim);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // tile j + 2's rows into tile j's table (read above, one barrier ago)
    if (j + 2 < ntiles) fp_fill_rows(tabs + buf * FP_KV, addr, b, h, kp0 + 2 * FP_KV, lim);
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(o);

    // online softmax in log2 units: sc[4i + e] is row x = e >> 1, position
    // kp0 + 8i + 2(l % 4) + (e & 1). Masks only where the tile reaches past
    // its first row's limit (the smallest of its rows'); else every
    // position of the tile is valid for every row.
    const bool masked = kp0 + FP_KV > min_lim;
    float mx[2] = {FP_NEG, FP_NEG};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = kp0 + 8 * i + 2 * (lane & 3) + (e & 1);
        if (masked && p >= row_lim[e >> 1]) sc[4 * i + e] = FP_NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
      }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      mx[x] = fmaxf(m_run[x], mx[x] * scale2);
      alpha[x] = fp_exp2(m_run[x] - mx[x]);
      m_run[x] = mx[x];
      l_run[x] *= alpha[x];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e >> 1];

    // P = exp(S - m), 0 where masked, as hi + lo bf16 into the swizzled P tiles
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int p = kp0 + 8 * i + 2 * (lane & 3);
        float e0 = fp_exp2(fmaf(sc[4 * i + 2 * x], scale2, -mx[x]));
        float e1 = fp_exp2(fmaf(sc[4 * i + 2 * x + 1], scale2, -mx[x]));
        if (masked) {
          e0 = p < row_lim[x] ? e0 : 0.f;
          e1 = p + 1 < row_lim[x] ? e1 : 0.f;
        }
        l_run[x] += e0 + e1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(e0 - hf.x, e1 - hf.y);
        const int r = 16 * warp + (lane >> 2) + 8 * x;
        const int off = r * FP_ROW + ((i ^ (r & 7)) << 4) + (lane & 3) * 4;
        *reinterpret_cast<__nv_bfloat162*>(ph + off) = hi;
        *reinterpret_cast<__nv_bfloat162*>(pl + off) = lo;
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    if (more) fp_store_k<KV, D>(nxt, kn);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    fence_proxy_async();
    __syncthreads();   // P(j), K(j + 1), V^T(j) and tile j + 2's rows complete

    // O += P V (hi and lo parts, 16 positions a chunk), then S(j + 1)
    fence_acc(o);
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint64_t v = dv + buf * (P::v_bytes >> 4) + 2 * c;
      wgmma_bf16(o, dph + 2 * c, v);
      wgmma_bf16(o, dpl + 2 * c, v);
    }
    if (more) fp_qk<D>(sc, dq, dk + (buf ^ 1) * (P::k_bytes >> 4));
    wgmma_commit();
    if (more) fp_store_v<KV, D>(nxt, vn);
  }
  wgmma_wait<0>();
  fence_acc(o);

  // O / l, rows below T*G
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float l = l_run[x];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * x;
    if (r >= rows) continue;
    __nv_bfloat16* dst =
        out + ((static_cast<long long>(b) * T + r / G) * H + h * G + r % G) * D + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * x] * inv, o[4 * i + 2 * x + 1] * inv);
  }
}

template <typename KV, int D, typename Addr>
__global__ void __launch_bounds__(FP_THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ ck,
                     const KV* __restrict__ cv, const int* __restrict__ pos0,
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int window,
                     float sm_scale, Addr addr) {
  extern __shared__ __align__(16) unsigned char smem[];
  flash_prefill_tile<KV, D, Addr>(smem, q, ck, cv, pos0, out, T, H, Hkv, window, sm_scale, addr,
                                  gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

// Launch the tile body over (ceil(T*G / 64), Hkv, B) on `st`.
template <typename KV, int D, typename Addr>
cudaError_t flash_prefill_launch(const void* q, const void* ck, const void* cv, const void* pos0,
                                 void* out, int B, int T, int H, int Hkv, int window,
                                 float sm_scale, const Addr& addr, cudaStream_t st) {
  constexpr int bytes = FpPlan<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<KV, D, Addr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = T * (H / Hkv);
  if (B <= 0 || rows <= 0) return cudaSuccess;
  dim3 grid((rows + FP_ROWS - 1) / FP_ROWS, Hkv, B);
  flash_prefill_kernel<KV, D, Addr><<<grid, FP_THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(ck),
      static_cast<const KV*>(cv), static_cast<const int*>(pos0),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, window, sm_scale, addr);
  return cudaGetLastError();
}

}  // namespace
