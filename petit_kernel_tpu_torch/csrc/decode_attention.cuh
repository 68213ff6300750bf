// The split-KV decode attention body for Hopper (sm_90a), launched by
// decode_attention.cu (flat bf16 cache) and paged_decode_attention.cu
// (headed or paged, bf16 or fp8 e4m3). One query token per sequence:
//     out[b, h] = softmax_p(q[b, h] . k[b, p, h/G] / sqrt(d)) @ v[b, p, h/G]
// over the positions p <= pos[b] and p < window. It replaces the TPU kernels
// petit_kernel_tpu/ops/kernels/attention.py:169 _decode_kernel and :87
// _decode_kernel_headed, with their numerics: q.k exact bf16 products summed
// in f32 and scaled by 1/sqrt(d), the softmax in f32, P.V with f32 P summed
// in f32, one cast of the output to bf16. fp8 converts exactly to bf16,
// subnormals kept (the TPU kernel's SWAR upcast flushed them).
//
// What bounds it: the K/V bytes of the positions each sequence attends,
// 2 * len * Hkv * d * (2 or 1) bytes, at G multiply-adds a value; far below
// the tensor cores' rate. So the design is about bytes in flight and CTAs:
//
// The split. The grid is (splits, Hkv, B). CTA s of (sequence b, kv head h)
// takes the positions [s * chunk, (s + 1) * chunk), chunk a multiple of 64,
// cut at lim = min(pos[b] + 1, window). The wrapper computes (splits,
// chunk) on the host from B, Hkv and the window alone (attention.py
// decode_split_plan: about four CTAs an SM), never from pos, so a launch
// needs no host sync and replays in a CUDA graph. A CTA whose range starts
// at or past lim exits at once (split 0 always runs).
//
// The warps. A CTA of 4 warps walks its range in tiles of 64 positions;
// warp w takes positions 16w .. 16w + 15 of each tile, so each warp only
// ever reads its own rows and runs with no block barrier until the end.
// Each warp keeps its own cp.async ring of DA_STAGES stages (16 K rows and
// 16 V rows a stage, rows found through FlatKV or PagedKV, one address a
// row, computed by one lane and shuffled to the lanes that copy it; at page
// size 16 a warp's 16 rows are one page). bf16 rows land 16-byte-chunk
// swizzled (chunk c of row r at c ^ (r & 7)); fp8 rows land raw in the
// first half of the stage and the warp upcasts them exactly in place
// (fp8x2_bf16x2) before it reads them, so both kinds share one read path.
//
// The products, mma.sync m16n8k16 bf16 with f32 sums:
//   - S = Q K^T: A is the kv head's G query rows in registers, zero to 16
//     rows (rows 8-15 are always zero: G <= 8); B is K as it lies, read by
//     ldmatrix (rows = positions, d contiguous). Exact products, f32 sums.
//     wgmma's 64-row minimum would waste 15/16 of each instruction, and the
//     body is bound by bytes, not by the tensor cores.
//   - the online softmax once a tile: the warp's row max over its 16 logits
//     (lane quad shuffles), one rescale of its accumulator, p = 2^(s *
//     log2(e)/sqrt(d) - m) (ex2.approx), 0 at positions >= lim;
//   - O += P V: P comes straight from the S fragment (its two n-tiles are
//     the A operand's two k halves), V by ldmatrix.trans. P is split as hi
//     = bf16(p), lo = bf16(p - hi), two MMAs into the same accumulator, as
//     flash_prefill.cuh does: hi + lo carries p to within 2^-17 p, where one
//     bf16 rounding would err by up to 2^-9 p; V is exact in bf16 and the
//     products are exact in f32, so P.V is the JAX kernel's f32 product to
//     about 2^-17 relative, summed in f32.
//
// The merges, in a fixed order so the same bits come back on every launch:
// the 4 warps' (m, l, O) in warp order through shared memory; then, when
// more than one split holds a valid position for the sequence, each such
// CTA writes its (m, l, O) in f32 to the workspace, takes a ticket on its
// (b, h) counter, and the last one merges the splits in split order (the
// (m, l) rows through shared memory, O four values a thread with the
// splits' loads in flight together) and resets the counter to 0. With one
// split (a short sequence, or splits == 1) the CTA writes the output
// directly. out = bf16(O / l), 0 where no position is valid.
//
// Shared memory (DaPlan): 4 warps x DA_STAGES stages x (16 K + 16 V rows of
// 2d bytes): 96 KB at d = 128; with its registers, two blocks an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_prefill.cuh"   // FlatKV, PagedKV, fp_cp_async16, fp_bf16x8, fp_exp2

namespace {

constexpr int DA_WARPS = 4;
constexpr int DA_THREADS = 32 * DA_WARPS;
constexpr int DA_TILE = 64;           // positions of a CTA tile
constexpr int DA_WP = DA_TILE / DA_WARPS;   // a warp's 16 positions of it
constexpr int DA_MAXG = 8;            // query rows of a kv head (H / Hkv)
constexpr int DA_STAGES = 3;          // a warp's cp.async ring
constexpr int DA_MAX_SPLITS = 512;    // the merge's (m, l) rows fit shared memory

// shared-memory plan at head dim D
template <int D>
struct DaPlan {
  static constexpr int row_bytes = 2 * D;                     // a bf16 row
  static constexpr int mat_bytes = DA_WP * row_bytes;         // 16 K or V rows
  static constexpr int stage_bytes = 2 * mat_bytes;           // K, then V
  static constexpr int warp_bytes = DA_STAGES * stage_bytes;
  static constexpr int merge_bytes = DA_WARPS * DA_MAXG * (D + 2) * 4;
  static constexpr int bytes = DA_WARPS * warp_bytes + 128;   // + alignment
  static_assert(D == 64 || D == 128, "head dim");
  static_assert(merge_bytes <= DA_WARPS * warp_bytes, "merge buffer");
  static_assert((2 * DA_MAX_SPLITS + 1) * DA_MAXG * 4 <= DA_WARPS * warp_bytes,
                "split merge buffer");
  static_assert(2 * (bytes + 1024) <= FP_SMEM_SM, "two blocks an SM");
};

template <int PAGED>
using DaAddr = typename std::conditional<PAGED != 0, PagedKV, FlatKV>::type;

// ---- fragments -------------------------------------------------------------------

__device__ __forceinline__ void da_ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void da_ldsm4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += A B, m16n8k16, A's rows 8-15 zero: a0 = A[g][2t, 2t + 1], a2 =
// A[g][2t + 8, 2t + 9] (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void da_mma(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t da_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of bf16 row r in a stage matrix
template <int D>
__device__ __forceinline__ int da_chunk(int r, int c) {
  return r * (2 * D) + ((c ^ (r & 7)) << 4);
}

// ---- copies --------------------------------------------------------------------------

// The warp's 16 K and V rows of positions p0 .. p0 + 15 into a stage; rows
// at or past `end` are zeros. bf16 rows swizzled, fp8 rows raw (row r at
// r * D bytes).
template <typename KV, int D, typename Addr>
__device__ __forceinline__ void da_copy(unsigned char* kst, unsigned char* vst,
                                        const KV* __restrict__ ck, const KV* __restrict__ cv,
                                        const Addr& addr, int b, int h, int p0, int end) {
  constexpr int KB = sizeof(KV);
  constexpr int CH = D * KB / 16;           // 16-byte chunks of a cached row
  constexpr int N = DA_WP * CH / 32;        // a lane's chunks of K (and of V)
  const int lane = threadIdx.x & 31;
  const int pr = p0 + (lane & 15);
  const long long mine = pr < end ? addr(b, h, pr) : 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = lane + 32 * i, r = e / CH, c = e % CH;
    const long long off = __shfl_sync(0xffffffffu, mine, r) + c * (16 / KB);
    const bool ok = p0 + r < end;
    const int dst = KB == 2 ? da_chunk<D>(r, c) : r * D + 16 * c;
    fp_cp_async16(kst + dst, ck + off, ok);
    fp_cp_async16(vst + dst, cv + off, ok);
  }
}

// fp8 rows of a stage matrix, raw at r * D, to swizzled bf16 in place: every
// lane reads its raw chunks before any lane writes
template <int D>
__device__ __forceinline__ void da_upcast(unsigned char* mat) {
  constexpr int CR = D / 16;                // raw 16-byte chunks of a row
  constexpr int N = DA_WP * CR / 32;
  const int lane = threadIdx.x & 31;
  uint4 raw[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = lane + 32 * i;
    raw[i] = *reinterpret_cast<const uint4*>(mat + (e / CR) * D + 16 * (e % CR));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = lane + 32 * i, r = e / CR, c = e % CR;
    *reinterpret_cast<uint4*>(mat + da_chunk<D>(r, 2 * c)) =
        fp_bf16x8(make_uint2(raw[i].x, raw[i].y));
    *reinterpret_cast<uint4*>(mat + da_chunk<D>(r, 2 * c + 1)) =
        fp_bf16x8(make_uint2(raw[i].z, raw[i].w));
  }
  __syncwarp();
}

// ---- the body ------------------------------------------------------------------------

// CTA (s, h, b). ws: the splits' f32 partials, O at ((b*Hkv + h)*splits +
// s)*G + g rows of D, then (m, l) pairs at the same rows; counters: one
// int a (b, h), 0 between launches. window <= the cache's positions.
template <int D, int FP8, int PAGED>
__global__ void __launch_bounds__(DA_THREADS, 2)
decode_split_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ ck_,
                    const void* __restrict__ cv_, const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ counters, int H, int Hkv, int window, int splits,
                    int chunk, float sm_scale, DaAddr<PAGED> addr) {
  using KV = typename std::conditional<FP8 != 0, __nv_fp8_storage_t, __nv_bfloat16>::type;
  using P = DaPlan<D>;
  const KV* ck = static_cast<const KV*>(ck_);
  const KV* cv = static_cast<const KV*>(cv_);
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / Hkv;
  const int lim = min(pos[b] + 1, window);
  // the splits that hold a valid position; split 0 always runs
  const int nsplit = lim > chunk ? (lim + chunk - 1) / chunk : 1;
  if (s >= nsplit) return;
  const int end = min(lim, (s + 1) * chunk);   // this CTA: positions < end
  const int w0 = s * chunk + DA_WP * warp;     // the warp's first position
  const int steps = w0 < end ? (end - w0 + DA_TILE - 1) / DA_TILE : 0;

  extern __shared__ __align__(16) unsigned char da_smem[];
  __shared__ bool da_last;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(da_smem));
  unsigned char* sm = da_smem + ((128u - (base & 127u)) & 127u);
  unsigned char* ring = sm + warp * P::warp_bytes;   // stage i at + i * stage_bytes

  // Q as the A operand, rows g < G: qa[ks] = (Q[g][16ks + 2t..], Q[g][16ks + 8 + 2t..])
  uint32_t qa[D / 16][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(b) * H + h * G + (g < G ? g : 0)) * D);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = g < G ? __ldg(qrow + 8 * ks + t) : 0u;
      qa[ks][1] = g < G ? __ldg(qrow + 8 * ks + 4 + t) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run = FP_NEG, l_run = 0.f;
  const float scale2 = sm_scale * FP_LOG2E;   // logits to log2 units

#pragma unroll
  for (int j = 0; j < DA_STAGES - 1; ++j) {
    if (j < steps) {
      unsigned char* kst = ring + j * P::stage_bytes;
      da_copy<KV, D>(kst, kst + P::mat_bytes, ck, cv, addr, b, h, w0 + DA_TILE * j, end);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int j = 0; j < steps; ++j) {
    __syncwarp();   // every lane is done with the stage step j - 1 read
    const int jn = j + DA_STAGES - 1;
    if (jn < steps) {
      unsigned char* kst = ring + (jn % DA_STAGES) * P::stage_bytes;
      da_copy<KV, D>(kst, kst + P::mat_bytes, ck, cv, addr, b, h, w0 + DA_TILE * jn, end);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DA_STAGES - 1) : "memory");
    __syncwarp();   // step j's rows, every lane's copies, visible to the warp
    unsigned char* kst = ring + (j % DA_STAGES) * P::stage_bytes;
    unsigned char* vst = kst + P::mat_bytes;
    if constexpr (FP8 != 0) {
      da_upcast<D>(kst);
      da_upcast<D>(vst);
    }

    // S = Q K^T: n-tile nt holds positions 8nt .. 8nt + 7 of the warp's 16
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t kb[4];   // k-steps 2kp and 2kp + 1, two halves each
        da_ldsm4(kb, kst + da_chunk<D>(8 * nt + (lane & 7), 4 * kp + (lane >> 3)));
        da_mma(sc[nt], qa[2 * kp][0], qa[2 * kp][1], kb[0], kb[1]);
        da_mma(sc[nt], qa[2 * kp + 1][0], qa[2 * kp + 1][1], kb[2], kb[3]);
      }

    // online softmax in log2 units over the lane's positions pb + 2t, + 1
    // (n-tile 0) and pb + 8 + 2t, + 1 (n-tile 1) of row g
    const int pb = w0 + DA_TILE * j;
    const bool masked = pb + DA_WP > end;
    float x[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
    float mx = FP_NEG;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked && pb + 8 * (e >> 1) + 2 * t + (e & 1) >= end) x[e] = FP_NEG;
      mx = fmaxf(mx, x[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx * scale2);
    const float alpha = fp_exp2(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha;
      o[i][1] *= alpha;
    }
    float pe[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pe[e] = fp_exp2(fmaf(x[e], scale2, -m_new));
      if (masked && pb + 8 * (e >> 1) + 2 * t + (e & 1) >= end) pe[e] = 0.f;
      l_run += pe[e];
    }
    // P as hi + lo bf16, the A operand's two k halves
    const uint32_t h0 = da_bf16x2(pe[0], pe[1]), h1 = da_bf16x2(pe[2], pe[3]);
    const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h0));
    const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h1));
    const uint32_t l0 = da_bf16x2(pe[0] - f0.x, pe[1] - f0.y);
    const uint32_t l1 = da_bf16x2(pe[2] - f1.x, pe[3] - f1.y);

    // O += P V: d-tiles 2dp and 2dp + 1 from one ldmatrix.x4.trans
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      da_ldsm4_t(vb, vst + da_chunk<D>((lane & 7) + 8 * ((lane >> 3) & 1), 2 * dp + (lane >> 4)));
      da_mma(o[2 * dp], h0, h1, vb[0], vb[1]);
      da_mma(o[2 * dp], l0, l1, vb[0], vb[1]);
      da_mma(o[2 * dp + 1], h0, h1, vb[2], vb[3]);
      da_mma(o[2 * dp + 1], l0, l1, vb[2], vb[3]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);

  // the warps' (m, l, O) rows into shared memory, then merged in warp order
  __syncthreads();   // every warp is done with its ring
  float* wm = reinterpret_cast<float*>(sm);   // [warp][row]
  float* wl = wm + DA_WARPS * DA_MAXG;
  float* wo = wl + DA_WARPS * DA_MAXG;        // [warp][row][D]
  if (t == 0) {
    wm[warp * DA_MAXG + g] = m_run;
    wl[warp * DA_MAXG + g] = l_run;
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    *reinterpret_cast<float2*>(wo + (warp * DA_MAXG + g) * D + 8 * i + 2 * t) =
        make_float2(o[i][0], o[i][1]);
  __syncthreads();

  const bool direct = nsplit == 1;
  const long long rows = static_cast<long long>(gridDim.z) * H * splits;   // partial rows
  const long long unit = (static_cast<long long>(b) * Hkv + h) * splits;   // (b, h)'s split 0
  float* part_o = ws;
  float* part_ml = ws + rows * D;
  for (int idx = tid; idx < G * D; idx += DA_THREADS) {
    const int gg = idx / D, dd = idx % D;
    float M = FP_NEG;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) M = fmaxf(M, wm[w * DA_MAXG + gg]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float f = fp_exp2(wm[w * DA_MAXG + gg] - M);
      L += wl[w * DA_MAXG + gg] * f;
      O += wo[(w * DA_MAXG + gg) * D + dd] * f;
    }
    if (direct) {
      out[(static_cast<long long>(b) * H + h * G + gg) * D + dd] =
          __float2bfloat16_rn(L > 0.f ? O / L : 0.f);
    } else {
      const long long row = (unit + s) * G + gg;
      part_o[row * D + dd] = O;
      if (dd == 0) {
        part_ml[2 * row] = M;
        part_ml[2 * row + 1] = L;
      }
    }
  }
  if (direct) return;

  // the last of the nsplit CTAs merges them in split order: the splits'
  // (m, l) rows into shared memory, one factor 2^(m - M) a split and row,
  // then O four values a thread, the splits' loads issued in batches
  __threadfence();
  __syncthreads();
  if (tid == 0) da_last = atomicAdd(counters + b * Hkv + h, 1) == nsplit - 1;
  __syncthreads();
  if (!da_last) return;
  __threadfence();
  float* fx = reinterpret_cast<float*>(sm);   // [split][row]: m, then its factor
  float* lx = fx + nsplit * G;                // [split][row]: l
  float* ls = lx + nsplit * G;                // [row]: the merged l
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + unit * G;
  for (int i = tid; i < nsplit * G; i += DA_THREADS) {
    const float2 v = __ldcg(ml + i);
    fx[i] = v.x;
    lx[i] = v.y;
  }
  __syncthreads();
  if (tid < G) {
    float M = FP_NEG, L = 0.f;
    for (int x = 0; x < nsplit; ++x) M = fmaxf(M, fx[x * G + tid]);
    for (int x = 0; x < nsplit; ++x) {
      const float f = fp_exp2(fx[x * G + tid] - M);
      fx[x * G + tid] = f;
      L += lx[x * G + tid] * f;
    }
    ls[tid] = L;
  }
  __syncthreads();
  constexpr int D4 = D / 4, BATCH = 8;
  const float4* po = reinterpret_cast<const float4*>(part_o) + unit * G * D4;
  for (int i = tid; i < G * D4; i += DA_THREADS) {
    const int gg = i / D4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x0 = 0; x0 < nsplit; x0 += BATCH) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (x0 + u < nsplit) v[u] = __ldcg(po + (x0 + u) * G * D4 + i);
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (x0 + u < nsplit) {
          const float f = fx[(x0 + u) * G + gg];
          acc.x += v[u].x * f;
          acc.y += v[u].y * f;
          acc.z += v[u].z * f;
          acc.w += v[u].w * f;
        }
    }
    const float L = ls[gg];
    const bool ok = L > 0.f;
    *reinterpret_cast<uint2*>(out + (static_cast<long long>(b) * H + h * G + gg) * D +
                              4 * (i % D4)) =
        make_uint2(da_bf16x2(ok ? acc.x / L : 0.f, ok ? acc.y / L : 0.f),
                   da_bf16x2(ok ? acc.z / L : 0.f, ok ? acc.w / L : 0.f));
  }
  if (tid == 0) counters[b * Hkv + h] = 0;
}

// The arguments every launch needs: G <= 8 query rows a kv head, a plan
// whose splits of `chunk` (a multiple of 64) positions cover the window with
// none empty, and a workspace when it splits.
__host__ inline bool decode_split_args_ok(int B, int H, int Hkv, int window, int splits,
                                          int chunk, const void* ws, const void* counters) {
  if (B < 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > DA_MAXG) return false;
  if (splits < 1 || splits > DA_MAX_SPLITS || chunk <= 0 || chunk % DA_TILE != 0) return false;
  const long long cover = static_cast<long long>(splits) * chunk;
  if (cover < window || (splits > 1 && static_cast<long long>(splits - 1) * chunk >= window))
    return false;
  return splits == 1 || (ws != nullptr && counters != nullptr);
}

// Launch the body over (splits, Hkv, B) on `st`.
template <int D, int FP8, int PAGED>
cudaError_t decode_split_launch(const void* q, const void* ck, const void* cv, const void* pos,
                                void* out, void* ws, void* counters, int B, int H, int Hkv,
                                int window, int splits, int chunk, float sm_scale,
                                const DaAddr<PAGED>& addr, cudaStream_t st) {
  constexpr int bytes = DaPlan<D>::bytes;
  const cudaError_t set = cudaFuncSetAttribute(
      decode_split_kernel<D, FP8, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  if (B == 0) return cudaSuccess;
  dim3 grid(splits, Hkv, B);
  decode_split_kernel<D, FP8, PAGED><<<grid, DA_THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), ck, cv, static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(counters),
      H, Hkv, window, splits, chunk, sm_scale, addr);
  return cudaGetLastError();
}

}  // namespace
