// The FP4 decode-regime stream body for Hopper (sm_90a): 16-row tiles that
// read fp4_gemm.cuh's packed layout through a cp.async ring, decode the FP4
// words straight into mma.sync B fragments, and sum k-split partials in a
// fixed order. Its users are the 16-row tiles of fp4_gemm.cu (the plain FP4
// GEMM, fp4_stream_kernel<BN, 1>, and its weight cache, fp4_stream_kernel<BN,
// WC_GROUP>), grouped_fp4_gemm.cu (the MoE expert GEMM,
// grouped_stream_kernel), hybrid_gemm.cu (its FP4 CTAs) and, in the f32-A
// form at the end of this file, fp4_gemm_hp.cu (the high-precision GEMM,
// fp4_hp_stream_kernel<BN, G>, G = 1 or HP_WC_GROUP). One ring depth,
// stream_stages, serves the three one-m-tile bf16 kernels; the weight cache
// has its own plan (FsPlan), the high-precision kernels theirs (HpPlan).
//
// What bounds it: at decode (m <= 16) the weight stream, 0.625 bytes a
// weight, so the card needs many bytes in flight (about 3.4 MB at 3.35
// TB/s and 1 us of latency) and few instructions per weight (an SM takes
// about 20 FP4 weights a cycle at full rate). What the design does:
//   - split-k: the caller cuts kp into whole 256-deep steps over several
//     CTAs of one output tile (ops/kernels/fused.py: stream_splits), so a
//     narrow projection still fills the card; their f32 partials meet in a
//     workspace, and the tile's last CTA to arrive (a per-tile counter,
//     reset by that CTA) sums them in split-index order: the same bits on
//     every launch;
//   - a ring of stages filled by 16-byte cp.async copies (zero-filled past
//     M, K and N), STAGES - 1 steps ahead of the MMAs;
//   - no bf16 B tile: each thread reads its own packed words and scales
//     from the stage and builds its B fragments in registers, two values
//     per 32-bit operation, one word pair feeding four MMAs.
//
// Fragment decode. In a step's local k order (fp4_gemm.cuh) the 16-deep
// chunk kk = 4j + q of quarter j holds, for the thread (g = lane >> 2,
// tg = lane & 3) at B column g, b[0] = the half-0 slots of word rows
// q + 8tg and q + 8tg + 4 and b[1] = their half-1 slots, each of quarter j,
// scaled by the step's scale rows 8j + 2q and 8j + 2q + 1. So the two words
// of a q feed chunks q, 4 + q, 8 + q and 12 + q. The MMAs of a step run
// chunk by chunk, kk = 0 .. 15, and value times scale is exact in bf16, so
// a packed bf16 multiply gives the exact decoded weight: every 16-row tile
// of every kernel on this body feeds each output element the same products
// in the same order, and so gives the same bits at the same split count.
//
// Column order. An mma.sync B fragment holds column g of an 8-column slice
// and its accumulator columns 2tg, 2tg + 1; which tile column a slice
// column stands for is free. Slice jn's column c here is warp column
// c * NT + jn, so a thread's NT B columns are adjacent (one vector load of
// words, one of scales) and its accumulators cover 2NT adjacent columns.
//
// The weight cache (fp4_stream_kernel<BN, G>, G = WC_GROUP = 4) replaces,
// at decode block sizes, petit_kernel_tpu/ops/kernels/fused.py:259
// _fused_kernel_wc, which decodes each weight block once per n-block into a
// VMEM cache that every m-block reads. Here one CTA of four warps runs G
// m-tiles of 16 rows of one n-tile: a stage holds 16G A rows, and each
// thread's decoded B fragments feed the MMAs of all G m-tiles, so a weight
// is decoded once per 64 rows. Each m-tile sees the MMA sequence of the
// plain tile, chunk for chunk at the same fragment positions, and its
// split partials are summed in the same order: at the same split count the
// weight cache gives the plain 16-row tile's bits.
// What bounds it at m = 64: the weight stream as above, beside A, which
// every n-tile reads from L2 (the four Llama-3-8B projections: 436 MB at
// BN = 64, 218 MB at 128, against 136 MB of weights), and a step's A copy
// takes 16 bytes of each 32-byte sector (the step's local k order), the
// next step the other 16. On the card the A copies set the time (PERF.md
// section 6: edited copies without them take 0.6 of it, without the MMAs
// or the decode 0.9). The plan (FsPlan, static_asserts below): a stage is
// 16G rows of A (528 bytes each) besides the words and scales (46,080
// bytes at BN = 64, 58,368 at 128); four warps (eight were 6% slower); two
// stages, so that two CTAs share an SM at BN = 64 (one at 128); the A
// copies through L1 (cp.async.ca), 20% faster than past it. The split rule
// (fused.py fp4_wc_splits) counts the launch's CTAs against those an SM
// holds.

#pragma once

#include "fp4_gemm.cuh"

namespace {

constexpr int SBM = 16;   // rows of a stream tile

// ---- cp.async, ldmatrix, packed bf16 ---------------------------------------

// 16 bytes global -> shared; zeros when !valid (source size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// the same through L1 (cp.async.ca)
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// vector loads of 1, 2 or 4 32-bit words from shared memory
__device__ __forceinline__ void lds(uint32_t (&r)[1], const void* p) {
  r[0] = *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void lds(uint32_t (&r)[2], const void* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  r[0] = v.x; r[1] = v.y;
}
__device__ __forceinline__ void lds(uint32_t (&r)[4], const void* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

// The slots of quarter J in both halves of x -> two bf16 bit patterns, the
// same as decode_slot<J> rounded to bf16: (0x3F00 + t*0x40) | sign << 15,
// and +0 for the stored zero t = 1. Quarters 1 and 2 move t to bits 6-8
// and the sign to bit 15 with one multiply (a shift that keeps both).
template <int J>
__device__ __forceinline__ uint32_t decode_pair(uint32_t x) {
  uint32_t v;
  if constexpr (J == 0) {
    v = (x & 0x81C081C0u) + 0x3F003F00u;
  } else if constexpr (J == 1) {
    v = (x & 0x10381038u) * 8u + 0x3F003F00u;
  } else if constexpr (J == 2) {
    v = (x & 0x02070207u) * 64u + 0x3F003F00u;
  } else {
    v = (((x >> 4) & 0x00C000C0u) | ((x >> 5) & 0x01000100u) | ((x << 1) & 0x80008000u)) +
        0x3F003F00u;
  }
  // t = 1 gave magnitude 0x3F40 (0.75): clear those halves, sign included
  uint32_t live;
  asm("set.ne.u32.bf16x2 %0, %1, %2;\n" : "=r"(live) : "r"(v & 0x7FFF7FFFu), "r"(0x3F403F40u));
  return v & live;
}

// ---- the FP4 stream --------------------------------------------------------

// one stage: A [SBM * G][LDS] bf16 in local k order (G m-tiles), the step's
// words [WROWS][BN] (16-byte chunks swizzled), its scale rows [WROWS][BN]
// bf16
template <int BN, int G = 1>
__host__ __device__ constexpr int fp4_stage_bytes() {
  return SBM * G * LDS * 2 + WROWS * BN * 4 + WROWS * BN * 2;
}

// ring depth: 4 stages of 20,736 bytes at block_n = 64, 3 of 33,024 at 128
template <int BN>
__host__ __device__ constexpr int stream_stages() { return BN == 64 ? 4 : 3; }

// a ring of FP4 stages: the shared memory of a CTA of the one-m-tile
// kernels (fp4_stream_kernel<BN, 1>, grouped_stream_kernel)
template <int BN>
constexpr int stream_smem_bytes() { return stream_stages<BN>() * fp4_stage_bytes<BN>(); }

// two CTAs an SM: 2 * (bytes + 1 KB reserved) <= 228 KB
static_assert(stream_smem_bytes<64>() <= 113 * 1024, "smem (16, 64)");
static_assert(stream_smem_bytes<128>() <= 113 * 1024, "smem (16, 128)");
static_assert(fp4_stage_bytes<64>() % 128 == 0 && fp4_stage_bytes<128>() % 128 == 0,
              "stages start on 128-byte boundaries");

// The CTA of fp4_stream_kernel<BN, G>: G m-tiles of 16 rows of one n-tile,
// four warps, each a column quarter of all G m-tiles; a ring of `stages`
// stages of `stage` bytes; `per_sm` CTAs an SM. G = 1 is the plain tile;
// G = WC_GROUP the weight cache, two stages (PERF.md section 6: deeper
// rings were no faster once A went through L1), two CTAs an SM at BN = 64
// and one at 128.
template <int BN, int G>
struct FsPlan {
  static constexpr int stage = fp4_stage_bytes<BN, G>();
  static constexpr int stages = G == 1 ? stream_stages<BN>() : 2;
  static constexpr int bytes = stages * stage;
  static constexpr int per_sm = G == 1 || BN == 64 ? 2 : 1;
  static_assert(G == 1 || G == WC_GROUP, "G");
  static_assert(stage % 128 == 0 && stages >= 2, "plan");
  // per_sm CTAs an SM: per_sm * (bytes + 1 KB reserved) <= 228 KB
  static_assert(bytes <= 232448 && per_sm * (bytes + 1024) <= 228 * 1024, "smem");
};
static_assert(FsPlan<64, 1>::bytes == stream_smem_bytes<64>() &&
                  FsPlan<128, 1>::bytes == stream_smem_bytes<128>(),
              "the one-m-tile ring");
static_assert(FsPlan<64, 4>::stage == 46080 && FsPlan<64, 4>::stages == 2 &&
                  FsPlan<64, 4>::per_sm == 2 && FsPlan<128, 4>::stage == 58368 &&
                  FsPlan<128, 4>::stages == 2 && FsPlan<128, 4>::per_sm == 1,
              "the weight cache's plan in the note above");

// Zero the A rows from `first` up to ROWS in every stage of the ring
// (a_row_bytes a row at the start of each stage): the loaders
// copy only the rows below M, so these stay zero.
template <int ROWS = SBM>
__device__ __forceinline__ void zero_rows(unsigned char* smem, int stage_bytes, int stages,
                                          int first, int a_row_bytes) {
  if (first >= ROWS) return;
  const int chunks = (ROWS - first) * a_row_bytes / 16;
  for (int e = threadIdx.x; e < stages * chunks; e += THREADS) {
    const int st = e / chunks, i = e % chunks;
    *reinterpret_cast<uint4*>(smem + st * stage_bytes + first * a_row_bytes + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// physical 16-byte chunk of word chunk c in stage row r: rows 8 apart
// (the rows one fragment load reads) land in different banks
__device__ __forceinline__ int word_chunk(int r, int c) { return c ^ (((r >> 3) & 3) << 1); }

// cp.async the operands of step `step` (A rows m0 .. m0 + 16G - 1, columns
// n0 ..) into `st`; the weight cache's A through L1 (a step reads 16 bytes
// of each 32-byte sector of A, the next step the other 16)
template <int BN, int G = 1>
__device__ __forceinline__ void fp4_stage_load(unsigned char* st,
                                               const __nv_bfloat16* __restrict__ A,
                                               const uint32_t* __restrict__ W,
                                               const __nv_bfloat16* __restrict__ S, int M,
                                               int N, int K, int KP, int m0, int n0, int step) {
  constexpr int WC = BN / 4, SC = BN / 8;   // 16-byte pieces of a word / scale row
  static_assert((SBM * G * 32) % THREADS == 0 && (WROWS * WC) % THREADS == 0 &&
                    (WROWS * SC) % THREADS == 0, "pieces per thread");
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(st);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(As + SBM * G * LDS);
  __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(Ws + WROWS * BN);
  const int tid = threadIdx.x;
  const int c = step >> 1, hf = step & 1, kq = KP / 4, srq = KP / 64;
  // A: the rows below M x 32 runs (run = j*8 + a) of 8 contiguous natural
  // k (the rows past M stay zero: zero_rows)
#pragma unroll
  for (int i = 0; i < SBM * G * 32 / THREADS; ++i) {
    const int e = tid + i * THREADS, m = e >> 5, run = e & 31;
    const int kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8;
    const bool ok = kn < K;
    if (m0 + m < M) {
      if constexpr (G == 1)
        cp_async16(As + m * LDS + run * 8, ok ? A + (size_t)(m0 + m) * K + kn : A, ok);
      else
        cp_async16_ca(As + m * LDS + run * 8, ok ? A + (size_t)(m0 + m) * K + kn : A, ok);
    }
  }
  // words: WROWS rows x WC chunks of 4 columns (N % 16 == 0)
#pragma unroll
  for (int i = 0; i < WROWS * WC / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / WC, cc = e % WC;
    const bool ok = n0 + cc * 4 < N;
    cp_async16(Ws + r * BN + word_chunk(r, cc) * 4,
               ok ? W + (size_t)(step * WROWS + r) * N + n0 + cc * 4 : W, ok);
  }
  // scales: stage row j*8 + a <- scale row j*srq + c*8 + a
#pragma unroll
  for (int i = 0; i < WROWS * SC / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / SC, cc = e % SC;
    const bool ok = n0 + cc * 8 < N;
    cp_async16(Ss + r * BN + cc * 8,
               ok ? S + (size_t)((r >> 3) * srq + c * 8 + (r & 7)) * N + n0 + cc * 8 : S, ok);
  }
}

// the four MMAs of quarter J on every column slice, chunks 4J .. 4J + 3,
// for each of the G m-tiles (A rows 16mt apart from a_ptr): each B
// fragment is decoded once and feeds G MMAs
template <int J, int BN, int NT, int G>
__device__ __forceinline__ void fp4_quarter(float (&acc)[G][NT][4],
                                            const uint32_t (&lo)[4][NT],
                                            const uint32_t (&hi)[4][NT],
                                            const __nv_bfloat16* a_ptr,
                                            const __nv_bfloat16* s_ptr) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t a[G][4], s0[(NT + 1) / 2], s1[(NT + 1) / 2];
#pragma unroll
    for (int mt = 0; mt < G; ++mt) ldmatrix_x4(a[mt], a_ptr + mt * SBM * LDS + (4 * J + q) * 16);
    lds(s0, s_ptr + (8 * J + 2 * q) * BN);
    lds(s1, s_ptr + (8 * J + 2 * q + 1) * BN);
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const uint32_t sel = (jn & 1) ? 0x3232u : 0x1010u;   // broadcast column jn's scale
      uint32_t b[2];
      b[0] = mul_bf16x2(decode_pair<J>(lo[q][jn]), prmt(s0[jn >> 1], 0u, sel));
      b[1] = mul_bf16x2(decode_pair<J>(hi[q][jn]), prmt(s1[jn >> 1], 0u, sel));
#pragma unroll
      for (int mt = 0; mt < G; ++mt) mma_bf16(acc[mt][jn], a[mt], b);
    }
  }
}

// the 16 chunks of one staged step, kk = 0 .. 15, for each of the G
// m-tiles of the stage
template <int BN, int G>
__device__ __forceinline__ void fp4_stage_mma(const unsigned char* st,
                                              float (&acc)[G][BN / 32][4]) {
  constexpr int NT = BN / 32;   // 8-column slices of a warp (BN / 4 columns)
  static_assert(NT == 2 || NT == 4, "BN");
  const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(st);
  const uint32_t* Ws = reinterpret_cast<const uint32_t*>(As + SBM * G * LDS);
  const __nv_bfloat16* Ss = reinterpret_cast<const __nv_bfloat16*>(Ws + WROWS * BN);
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wcol = wn * (BN / 4) + g * NT;   // first of this thread's NT B columns
  uint32_t lo[4][NT], hi[4][NT];             // per q: half-0 and half-1 slots of the word pair
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r0 = 8 * tg + q, r1 = r0 + 4;
    uint32_t w0[NT], w1[NT];
    lds(w0, Ws + r0 * BN + word_chunk(r0, wcol >> 2) * 4 + (wcol & 3));
    lds(w1, Ws + r1 * BN + word_chunk(r1, wcol >> 2) * 4 + (wcol & 3));
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      lo[q][jn] = prmt(w0[jn], w1[jn], 0x5410u);
      hi[q][jn] = prmt(w0[jn], w1[jn], 0x7632u);
    }
  }
  const __nv_bfloat16* a_ptr = As + (lane & 15) * LDS + (lane >> 4) * 8;
  const __nv_bfloat16* s_ptr = Ss + wcol;
  fp4_quarter<0, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
  fp4_quarter<1, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
  fp4_quarter<2, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
  fp4_quarter<3, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
}

// Steps [s_begin, s_end) of the G FP4 tiles (m0 + 16i, n0), i < G, into
// acc, through a ring of STAGES stages of stage_bytes each at smem.
template <int BN, int STAGES, int G>
__device__ __forceinline__ void fp4_stream(unsigned char* smem, int stage_bytes,
                                           const __nv_bfloat16* __restrict__ A,
                                           const uint32_t* __restrict__ W,
                                           const __nv_bfloat16* __restrict__ S, int M, int N,
                                           int K, int KP, int m0, int n0, int s_begin, int s_end,
                                           float (&acc)[G][BN / 32][4]) {
  const int n = s_end - s_begin;
  zero_rows<SBM * G>(smem, stage_bytes, STAGES, M - m0, LDS * 2);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n)
      fp4_stage_load<BN, G>(smem + i * stage_bytes, A, W, S, M, N, K, KP, m0, n0, s_begin + i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step i has landed; every thread is done with step i - 1's stage
    const int nx = i + STAGES - 1;
    if (nx < n)
      fp4_stage_load<BN, G>(smem + (nx % STAGES) * stage_bytes, A, W, S, M, N, K, KP, m0, n0,
                            s_begin + nx);
    cp_async_commit();
    fp4_stage_mma<BN, G>(smem + (i % STAGES) * stage_bytes, acc);
  }
}

// ---- k-split partials ------------------------------------------------------

// With splits > 1: store this CTA's partial acc (split `split` of its G
// tiles) to ws, the [splits][G][2][NT/2][THREADS] float4 block of its
// m-group and n-tile (rows g, g + 8 of each m-tile, skipped where past M),
// and count it in *counter. Returns false except in the last CTA of the
// group to arrive, which resets *counter to 0 and returns true with acc =
// the partials summed in split order. With splits == 1 returns true and
// leaves acc as it is. row_ok[mt][h]: row g + 8h of m-tile mt is below M.
// last: a __shared__ int.
template <int NT, int G>
__device__ __forceinline__ bool reduce_splits(float (&acc)[G][NT][4], float* __restrict__ ws,
                                              int splits, int split, int* counter,
                                              const bool (&row_ok)[G][2], int& last) {
  static_assert(NT % 2 == 0, "NT");
  if (splits == 1) return true;
  constexpr int P = NT / 2;
  const int tid = threadIdx.x;
  float4* part = reinterpret_cast<float4*>(ws);
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_ok[mt][h]) continue;
#pragma unroll
      for (int p = 0; p < P; ++p)
        part[(((split * G + mt) * 2 + h) * P + p) * THREADS + tid] =
            make_float4(acc[mt][2 * p][2 * h], acc[mt][2 * p][2 * h + 1],
                        acc[mt][2 * p + 1][2 * h], acc[mt][2 * p + 1][2 * h + 1]);
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  constexpr int BATCH = 8;   // partial loads in flight at once
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_ok[mt][h]) continue;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        // split s: + s * G*2P*THREADS
        const float4* src = part + ((mt * 2 + h) * P + p) * THREADS + tid;
        float4 sum = __ldcg(src);
        for (int s0 = 1; s0 < splits; s0 += BATCH) {
          float4 v[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            if (s0 + u < splits) v[u] = __ldcg(src + (size_t)(s0 + u) * G * 2 * P * THREADS);
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            if (s0 + u < splits) {
              sum.x += v[u].x; sum.y += v[u].y; sum.z += v[u].z; sum.w += v[u].w;
            }
        }
        acc[mt][2 * p][2 * h] = sum.x;
        acc[mt][2 * p][2 * h + 1] = sum.y;
        acc[mt][2 * p + 1][2 * h] = sum.z;
        acc[mt][2 * p + 1][2 * h + 1] = sum.w;
      }
    }
  if (tid == 0) *counter = 0;
  return true;
}

// bf16(acc * gs) of the FP4 stream's fragments into C (M, N): the thread's
// 2NT adjacent columns from n0 + wn*BN/4 + 2tg*NT, rows m0 + 16mt + g and
// + 8 of the G m-tiles
template <int BN, int G>
__device__ __forceinline__ void fp4_stream_store(const float (&acc)[G][BN / 32][4], float gs,
                                                 __nv_bfloat16* __restrict__ C, int M, int N,
                                                 int m0, int n0) {
  constexpr int NT = BN / 32;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int col = n0 + wn * (BN / 4) + 2 * tg * NT;
  if (col >= N) return;   // N % 16 == 0: the 2NT columns are all in or all out
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + SBM * mt + g + 8 * h;
      if (row >= M) continue;
      uint32_t v[NT];   // columns 2i, 2i + 1: column p is acc[mt][p % NT][2h + p / NT]
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int p0 = 2 * i, p1 = 2 * i + 1;
        const __nv_bfloat162 b = __floats2bfloat162_rn(acc[mt][p0 % NT][2 * h + p0 / NT] * gs,
                                                       acc[mt][p1 % NT][2 * h + p1 / NT] * gs);
        v[i] = *reinterpret_cast<const uint32_t*>(&b);
      }
      __nv_bfloat16* dst = C + (size_t)row * N + col;
      if constexpr (NT == 2)
        *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
}

// ---- the one-m-tile forms ---------------------------------------------------
// grouped_stream_kernel and hybrid_stream_kernel run one 16-row tile a CTA
// and keep its accumulators as acc[NT][4]: these forms pass them to the
// bodies above as the one m-tile of G = 1.

template <int NT>
__device__ __forceinline__ float (&one_tile(float (&acc)[NT][4]))[1][NT][4] {
  return reinterpret_cast<float (&)[1][NT][4]>(acc);
}

template <int BN, int STAGES>
__device__ __forceinline__ void fp4_stream(unsigned char* smem, int stage_bytes,
                                           const __nv_bfloat16* __restrict__ A,
                                           const uint32_t* __restrict__ W,
                                           const __nv_bfloat16* __restrict__ S, int M, int N,
                                           int K, int KP, int m0, int n0, int s_begin, int s_end,
                                           float (&acc)[BN / 32][4]) {
  fp4_stream<BN, STAGES, 1>(smem, stage_bytes, A, W, S, M, N, K, KP, m0, n0, s_begin, s_end,
                            one_tile(acc));
}

template <int NT>
__device__ __forceinline__ bool reduce_splits(float (&acc)[NT][4], float* __restrict__ ws,
                                              int splits, int split, int* counter,
                                              const bool (&row_ok)[2], int& last) {
  return reduce_splits<NT, 1>(one_tile(acc), ws, splits, split, counter,
                              reinterpret_cast<const bool(&)[1][2]>(row_ok), last);
}

template <int BN>
__device__ __forceinline__ void fp4_stream_store(const float (&acc)[BN / 32][4], float gs,
                                                 __nv_bfloat16* __restrict__ C, int M, int N,
                                                 int m0, int n0) {
  fp4_stream_store<BN, 1>(reinterpret_cast<const float(&)[1][BN / 32][4]>(acc), gs, C, M, N,
                          m0, n0);
}


// ---- the high-precision stream: f32 A -------------------------------------
// fp4_gemm_hp.cu's 16-row tiles (fp4_hp_stream_kernel<BN, G>, G = 1 for
// pk_fp4_gemm_hp, HP_WC_GROUP = 2 for pk_fp4_gemm_hp_wc): the words, the
// scales, the split-k ring and the B fragments are the FP4 stream's, A is
// f32. A stage holds 16G A rows of LDS f32 (1,056 bytes) in the step's
// local k order, copied as two 16-byte pieces a run of 8 natural k; the
// row stride is 8 words past 256, so the float2 fragment loads of a
// half-warp (rows g < 4, words 2tg) fall on 32 different banks. Each thread
// loads its A fragment's four float2 of a chunk and splits them into three
// bf16 parts (split3); each decoded B fragment feeds 3G MMAs, lo then mid
// then hi into fresh zero accumulators, added to acc with one rounding (the
// MMA's own accumulation truncates, and over k / 16 chunks that bias would
// outgrow an f32 sum's error). Every m-tile sees this sequence chunk for
// chunk, so the weight cache gives the plain tile's bits at the same split
// count. The 64-row tiles (fp4_hp_wgmma.cuh) sum k unit by unit, in
// another order, so the two bodies' bits differ.
// The plan (HpPlan, static_asserts below): a stage is 16,896G bytes of A
// besides the words and scales, 29,184 bytes at (BN, G) = (64, 1), 41,472
// at (128, 1), 46,080 at (64, 2), 58,368 at (128, 2); three stages at (64,
// 1) and two elsewhere, two CTAs an SM but one at (128, 2). Splitting each
// stage once into bf16 planes that ldmatrix reads instead was 9-12% faster
// at G = 1 and 15% slower at G = 2, whose planes leave one CTA an SM
// (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W).

// Two f32 values -> their (hi, mid, lo) bf16 parts, packed as the MMA's A
// fragment registers hold them: the first value in the low half.
//     hi = a truncated to bf16, mid = (a - hi) truncated to bf16,
//     lo = bf16_rn(a - hi - mid)
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(v.x) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(v.y) & 0xFFFF0000u;
  const float r0 = __fsub_rn(v.x, __uint_as_float(h0));
  const float r1 = __fsub_rn(v.y, __uint_as_float(h1));
  const uint32_t m0 = __float_as_uint(r0) & 0xFFFF0000u;
  const uint32_t m1 = __float_as_uint(r1) & 0xFFFF0000u;
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, __uint_as_float(m0)),
                                                 __fsub_rn(r1, __uint_as_float(m1)));
  hi = (h0 >> 16) | h1;
  mid = (m0 >> 16) | m1;
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The word and scale copies and the B fragments below are fp4_stage_load's
// and fp4_quarter's, which keep them inline: calling these helpers from the
// bf16 forms changes those kernels' register allocation.

// cp.async the words and scale rows of step `step` (columns n0 ..) into
// the B part of a stage at `b`: the words [WROWS][BN] (16-byte chunks
// swizzled), then the scale rows [WROWS][BN] bf16
template <int BN>
__device__ __forceinline__ void hp_stage_load_b(unsigned char* b,
                                                 const uint32_t* __restrict__ W,
                                                 const __nv_bfloat16* __restrict__ S, int N,
                                                 int KP, int n0, int step) {
  constexpr int WC = BN / 4, SC = BN / 8;   // 16-byte pieces of a word / scale row
  static_assert((WROWS * WC) % THREADS == 0 && (WROWS * SC) % THREADS == 0,
                "pieces per thread");
  uint32_t* Ws = reinterpret_cast<uint32_t*>(b);
  __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(Ws + WROWS * BN);
  const int tid = threadIdx.x;
  const int c = step >> 1, srq = KP / 64;
  // words: WROWS rows x WC chunks of 4 columns (N % 16 == 0)
#pragma unroll
  for (int i = 0; i < WROWS * WC / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / WC, cc = e % WC;
    const bool ok = n0 + cc * 4 < N;
    cp_async16(Ws + r * BN + word_chunk(r, cc) * 4,
               ok ? W + (size_t)(step * WROWS + r) * N + n0 + cc * 4 : W, ok);
  }
  // scales: stage row j*8 + a <- scale row j*srq + c*8 + a
#pragma unroll
  for (int i = 0; i < WROWS * SC / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / SC, cc = e % SC;
    const bool ok = n0 + cc * 8 < N;
    cp_async16(Ss + r * BN + cc * 8,
               ok ? S + (size_t)((r >> 3) * srq + c * 8 + (r & 7)) * N + n0 + cc * 8 : S, ok);
  }
}

// B fragment of slice jn in a chunk of quarter J: the slots of quarter J of
// the word pair (lo: half 0, hi: half 1) times the scale of column jn, read
// from the scale words s0, s1 of the chunk's two scale rows (columns jn & ~1
// and jn | 1)
template <int J>
__device__ __forceinline__ void hp_b_frag(uint32_t (&b)[2], uint32_t lo, uint32_t hi,
                                           uint32_t s0, uint32_t s1, int jn) {
  const uint32_t sel = (jn & 1) ? 0x3232u : 0x1010u;   // broadcast column jn's scale
  b[0] = mul_bf16x2(decode_pair<J>(lo), prmt(s0, 0u, sel));
  b[1] = mul_bf16x2(decode_pair<J>(hi), prmt(s1, 0u, sel));
}

// The thread's word pairs of a stage's words Ws, at its NT B columns from
// wcol: per q, lo = the half-0 and hi = the half-1 slots of word rows
// 8tg + q and 8tg + q + 4 (one word pair feeds chunks q, 4 + q, 8 + q and
// 12 + q)
template <int BN, int NT>
__device__ __forceinline__ void hp_word_pairs(const uint32_t* Ws, int wcol, int tg,
                                               uint32_t (&lo)[4][NT], uint32_t (&hi)[4][NT]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r0 = 8 * tg + q, r1 = r0 + 4;
    uint32_t w0[NT], w1[NT];
    lds(w0, Ws + r0 * BN + word_chunk(r0, wcol >> 2) * 4 + (wcol & 3));
    lds(w1, Ws + r1 * BN + word_chunk(r1, wcol >> 2) * 4 + (wcol & 3));
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      lo[q][jn] = prmt(w0[jn], w1[jn], 0x5410u);
      hi[q][jn] = prmt(w0[jn], w1[jn], 0x7632u);
    }
  }
}

template <int BN, int G>
struct HpPlan {
  static constexpr int a_bytes = SBM * G * LDS * 4;
  static constexpr int stage = a_bytes + WROWS * BN * 4 + WROWS * BN * 2;
  static constexpr int stages = G == 1 && BN == 64 ? 3 : 2;
  static constexpr int bytes = stages * stage;
  static constexpr int per_sm = G == 1 || BN == 64 ? 2 : 1;
  static_assert(G == 1 || G == HP_WC_GROUP, "G");
  static_assert(stage % 128 == 0 && stages >= 2, "plan");
  // per_sm CTAs an SM: per_sm * (bytes + 1 KB reserved) <= 228 KB
  static_assert(bytes <= 232448 && per_sm * (bytes + 1024) <= 228 * 1024, "smem");
};
static_assert(HpPlan<64, 1>::stage == 29184 && HpPlan<64, 1>::stages == 3 &&
                  HpPlan<64, 1>::per_sm == 2 && HpPlan<128, 1>::stage == 41472 &&
                  HpPlan<128, 1>::stages == 2 && HpPlan<128, 1>::per_sm == 2 &&
                  HpPlan<64, 2>::stage == 46080 && HpPlan<64, 2>::stages == 2 &&
                  HpPlan<64, 2>::per_sm == 2 && HpPlan<128, 2>::stage == 58368 &&
                  HpPlan<128, 2>::stages == 2 && HpPlan<128, 2>::per_sm == 1,
              "the high-precision plan in the note above");

// cp.async the operands of step `step` (f32 A rows m0 .. m0 + 16G - 1,
// columns n0 ..) into `st`
template <int BN, int G>
__device__ __forceinline__ void hp_stage_load(unsigned char* st, const float* __restrict__ A,
                                              const uint32_t* __restrict__ W,
                                              const __nv_bfloat16* __restrict__ S, int M, int N,
                                              int K, int KP, int m0, int n0, int step) {
  static_assert((SBM * G * 64) % THREADS == 0, "pieces per thread");
  float* As = reinterpret_cast<float*>(st);
  const int tid = threadIdx.x;
  const int c = step >> 1, hf = step & 1, kq = KP / 4;
  // A: the rows below M x 32 runs (run = j*8 + a) of 8 contiguous natural
  // k, two 16-byte pieces (p) each, the two in neighbouring lanes (the rows
  // past M stay zero: zero_rows)
#pragma unroll
  for (int i = 0; i < SBM * G * 64 / THREADS; ++i) {
    const int e = tid + i * THREADS, m = e >> 6, run = (e >> 1) & 31, p = e & 1;
    const int kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8 + p * 4;
    const bool ok = kn < K;
    if (m0 + m < M)
      cp_async16(As + m * LDS + run * 8 + p * 4, ok ? A + (size_t)(m0 + m) * K + kn : A, ok);
  }
  hp_stage_load_b<BN>(st + HpPlan<BN, G>::a_bytes, W, S, N, KP, n0, step);
}

// the three bf16 parts of an m16n8k16 A fragment from the f32 stage: p is
// the thread's first value (row g, local k 16kk + 2tg of the chunk)
__device__ __forceinline__ void hp_a_frag(const float* p, uint32_t (&hi)[4], uint32_t (&mid)[4],
                                          uint32_t (&lo)[4]) {
  split3(*reinterpret_cast<const float2*>(p), hi[0], mid[0], lo[0]);
  split3(*reinterpret_cast<const float2*>(p + 8 * LDS), hi[1], mid[1], lo[1]);
  split3(*reinterpret_cast<const float2*>(p + 8), hi[2], mid[2], lo[2]);
  split3(*reinterpret_cast<const float2*>(p + 8 * LDS + 8), hi[3], mid[3], lo[3]);
}

// fp4_quarter's chunks with f32 A: each B fragment feeds the three MMAs of
// each of the G m-tiles, lo, mid, hi into a fresh part, then one rounded add
template <int J, int BN, int NT, int G>
__device__ __forceinline__ void hp_quarter(float (&acc)[G][NT][4], const uint32_t (&lo)[4][NT],
                                           const uint32_t (&hi)[4][NT], const float* a_ptr,
                                           const __nv_bfloat16* s_ptr) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t ahi[G][4], amid[G][4], alo[G][4], s0[(NT + 1) / 2], s1[(NT + 1) / 2];
#pragma unroll
    for (int mt = 0; mt < G; ++mt)
      hp_a_frag(a_ptr + mt * SBM * LDS + (4 * J + q) * 16, ahi[mt], amid[mt], alo[mt]);
    lds(s0, s_ptr + (8 * J + 2 * q) * BN);
    lds(s1, s_ptr + (8 * J + 2 * q + 1) * BN);
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      uint32_t b[2];
      hp_b_frag<J>(b, lo[q][jn], hi[q][jn], s0[jn >> 1], s1[jn >> 1], jn);
#pragma unroll
      for (int mt = 0; mt < G; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, alo[mt], b);
        mma_bf16(part, amid[mt], b);
        mma_bf16(part, ahi[mt], b);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][jn][e] = __fadd_rn(acc[mt][jn][e], part[e]);
      }
    }
  }
}

// the 16 chunks of one staged step, kk = 0 .. 15, for each of the G m-tiles
template <int BN, int G>
__device__ __forceinline__ void hp_stage_mma(const unsigned char* st,
                                             float (&acc)[G][BN / 32][4]) {
  constexpr int NT = BN / 32;
  static_assert(NT == 2 || NT == 4, "BN");
  const float* As = reinterpret_cast<const float*>(st);
  const uint32_t* Ws = reinterpret_cast<const uint32_t*>(st + HpPlan<BN, G>::a_bytes);
  const __nv_bfloat16* Ss = reinterpret_cast<const __nv_bfloat16*>(Ws + WROWS * BN);
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wcol = wn * (BN / 4) + g * NT;
  uint32_t lo[4][NT], hi[4][NT];
  hp_word_pairs<BN, NT>(Ws, wcol, tg, lo, hi);
  const float* a_ptr = As + g * LDS + 2 * tg;
  const __nv_bfloat16* s_ptr = Ss + wcol;
  hp_quarter<0, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
  hp_quarter<1, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
  hp_quarter<2, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
  hp_quarter<3, BN, NT, G>(acc, lo, hi, a_ptr, s_ptr);
}

// Steps [s_begin, s_end) of the G high-precision tiles (m0 + 16i, n0), i <
// G, into acc, through HpPlan's ring at smem (fp4_stream's order)
template <int BN, int G>
__device__ __forceinline__ void hp_stream(unsigned char* smem, const float* __restrict__ A,
                                          const uint32_t* __restrict__ W,
                                          const __nv_bfloat16* __restrict__ S, int M, int N,
                                          int K, int KP, int m0, int n0, int s_begin, int s_end,
                                          float (&acc)[G][BN / 32][4]) {
  using P = HpPlan<BN, G>;
  const int n = s_end - s_begin;
  zero_rows<SBM * G>(smem, P::stage, P::stages, M - m0, LDS * 4);
#pragma unroll
  for (int i = 0; i < P::stages - 1; ++i) {
    if (i < n)
      hp_stage_load<BN, G>(smem + i * P::stage, A, W, S, M, N, K, KP, m0, n0, s_begin + i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<P::stages - 2>();
    __syncthreads();   // step i has landed; every thread is done with step i - 1's stage
    const int nx = i + P::stages - 1;
    if (nx < n)
      hp_stage_load<BN, G>(smem + (nx % P::stages) * P::stage, A, W, S, M, N, K, KP, m0, n0,
                           s_begin + nx);
    cp_async_commit();
    hp_stage_mma<BN, G>(smem + (i % P::stages) * P::stage, acc);
  }
}

// f32(acc * gs) into C (M, N) f32: fp4_stream_store's columns and rows
template <int BN, int G>
__device__ __forceinline__ void hp_stream_store(const float (&acc)[G][BN / 32][4], float gs,
                                                float* __restrict__ C, int M, int N, int m0,
                                                int n0) {
  constexpr int NT = BN / 32;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int col = n0 + wn * (BN / 4) + 2 * tg * NT;
  if (col >= N) return;   // N % 16 == 0: the 2NT columns are all in or all out
#pragma unroll
  for (int mt = 0; mt < G; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + SBM * mt + g + 8 * h;
      if (row >= M) continue;
      float v[2 * NT];   // column p is acc[mt][p % NT][2h + p / NT]
#pragma unroll
      for (int p = 0; p < 2 * NT; ++p) v[p] = acc[mt][p % NT][2 * h + p / NT] * gs;
      float4* dst = reinterpret_cast<float4*>(C + (size_t)row * N + col);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i)
        dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
}

}  // namespace
