// The 64-row (prefill) high-precision FP4 dequant + GEMM tile body for
// Hopper (sm_90a):
//     C[m, n] = f32((A[m, :] @ dequant(W, S)[:, n]) * gs),  A and C f32
// for the (64, BN) output tiles of one CTA, on fp4_gemm.cuh's packed
// operands with f32 A. fp4_gemm_hp.cu runs it for the 64-row tiles of
// pk_fp4_gemm_hp (G = 1) and pk_fp4_gemm_hp_wc (G = HP_WC_GROUP = 2
// m-tiles a CTA). It replaces, at prefill block sizes, the
// high_precision=True instances of the TPU kernels
// petit_kernel_tpu/ops/kernels/fused.py:195 _fused_kernel (:230-252) and
// :259 _fused_kernel_wc (:302-312).
//
// What bounds it: the tensor cores. An f32-accurate product over
// bf16-exact weights takes three bf16 passes, one a part of A (split3,
// fp4_stream.cuh: hi + mid + lo == a), so the four Llama-3-8B projections
// at m = 2048 are 3 x 8.93e11 operations, 2.710 ms at 989 TFLOP/s; their
// bytes (f32 A, the packed weights, f32 C) take a twentieth of that. Only
// wgmma reaches the tensor cores' rate, and the split, the decode, the
// copies and the adds of each chunk's part have to run under it. What the
// design does, on fp4_wgmma.cuh's pieces:
//   - its ring and unit order unchanged: 64-deep units of contiguous
//     natural k (unit_k0), the words and scales two stages deep one step
//     ahead (wg_load_ws), B decoded two values an operation into three
//     128-byte-swizzled B slots one unit ahead of its wgmmas (wg_words,
//     wg_decode), fence.proxy.async before each unit's barrier;
//   - A: per unit, the 64 rows x 64 k of f32 of each m-tile copied by
//     16-byte cp.async pieces (zero past M and K) into rows of HW_LDA = 72
//     floats: 72 mod 32 = 8, so the float2 fragment loads of a half-warp
//     (rows g < 4, floats 2tg) fall on 32 different banks. A goes to
//     registers, not to a descriptor, so it needs no swizzle;
//   - per 16-deep chunk each warp loads its four float2 of the m64 A
//     fragment (mma.sync m16n8k16's layout, which register-A wgmma takes)
//     and splits them into hi, mid and lo (12 registers); after
//     wgmma.fence three register-A wgmmas, lo with scale_d = 0 (a fresh
//     part, no zeroing), then mid and hi, make one group; once the group
//     has retired its part is added to acc with one __fadd_rn (the MMA's
//     own accumulation truncates, and over k / 16 chunks that bias would
//     outgrow an f32 sum's error);
//   - the next group is issued before the last one's part is added: two
//     parts of 32 floats in turn and wgmma.wait_group 1. At BN = 64 they
//     alternate over chunks; at BN = 128 (two 64-float parts beside a
//     64-float accumulator would pass the 255-register cap) over the two
//     64-column halves of each chunk, m64n64k16 each, B's descriptor 64
//     rows on for the second. The A registers of a group in flight are not
//     written until its wait, so chunks alternate two register sets too.
//     Each step drains its groups (wgmma.wait_group 0) before the loop's
//     back-edge: carried across it, a group in flight made ptxas serialize
//     every wgmma of the body without a message, 1.09-1.23x the time
//     (PERF.md section 6);
//   - every output element sums its k in one order, unit by unit (block
//     c, half g, quarter j), chunk q = 0 .. 3, lo, mid, hi into a fresh
//     part, one rounded add: the same order whatever G, so the weight
//     cache gives the plain tile's bits; G warpgroups share each decoded B.
// Every instance fits the 232,448 bytes a block may use (HpWgPlan's
// static_asserts): (64, 1) takes two CTAs an SM, the others one, and the A
// lookahead is picked for the most CTAs an SM, as WgPlan picks it.
// Measured (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W): 42% of
// the bound for the weight cache at 64x128, 28% for the plain tile; what
// holds it there is each chunk's add of its part on the path from one
// group to the next, with one or two warpgroups an SM (edited copies
// without the adds take 0.54-0.55 of the time, without the MMAs
// 0.65-0.78).

#pragma once

#include "fp4_wgmma.cuh"

namespace {

constexpr int HW_LDA = 72;   // floats of an f32 A slot row: 64 k + 8 (bank spread)

// shared-memory plan of fp4_hp_wgmma_tile<BN, G>: A slots of f32 rows,
// then fp4_wgmma_tile's B slots and word/scale stages; every slot a
// multiple of 1024 bytes, so the B slots keep the swizzle atom's alignment
template <int BN, int G>
struct HpWgPlan {
  static constexpr int threads = THREADS * G;
  static constexpr int a_slot = G * WG_BM * HW_LDA * 4;   // one unit of G m-tiles
  static constexpr int b_slot = WgPlan<BN, G>::b_slot;
  static constexpr int ws_stage = WgPlan<BN, G>::ws_stage;
  static constexpr int fixed = WG_B_SLOTS * b_slot + 2 * ws_stage + 1024;   // + alignment
  // A lookahead in units, with da + 2 A slots: the deepest of 3, 2, 1 that
  // keeps the most CTAs an SM
  static constexpr int blocks = wg_blocks(3 * a_slot + fixed);
  static constexpr int da = wg_blocks(5 * a_slot + fixed) >= blocks   ? 3
                            : wg_blocks(4 * a_slot + fixed) >= blocks ? 2
                                                                      : 1;
  static constexpr int a_slots = da + 2;
  static constexpr int bytes = a_slots * a_slot + fixed;
  static_assert(G == 1 || G == HP_WC_GROUP, "G");
  static_assert(a_slot % 1024 == 0 && blocks >= 1 && bytes <= WG_SMEM_LIMIT, "shared memory");
};
static_assert(HpWgPlan<64, 1>::bytes == 101376 && HpWgPlan<64, 1>::da == 1 &&
                  HpWgPlan<64, 1>::blocks == 2 && HpWgPlan<128, 1>::bytes == 183296 &&
                  HpWgPlan<128, 1>::da == 3 && HpWgPlan<128, 1>::blocks == 1 &&
                  HpWgPlan<64, 2>::bytes == 230400 && HpWgPlan<64, 2>::da == 3 &&
                  HpWgPlan<64, 2>::blocks == 1 && HpWgPlan<128, 2>::bytes == 201728 &&
                  HpWgPlan<128, 2>::da == 1 && HpWgPlan<128, 2>::blocks == 1,
              "the high-precision wgmma plan");

// cp.async the f32 A of unit u, natural k unit_k0 .. + 63, for the G*64
// rows from m0 into `slot`: piece a (4 k) of row r to floats r*HW_LDA + 4a
template <int G>
__device__ __forceinline__ void hw_load_a(unsigned char* slot, const float* __restrict__ A,
                                          int M, int K, int KP, int m0, int u) {
  constexpr int NTH = THREADS * G;
  float* As = reinterpret_cast<float*>(slot);
  const int k0 = unit_k0(KP, u);
#pragma unroll
  for (int i = 0; i < G * WG_BM * 16 / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, r = e >> 4, a = e & 15;
    const int kn = k0 + a * 4;
    const bool ok = m0 + r < M && kn < K;
    cp_async16(As + r * HW_LDA + a * 4, ok ? A + (size_t)(m0 + r) * K + kn : A, ok);
  }
}

// the three bf16 parts of the thread's A fragment of a chunk: p is its
// first value (row 16w + g, k 16q + 2tg of the unit)
__device__ __forceinline__ void hw_a_frag(const float* p, uint32_t (&hi)[4], uint32_t (&mid)[4],
                                          uint32_t (&lo)[4]) {
  split3(*reinterpret_cast<const float2*>(p), hi[0], mid[0], lo[0]);
  split3(*reinterpret_cast<const float2*>(p + 8 * HW_LDA), hi[1], mid[1], lo[1]);
  split3(*reinterpret_cast<const float2*>(p + 8), hi[2], mid[2], lo[2]);
  split3(*reinterpret_cast<const float2*>(p + 8 * HW_LDA + 8), hi[3], mid[3], lo[3]);
}

// The running state of a warpgroup: acc, the two parts and the two A
// register sets (hi, mid, lo) the groups in flight read
template <int BN>
struct HwRegs {
  float acc[BN / 2];
  float part[2][32];
  uint32_t a[2][3][4];
};

// after a wait: add part[t & 1], the part of group t (columns 64 * (t % H)
// .. + 63 of the tile), into acc
template <int BN>
__device__ __forceinline__ void hw_add(HwRegs<BN>& r, int t) {
  constexpr int H = BN / 64;
  fence_acc(r.part[0]);
  fence_acc(r.part[1]);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    r.acc[32 * (t % H) + i] = __fadd_rn(r.acc[32 * (t % H) + i], r.part[t & 1][i]);
}

// Unit u = 4 * step + J: decode into B slot u % 3, wait for A(u), then
// queue the copies of A(u + DA) (and, at J = 0, the words and scales of
// step + 1) and run the unit's groups: chunk q, half h is group t = qH + h
// of the unit (H = BN / 64 halves), part t & 1, A registers q & 1.
template <int J, int BN, int G>
__device__ __forceinline__ void hw_unit(const WgRing& ring, const __nv_bfloat16* Ss,
                                        const uint32_t (&lo)[WgDecode<BN, G>::CW][4],
                                        const uint32_t (&hi)[WgDecode<BN, G>::CW][4],
                                        HwRegs<BN>& r, const float* __restrict__ A,
                                        const uint32_t* __restrict__ W,
                                        const __nv_bfloat16* __restrict__ S, int M, int N, int K,
                                        int KP, int m0, int n0, int step) {
  using P = HpWgPlan<BN, G>;
  constexpr int H = BN / 64;
  const int u = 4 * step + J, units = KP / KSTEP * 4;
  unsigned char* bq = ring.b + (u % WG_B_SLOTS) * P::b_slot;
  wg_decode<J, BN, G>(bq, Ss, lo, hi);
  cp_async_wait<P::da - 1>();   // A(u) and, at J = 3, the next step's words have landed
  fence_proxy_async();
  __syncthreads();              // B(u) complete; every warp is past the groups of u - 2
  if (u + P::da < units)
    hw_load_a<G>(ring.a + ((u + P::da) % P::a_slots) * P::a_slot, A, M, K, KP, m0, u + P::da);
  if (J == 0 && step + 1 < KP / KSTEP)
    wg_load_ws<BN, G>(ring.ws + ((step + 1) & 1) * P::ws_stage, W, S, N, KP, n0, step + 1);
  cp_async_commit();
  // warp w of the CTA: m-tile w / 4, its rows 16(w % 4) .. + 15
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* a_ptr = reinterpret_cast<const float*>(ring.a + (u % P::a_slots) * P::a_slot) +
                       (16 * w + (lane >> 2)) * HW_LDA + 2 * (lane & 3);
  const uint64_t desc_b = sw128_desc(bq);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t(&f)[3][4] = r.a[q & 1];
    hw_a_frag(a_ptr + 16 * q, f[0], f[1], f[2]);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int t = q * H + h;
      // chunk q: 32 bytes further along B's rows; half h: 64 rows on
      const uint64_t b = desc_b + h * (WG_BM * WG_ROW >> 4) + 2 * q;
      fence_acc(r.part[0]);
      fence_acc(r.part[1]);
      wgmma_fence();
      wgmma_bf16_rs(r.part[t & 1], f[2], b, 0);
      wgmma_bf16_rs(r.part[t & 1], f[1], b, 1);
      wgmma_bf16_rs(r.part[t & 1], f[0], b, 1);
      wgmma_commit();
      wgmma_wait<1>();
      // group t - 1, this unit's or the last of unit u - 1 (none before a
      // step's first group: the step before drained its groups)
      if (J > 0 || t > 0) hw_add(r, t + 4 * H - 1);
    }
  }
}

// The G tiles (m0 + 64i, n0), i < G, of one matrix, by one CTA of
// HpWgPlan<BN, G>::threads threads with HpWgPlan<BN, G>::bytes bytes of
// dynamic shared memory at `smem`; warpgroup i owns m-tile i.
template <int BN, int G>
__device__ __forceinline__ void fp4_hp_wgmma_tile(
    unsigned char* smem, const float* __restrict__ A, const uint32_t* __restrict__ W,
    const __nv_bfloat16* __restrict__ S, const float* __restrict__ gs, float* __restrict__ C,
    int M, int N, int K, int KP, int m0, int n0) {
  using P = HpWgPlan<BN, G>;
  using D = WgDecode<BN, G>;
  static_assert(BN == 64 || BN == 128, "BN");
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  WgRing ring;
  ring.a = smem + ((1024u - (base & 1023u)) & 1023u);
  ring.b = ring.a + P::a_slots * P::a_slot;
  ring.ws = ring.b + WG_B_SLOTS * P::b_slot;
  const int steps = KP / KSTEP;

  HwRegs<BN> r;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) r.acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) r.part[0][i] = r.part[1][i] = 0.f;

  // groups 0 .. da - 1: A of units 0 .. da - 1 (da < 4 <= units), step
  // 0's words and scales with the first
#pragma unroll
  for (int v = 0; v < P::da; ++v) {
    if (v == 0) wg_load_ws<BN, G>(ring.ws, W, S, N, KP, n0, 0);
    hw_load_a<G>(ring.a + v * P::a_slot, A, M, K, KP, m0, v);
    cp_async_commit();
  }
  cp_async_wait<P::da - 1>();
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(ring.ws + (step & 1) * P::ws_stage);
    const __nv_bfloat16* Ss = reinterpret_cast<const __nv_bfloat16*>(Ws + WROWS * BN);
    uint32_t lo[D::CW][4], hi[D::CW][4];
    wg_words<BN, G>(Ws, lo, hi);
    hw_unit<0, BN, G>(ring, Ss, lo, hi, r, A, W, S, M, N, K, KP, m0, n0, step);
    hw_unit<1, BN, G>(ring, Ss, lo, hi, r, A, W, S, M, N, K, KP, m0, n0, step);
    hw_unit<2, BN, G>(ring, Ss, lo, hi, r, A, W, S, M, N, K, KP, m0, n0, step);
    hw_unit<3, BN, G>(ring, Ss, lo, hi, r, A, W, S, M, N, K, KP, m0, n0, step);
    // drain: a group in flight across the loop's back-edge makes ptxas
    // serialize every wgmma of the body (a wait after each, no message)
    wgmma_wait<0>();
    hw_add(r, 4 * (BN / 64) - 1);   // the step's last group
  }

  // epilogue: f32(acc * gs), the TPU kernel's order (fused.py:254-256).
  // acc[4i + e] of warp w, lane l: row 16w + l/4 (+ 8 for e >= 2), column
  // 8i + 2(l % 4) + (e & 1)
  const float s = *gs;
  const int lane = threadIdx.x & 31;
  const int row = m0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    if (col >= N) continue;
    if (row < M)
      *reinterpret_cast<float2*>(C + (size_t)row * N + col) =
          make_float2(r.acc[4 * i] * s, r.acc[4 * i + 1] * s);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(C + (size_t)(row + 8) * N + col) =
          make_float2(r.acc[4 * i + 2] * s, r.acc[4 * i + 3] * s);
  }
}

}  // namespace
