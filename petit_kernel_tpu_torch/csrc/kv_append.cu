// In-place KV write (sm_90a): one append body, kv_append_kernel<CAST>, for
// three cache layouts, K and V of a (B, T) chunk in one launch:
//   pk_kv_append         flat (B, S, Hkv, d):   cache[b, pos[b, t]] = new[b, t]
//   pk_kv_append_headed  headed (B, Hkv, S, d): cache[b, :, pos[b, t]] = new[b, t]
//   pk_kv_append_paged   pool (P, Hkv, ps, d) through block-table rows:
//                        pool[table[b, p / ps], :, p % ps] = new[b, t], p = pos[b, t]
// Flat and headed: rows with mask[b] == 0, and positions outside [0, S),
// leave the cache untouched, bit for bit. Paged: a row with mask[b] == 0
// writes its last token to the scratch page (the pool's last, P - 1) at
// offset 0, as the JAX package's scatter redirects it (which of a chunk's
// tokens lands there is unordered in the JAX package; here the last); a
// position below 0 or whose page index lies past the table's width, or a
// table entry outside [0, P), writes nothing.
//
// Replaces the TPU kernels petit_kernel_tpu/ops/kernels/attention.py:
// _kv_append_kernel and _kv_append_kernel_headed (reached through
// kv_append(headed=False/True), one token a sequence; the chunk write of
// petit_kernel_tpu/models/llama.py's attention is a dynamic_update_slice),
// and the XLA scatter of petit_kernel_tpu/models/paged.py:_write_kv. The
// TPU kernels aliased the cache through pallas_call; here the cache is a
// plain device buffer updated in place. The headed TPU kernel spliced the
// row into u32 words because Mosaic cannot store a narrow dtype at a
// dynamic sublane; a CUDA thread stores any 16-byte word.
//
// What bounds it: launch latency. A decode step writes a few KB a layer
// (2 * B * Hkv * d cache elements), about 1/150 of one launch's time at
// 3.35 TB/s, so the design keeps the whole write in one launch with no
// host work and nothing launched around it: the new rows are read through
// their batch, token and head strides (the fused qkv projection's K and V
// views need no copy), positions are read as int32 or int64 and the mask
// as a 1- or 4-byte flag or not at all (a null pointer keeps every row),
// and bf16 rows bound for an fp8 cache are rounded in registers. Nothing
// is read on the host, allocated or kept in shared memory, so a CUDA
// graph replays the launch with new positions written into the same
// tensors. A CTA writes one (b, t) token; each thread stores one unit of
// a head's K row and the same unit of its V row, neighbouring threads
// neighbouring units: 16 bytes of a copy, 8 fp8 bytes rounded from one
// 16-byte load of bf16.
//
// The fp8 rounding equals torch's cast to float8_e4m3fn (c10's
// fp8e4m3fn_from_fp32_value) bit for bit: cvt.rn.satfinite.e4m3x2.f32
// rounds to nearest even, subnormals exact, -0 kept, and saturates past
// 464 to +-448; the lanes past 464 (inf and NaN included) are then set by
// c10's rule: NaN to 0x7F with the sign, finite overflow by the caller's
// `cast`, 1 to NaN (0x7F with the sign, the rule of torch's older
// releases and of the JAX package) or 2 to +-448 (0x7E with the sign,
// torch's saturating rule). The wrapper passes the installed torch's
// rule. On an H100 (700 W) this took a headed fp8 write of one token, B =
// 8, from about 3.2 us a launch in a CUDA graph with c10's integer routine
// and 16-byte units to about 2.5 us; the bf16 copy takes about 2.0-2.1
// us, an empty kernel about 1.4-1.5 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// The launch's arguments, in the order the kernel first reads them.
struct AppendArgs {
  const void* pos;          // (B, T) int32 or int64, through strides
  long long pos_sb, pos_st;
  int pos_bytes, mask_bytes;
  const void* mask;         // (B,) 1- or 4-byte flags, or null
  long long mask_sb;
  const int* table;         // (B, max_pages) page ids, or null: page b
  long long table_sb;
  int T, ps;                // ps: positions a page (S for flat and headed)
  int pages, max_pages;     // pool pages (scratch last), table width
  const uint8_t* kn;        // new rows, (B, T, Hkv, d) through strides
  const uint8_t* vn;
  long long k_sb, k_st, k_sh;               // new rows' element strides
  long long v_sb, v_st, v_sh;
  uint8_t* ck;              // cache bases
  uint8_t* cv;
  long long page_stride, head_stride, row_stride;   // cache element strides
  int Hkv, row_words;       // row_words: a thread's units a cache row
  int src_elt, dst_elt, saturate;
};

// Four fp8 bytes from two words of two bf16 each, element order kept:
// the hardware's round to nearest even (satfinite: +-448 past 464), then
// the lanes past 464, inf and NaN set by c10's rule (NaN keeps its sign).
__device__ __forceinline__ uint32_t fp8x4(uint32_t a, uint32_t b, int saturate) {
  uint32_t r;
  asm("{.reg .b16 l, h;\n\t"
      "cvt.rn.satfinite.e4m3x2.f32 l, %2, %1;\n\t"
      "cvt.rn.satfinite.e4m3x2.f32 h, %4, %3;\n\t"
      "mov.b32 %0, {l, h};\n\t}"
      : "=r"(r)
      : "f"(__uint_as_float(a << 16)), "f"(__uint_as_float(a & 0xFFFF0000u)),
        "f"(__uint_as_float(b << 16)), "f"(__uint_as_float(b & 0xFFFF0000u)));
  const uint32_t e[4] = {a & 0xFFFFu, a >> 16, b & 0xFFFFu, b >> 16};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t mag = e[i] & 0x7FFFu;
    if (mag > 0x43E8u) {                    // past 464: NaN or +-448
      const uint32_t v = ((mag > 0x7F80u || !saturate) ? 0x7Fu : 0x7Eu) |
                         ((e[i] >> 8) & 0x80u);
      r = (r & ~(0xFFu << (8 * i))) | (v << (8 * i));
    }
  }
  return r;
}

// A thread's unit of the cache row: 16 bytes of a copy, 8 fp8 bytes of a
// cast (from 16 bytes of bf16).
template <bool CAST>
struct Unit {
  static constexpr int bytes = CAST ? 8 : 16;
  using Word = typename std::conditional<CAST, uint2, uint4>::type;
};

// The unit of a cache row that a thread stores, from 16 bytes of new row.
template <bool CAST>
__device__ __forceinline__ typename Unit<CAST>::Word to_cache(uint4 x, int saturate) {
  if constexpr (CAST)
    return make_uint2(fp8x4(x.x, x.y, saturate), fp8x4(x.z, x.w, saturate));
  else
    return x;
}

// A CTA a (t, b) token; thread i stores unit i of its K row and of its V
// row, (head, unit of the row), neighbouring threads neighbouring units.
template <bool CAST>
__global__ void __launch_bounds__(kThreads) kv_append_kernel(const AppendArgs a) {
  using Word = typename Unit<CAST>::Word;
  const int t = blockIdx.x, b = blockIdx.y;
  const long long ip = b * a.pos_sb + t * a.pos_st;
  const long long p = a.pos_bytes == 8 ? static_cast<const long long*>(a.pos)[ip]
                                       : static_cast<const int*>(a.pos)[ip];
  bool keep = true;
  if (a.mask != nullptr) {
    const long long im = b * a.mask_sb;
    keep = a.mask_bytes == 4 ? static_cast<const int*>(a.mask)[im] != 0
                             : static_cast<const uint8_t*>(a.mask)[im] != 0;
  }
  long long page, off;
  if (a.table == nullptr) {                 // flat or headed: page b of S
    if (!keep || p < 0 || p >= a.ps) return;
    page = b;
    off = p;
  } else if (keep) {
    if (p < 0 || p / a.ps >= a.max_pages) return;
    page = a.table[b * a.table_sb + p / a.ps];
    if (page < 0 || page >= a.pages) return;
    off = p % a.ps;
  } else {                                  // masked: the scratch page
    if (t != a.T - 1) return;
    page = a.pages - 1;
    off = 0;
  }
  const long long dst0 = (page * a.page_stride + off * a.row_stride) * a.dst_elt;
  const uint8_t* kn = a.kn + (b * a.k_sb + t * a.k_st) * a.src_elt;
  const uint8_t* vn = a.vn + (b * a.v_sb + t * a.v_st) * a.src_elt;
  for (int u = threadIdx.x; u < a.Hkv * a.row_words; u += blockDim.x) {
    const int h = u / a.row_words, w = u - h * a.row_words;
    const uint4 xk = reinterpret_cast<const uint4*>(kn + h * a.k_sh * a.src_elt)[w];
    const uint4 xv = reinterpret_cast<const uint4*>(vn + h * a.v_sh * a.src_elt)[w];
    const long long dst = dst0 + h * a.head_stride * a.dst_elt + w * Unit<CAST>::bytes;
    *reinterpret_cast<Word*>(a.ck + dst) = to_cache<CAST>(xk, a.saturate);
    *reinterpret_cast<Word*>(a.cv + dst) = to_cache<CAST>(xv, a.saturate);
  }
}

// Checks what the 16-byte loads need, then launches grid (T, B).
// elt: the cache's element bytes (2 bf16, 1 fp8); cast: 0 copies rows of
// the cache's dtype, 1 or 2 round bf16 rows into an fp8 cache (overflow
// to NaN, or saturated).
int launch_append(AppendArgs a, int B, int d, int elt, int cast, cudaStream_t st) {
  if (B <= 0 || a.T <= 0) return static_cast<int>(cudaSuccess);
  if (cast < 0 || cast > 2 || (cast != 0 && elt != 1) || (elt != 1 && elt != 2) ||
      (d * elt) % 16 != 0 || B > 65535 || a.Hkv <= 0 ||
      (a.pos_bytes != 4 && a.pos_bytes != 8) ||
      (a.mask != nullptr && a.mask_bytes != 1 && a.mask_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dst_elt = elt;
  a.src_elt = cast ? 2 : elt;
  a.saturate = cast == 2;
  a.row_words = d * elt / (cast ? Unit<true>::bytes : 16);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.ck) | reinterpret_cast<uintptr_t>(a.cv) |
                         reinterpret_cast<uintptr_t>(a.kn) | reinterpret_cast<uintptr_t>(a.vn);
  const long long strides = (a.k_sb | a.k_st | a.k_sh | a.v_sb | a.v_st | a.v_sh) * a.src_elt;
  if ((ptrs % 16) != 0 || (strides % 16) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int units = a.Hkv * a.row_words;
  const int threads = units >= kThreads ? kThreads : (units + 31) / 32 * 32;
  const dim3 grid(a.T, B);
  if (cast)
    kv_append_kernel<true><<<grid, threads, 0, st>>>(a);
  else
    kv_append_kernel<false><<<grid, threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

AppendArgs new_rows(const void* kn, const void* vn, const void* pos, const void* mask,
                    int T, int Hkv, long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh, long long pos_sb,
                    long long pos_st, int pos_bytes, int mask_bytes, long long mask_sb) {
  AppendArgs a{};
  a.kn = static_cast<const uint8_t*>(kn);
  a.vn = static_cast<const uint8_t*>(vn);
  a.pos = pos;
  a.mask = mask;
  a.k_sb = k_sb, a.k_st = k_st, a.k_sh = k_sh;
  a.v_sb = v_sb, a.v_st = v_st, a.v_sh = v_sh;
  a.pos_sb = pos_sb, a.pos_st = pos_st;
  a.pos_bytes = pos_bytes, a.mask_bytes = mask_bytes, a.mask_sb = mask_sb;
  a.T = T;
  a.Hkv = Hkv;
  return a;
}

}  // namespace

// Flat (B, S, Hkv, d) cache. k_*/v_* are the new rows' element strides
// (batch, token, head; the last dimension is contiguous), pos_* the
// positions' (batch, token); a stride of a dimension of size 1 may be 0.
extern "C" int pk_kv_append(void* ck, void* cv, const void* kn, const void* vn,
                            const void* pos, const void* mask, int B, int T, int S,
                            int Hkv, int d, int elt, int cast, long long k_sb,
                            long long k_st, long long k_sh, long long v_sb, long long v_st,
                            long long v_sh, long long pos_sb, long long pos_st,
                            int pos_bytes, int mask_bytes, long long mask_sb,
                            void* stream) {
  AppendArgs a = new_rows(kn, vn, pos, mask, T, Hkv, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                          pos_sb, pos_st, pos_bytes, mask_bytes, mask_sb);
  a.ck = static_cast<uint8_t*>(ck);
  a.cv = static_cast<uint8_t*>(cv);
  a.ps = S;
  a.page_stride = static_cast<long long>(S) * Hkv * d;
  a.head_stride = d;
  a.row_stride = static_cast<long long>(Hkv) * d;
  return launch_append(a, B, d, elt, cast, static_cast<cudaStream_t>(stream));
}

// Headed (B, Hkv, S, d) cache, bf16 or fp8; the same arguments.
extern "C" int pk_kv_append_headed(void* ck, void* cv, const void* kn, const void* vn,
                                   const void* pos, const void* mask, int B, int T, int S,
                                   int Hkv, int d, int elt, int cast, long long k_sb,
                                   long long k_st, long long k_sh, long long v_sb,
                                   long long v_st, long long v_sh, long long pos_sb,
                                   long long pos_st, int pos_bytes, int mask_bytes,
                                   long long mask_sb, void* stream) {
  AppendArgs a = new_rows(kn, vn, pos, mask, T, Hkv, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                          pos_sb, pos_st, pos_bytes, mask_bytes, mask_sb);
  a.ck = static_cast<uint8_t*>(ck);
  a.cv = static_cast<uint8_t*>(cv);
  a.ps = S;
  a.page_stride = static_cast<long long>(Hkv) * S * d;
  a.head_stride = static_cast<long long>(S) * d;
  a.row_stride = d;
  return launch_append(a, B, d, elt, cast, static_cast<cudaStream_t>(stream));
}

// Paged pool (P, Hkv, ps, d), bf16 or fp8, its last page the scratch page;
// table: int32 block-table rows (B, max_pages) at row stride table_sb.
extern "C" int pk_kv_append_paged(void* kp, void* vp, const void* table, const void* kn,
                                  const void* vn, const void* pos, const void* mask, int B,
                                  int T, int P, int ps, int max_pages, long long table_sb,
                                  int Hkv, int d, int elt, int cast, long long k_sb,
                                  long long k_st, long long k_sh, long long v_sb,
                                  long long v_st, long long v_sh, long long pos_sb,
                                  long long pos_st, int pos_bytes, int mask_bytes,
                                  long long mask_sb, void* stream) {
  if (table == nullptr || P <= 0 || ps <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AppendArgs a = new_rows(kn, vn, pos, mask, T, Hkv, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                          pos_sb, pos_st, pos_bytes, mask_bytes, mask_sb);
  a.ck = static_cast<uint8_t*>(kp);
  a.cv = static_cast<uint8_t*>(vp);
  a.table = static_cast<const int*>(table);
  a.table_sb = table_sb;
  a.ps = ps;
  a.pages = P;
  a.max_pages = max_pages;
  a.page_stride = static_cast<long long>(Hkv) * ps * d;
  a.head_stride = static_cast<long long>(ps) * d;
  a.row_stride = d;
  return launch_append(a, B, d, elt, cast, static_cast<cudaStream_t>(stream));
}

// Text of a CUDA error code returned by the pk_* entries.
extern "C" const char* pk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
