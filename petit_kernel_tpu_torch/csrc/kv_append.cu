// In-place KV append (sm_90a), two entries:
//   pk_kv_append         flat (B, S, Hkv, d):   cache[b, pos[b]] = new[b]
//   pk_kv_append_headed  headed (B, Hkv, S, d): cache[b, :, pos[b]] = new[b]
// for K and V together, where mask[b] != 0. Rows with mask[b] == 0, and
// positions outside [0, S), leave the cache untouched, bit for bit.
//
// Replaces the TPU kernels petit_kernel_tpu/ops/kernels/attention.py:
// _kv_append_kernel and _kv_append_kernel_headed (reached through
// kv_append(headed=False/True)), which aliased the cache through
// pallas_call to avoid rewriting it. Here the cache is a plain device
// buffer updated in place. The headed TPU kernel spliced the row into u32
// words, because Mosaic cannot store a narrow dtype at a dynamic sublane;
// a CUDA thread stores any 16-byte word, so both entries are plain copies.
//
// What bounds it: launch latency; it moves 2 * Hkv * d * 2 bytes per
// sequence. One CTA per sequence copies its K and V rows in 16-byte words.
// The copy is dtype-blind: the wrapper casts the new rows to the cache
// dtype first (the TPU package's quantize_kv), so this kernel never rounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kv_append_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv,
                                 const uint4* __restrict__ kn,
                                 const uint4* __restrict__ vn, const int* __restrict__ pos,
                                 const int* __restrict__ mask, int S, int row_words) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (mask[b] == 0 || p < 0 || p >= S) return;
  const size_t dst = ((size_t)b * S + p) * row_words;
  const size_t src = (size_t)b * row_words;
  for (int i = threadIdx.x; i < row_words; i += blockDim.x) {
    ck[dst + i] = kn[src + i];
    cv[dst + i] = vn[src + i];
  }
}

// Headed layout: one CTA per sequence copies its Hkv rows of d elements,
// each a run of row_words 16-byte words at stride S rows.
__global__ void kv_append_headed_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv,
                                        const uint4* __restrict__ kn,
                                        const uint4* __restrict__ vn,
                                        const int* __restrict__ pos,
                                        const int* __restrict__ mask, int Hkv, int S,
                                        int row_words) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (mask[b] == 0 || p < 0 || p >= S) return;
  for (int i = threadIdx.x; i < Hkv * row_words; i += blockDim.x) {
    const int h = i / row_words, w = i % row_words;
    const size_t dst = (((size_t)b * Hkv + h) * S + p) * row_words + w;
    const size_t src = ((size_t)b * Hkv + h) * row_words + w;
    ck[dst] = kn[src];
    cv[dst] = vn[src];
  }
}

}  // namespace

extern "C" int pk_kv_append(void* ck, void* cv, const void* kn, const void* vn,
                            const void* pos, const void* mask, int B, int S, int row_bytes,
                            void* stream) {
  if (row_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_append_kernel<<<B, 128, 0, st>>>(
      static_cast<uint4*>(ck), static_cast<uint4*>(cv), static_cast<const uint4*>(kn),
      static_cast<const uint4*>(vn), static_cast<const int*>(pos),
      static_cast<const int*>(mask), S, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// row_bytes: d * element size, the bytes of one (head, position) row.
extern "C" int pk_kv_append_headed(void* ck, void* cv, const void* kn, const void* vn,
                                   const void* pos, const void* mask, int B, int Hkv, int S,
                                   int row_bytes, void* stream) {
  if (row_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_append_headed_kernel<<<B, 128, 0, st>>>(
      static_cast<uint4*>(ck), static_cast<uint4*>(cv), static_cast<const uint4*>(kn),
      static_cast<const uint4*>(vn), static_cast<const int*>(pos),
      static_cast<const int*>(mask), Hkv, S, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// Text of a CUDA error code returned by the pk_* entries.
extern "C" const char* pk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
