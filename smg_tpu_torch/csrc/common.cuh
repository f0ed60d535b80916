// Shared helpers for the paged-attention kernels (decode_attention.cu,
// prefill_attention.cu): element conversion, 16-byte row staging into
// padded shared-memory tiles, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smg {

constexpr float NEG_INF = -1e30f;  // same sentinel as the reference ops

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// Shared-memory row stride (elements) of a staged [rows, D] tile: one extra
// 32-bit word per row makes the stride an odd number of words, so threads
// reading the same column of consecutive rows hit distinct banks.
template <typename T>
__host__ __device__ constexpr int row_stride(int D) {
  return D + (int)(4 / sizeof(T));
}

// Stage `rows` D-element rows into a padded shared tile (row stride RS).
// `row_ptr(r)` gives row r's 16-byte aligned global address, or nullptr for
// a row past the valid range, which is zero-filled (a stale NaN there would
// poison the p @ V product even at probability 0).  Work item i is
// (row i / chunks, 16-byte chunk i % chunks), so neighbouring threads load
// neighbouring 16-byte chunks of a row: coalesced global reads.  Shared
// stores are 4 bytes wide because padded rows are only 4-byte aligned.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage_tile(T* smem, int RS, int rows, int D,
                                           RowPtr row_ptr, int tid, int nthreads) {
  const int chunks = D * (int)sizeof(T) / 16;
  for (int i = tid; i < rows * chunks; i += nthreads) {
    const int r = i / chunks, c = i % chunks;
    const T* src = row_ptr(r);
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem + r * RS) + 4 * c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) v = reinterpret_cast<const uint4*>(src)[c];
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float cap_score(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

}  // namespace smg
