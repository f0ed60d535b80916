// Shared helpers for the paged-attention kernels (decode_attention.cu,
// prefill_attention.cu): element loads and stores, 16-byte row staging into
// padded shared-memory tiles, warp reductions, and the Ampere/Hopper PTX
// the bf16 kernels are built from (cp.async, ldmatrix, mma.sync).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace smg {

constexpr float NEG_INF = -1e30f;  // same sentinel as the reference ops

// ---- asynchronous copies (cp.async, sm_80+) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1.  `src_bytes` 0 writes
// zeros instead (nothing is read from `src`, which must still be a valid
// address): dead rows and padding columns are zero-filled this way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- tensor-core fragments (ldmatrix + mma.sync m16n8k16, bf16 -> f32) ----

// Four 8x8 b16 matrices; lane l gives the shared address of row l % 8 of
// matrix l / 8, and register i receives matrix i's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: B fragments of a row-major [k, n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] @ b[16x8], bf16 inputs, f32 accumulate.  Not
// volatile: a register-only operation the compiler may schedule freely, so
// it can issue the (volatile, ordered) ldmatrix loads of later fragments
// before the products that wait on earlier ones.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16x2 register (lo in the low half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp(x - m) for online softmax with m possibly -inf (no live key yet):
// then every term is 0, never NaN.
__device__ __forceinline__ float exp_shifted(float x, float m) {
  return m == -INFINITY ? 0.f : expf(x - m);
}

// Eight consecutive floats (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
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

// Dynamic shared memory above the 48 KB default needs an explicit opt-in;
// the kernels' few bytes of static shared memory count against the same
// default, so opt in a little below it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 47 * 1024) return cudaSuccess;
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
