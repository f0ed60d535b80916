// Paged decode attention over a read-only cache plus the megastep's side
// buffer — hand-written Hopper (sm_90a) kernel.
//
// Replaces the TPU kernel smg_tpu/ops/pallas/decode_attention.py,
// paged_attention_decode_cached (body _decode_kernel).  Same function as the
// plain version smg_tpu_torch/ops/attention.py::attention_decode_cached:
// query b attends cache tokens [lo, entry_b) through its page table and the
// first n_extra rows of the side buffer hk/hv (positions entry_b + r), in one
// online softmax (f32 state); GQA, tanh softcap, sliding window; padded rows
// (entry_b >= mp*ps) attend the side buffer only.
//
// What bounds it on an H100: bytes.  Each cache token is read once per KV
// head (K and V rows of D elements) and does ~4*G*D flops against them, far
// below the ~295 flop/byte the card needs to be compute-bound, so the floor
// is the cache bytes over 3.35 TB/s.  The design: one block per (KV head,
// sequence) handles that head's G query heads together, so every K/V row is
// read from device memory exactly once; rows are staged into shared memory
// with coalesced 16-byte loads; the loop starts at the window's first live
// token, so out-of-window pages are never read.  The TPU-only tricks (the
// block-diagonal query fold for the 128x128 MXU, the K*D % 128 lane rule,
// the band extraction after the call) are gone.  Not done yet (later work):
// splitting a long context over several blocks (flash-decoding) so a small
// batch fills all 132 SMs, and cp.async/TMA double buffering.

#include "common.cuh"

using namespace smg;

namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_TK = 64;    // key rows per staged tile
constexpr int DEC_MAXE = 16;  // accumulator slots per thread: G*D <= 2048

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(
    const T* __restrict__ q,          // [B, H, D]
    const T* __restrict__ k_cache,    // [L, P, ps, K*D]
    const T* __restrict__ v_cache,
    const T* __restrict__ hk,         // [B, N, K*D]
    const T* __restrict__ hv,
    const int* __restrict__ page_tables,  // [B, mp]
    const int* __restrict__ entry_pos,    // [B]
    T* __restrict__ out,              // [B, H, D]
    int H, int K, int D, int P, int ps, int mp, int N, int n_extra, int layer,
    int window, float scale, float softcap) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int KD = K * D;
  const int RS = row_stride<T>(D);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [G, D]
  float* s_s = q_s + G * D;                         // [G, TK] scores, then p
  float* m_s = s_s + G * DEC_TK;                    // [G] running max
  float* l_s = m_s + G;                             // [G] running sum
  float* a_s = l_s + G;                             // [G] this tile's rescale
  T* k_s = reinterpret_cast<T*>(a_s + G);           // [TK, RS]
  T* v_s = k_s + DEC_TK * RS;

  for (int i = tid; i < G * D; i += DEC_THREADS)
    q_s[i] = to_f(q[((size_t)b * H + kh * G) * D + i]);
  for (int g = tid; g < G; g += DEC_THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[DEC_MAXE];
#pragma unroll
  for (int e = 0; e < DEC_MAXE; ++e) acc[e] = 0.f;

  const int entry = entry_pos[b];
  const int cache_end = entry >= mp * ps ? 0 : entry;  // padded row: no cache
  const int q_pos = entry + n_extra - 1;
  const int lo = window > 0 ? max(q_pos - window + 1, 0) : 0;
  const int cache_start = min(lo, cache_end);
  const int* pt = page_tables + (size_t)b * mp;
  const size_t layer_off = (size_t)layer * P * ps * KD;
  const int n_cache_tiles = (cache_end - cache_start + DEC_TK - 1) / DEC_TK;
  const int n_tiles = n_cache_tiles + (n_extra + DEC_TK - 1) / DEC_TK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool side = tile >= n_cache_tiles;
    const int base = side ? (tile - n_cache_tiles) * DEC_TK : cache_start + tile * DEC_TK;
    const int end = side ? n_extra : cache_end;
    auto k_row = [&](int r) -> const T* {
      const int i = base + r;
      if (i >= end) return nullptr;
      if (side) return hk + ((size_t)b * N + i) * KD + kh * D;
      return k_cache + layer_off + ((size_t)pt[i / ps] * ps + i % ps) * KD + kh * D;
    };
    auto v_row = [&](int r) -> const T* {
      const int i = base + r;
      if (i >= end) return nullptr;
      if (side) return hv + ((size_t)b * N + i) * KD + kh * D;
      return v_cache + layer_off + ((size_t)pt[i / ps] * ps + i % ps) * KD + kh * D;
    };
    stage_tile(k_s, RS, DEC_TK, D, k_row, tid, DEC_THREADS);
    stage_tile(v_s, RS, DEC_TK, D, v_row, tid, DEC_THREADS);
    __syncthreads();

    // scores: consecutive threads take consecutive keys of one head (the
    // odd-word row stride keeps those shared reads conflict-free)
    for (int i = tid; i < G * DEC_TK; i += DEC_THREADS) {
      const int g = i / DEC_TK, j = i % DEC_TK;
      const int key = base + j;
      const int pos = side ? entry + key : key;
      float s = NEG_INF;
      if (key < end && pos >= lo) {
        const float* qg = q_s + g * D;
        const T* kr = k_s + j * RS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qg[d] * to_f(kr[d]);
        s = cap_score(dot * scale, softcap);
      }
      s_s[i] = s;
    }
    __syncthreads();

    // online-softmax update, one warp per query head
    for (int g = warp; g < G; g += DEC_THREADS / 32) {
      float* sg = s_s + g * DEC_TK;
      float mx = NEG_INF;
      for (int j = lane; j < DEC_TK; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < DEC_TK; j += 32) {
        const float p = expf(sg[j] - m_new);
        sg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + p @ V, consecutive threads on consecutive d
#pragma unroll
    for (int e = 0; e < DEC_MAXE; ++e) {
      const int idx = tid + e * DEC_THREADS;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* p = s_s + g * DEC_TK;
        float a = acc[e] * a_s[g];
        for (int j = 0; j < DEC_TK; ++j) a += p[j] * to_f(v_s[j * RS + d]);
        acc[e] = a;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and s_s
  }

#pragma unroll
  for (int e = 0; e < DEC_MAXE; ++e) {
    const int idx = tid + e * DEC_THREADS;
    if (idx < G * D) {
      const int g = idx / D;
      from_f(acc[e] / fmaxf(l_s[g], 1e-20f), out + ((size_t)b * H + kh * G) * D + idx);
    }
  }
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc, const void* hk,
                          const void* hv, const int* pt, const int* entry, void* out,
                          int B, int H, int K, int D, int P, int ps, int mp, int N,
                          int n_extra, int layer, int window, float scale, float softcap,
                          cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) * (size_t)(G * D + G * DEC_TK + 3 * G) +
                      sizeof(T) * (size_t)(2 * DEC_TK * row_stride<T>(D));
  cudaError_t err = allow_smem(decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<dim3(K, B), DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const T*>(hk), static_cast<const T*>(hv), pt, entry,
      static_cast<T*>(out), H, K, D, P, ps, mp, N, n_extra, layer, window, scale,
      softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int smg_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* hk,
    const void* hv, const void* page_tables, const void* entry_positions, void* out,
    int dtype, int B, int H, int K, int D, int P, int ps, int mp, int N, int n_extra,
    int layer, int window, float scale, float softcap, void* stream) {
  if (H % K != 0 || D % 8 != 0 || (H / K) * D > DEC_MAXE * DEC_THREADS)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* en = static_cast<const int*>(entry_positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_decode<float>(q, k_cache, v_cache, hk, hv, pt, en, out, B, H, K,
                                     D, P, ps, mp, N, n_extra, layer, window, scale,
                                     softcap, s);
  if (dtype == 1)
    return (int)launch_decode<__nv_bfloat16>(q, k_cache, v_cache, hk, hv, pt, en, out, B,
                                             H, K, D, P, ps, mp, N, n_extra, layer,
                                             window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
