// Paged prefill attention for chunked, prefix-aware prefill — hand-written
// Hopper (sm_90a) kernel, with a sequence axis so one launch serves every
// row of a grouped prefill.
//
// Replaces the TPU kernel smg_tpu/ops/pallas/prefill_attention.py,
// paged_attention_prefill (body _prefill_kernel).  Same function as the
// plain version (gather_seq_kv + attention_prefill in
// smg_tpu_torch/ops/attention.py): for each sequence, chunk token t (at
// position prefix_len + t) attends (a) the cached prefix [0, prefix_len)
// through its page table and (b) the chunk's own keys c <= t, c < t_real,
// read from the chunk K/V rather than the cache, in one online softmax
// (f32 state); GQA, tanh softcap, per-row sliding window.  Chunk keys at
// positions >= mp*ps are masked, as the gather path drops them (the Pallas
// kernel documents attending them instead).  Rows of a query tile that lies
// wholly past t_real are written as zeros: they are padding whose output
// the model discards.
//
// What bounds it on an H100: at the chunk sizes the engine runs (T up to
// 4096 per chunk) the score and p @ V products dominate — ~4*T*S*H*D flops
// against (T + S)*K*D*2 bytes of K/V — so the floor is operations at the
// 989 TFLOP/s bf16 tensor-core peak; short chunks over a long prefix fall
// back under the bytes floor.  The design: one block per (64-row query tile
// of tokens x the G heads of one KV head, KV head, sequence), so K/V rows
// are staged once into shared memory for G*TQ query rows; the score and
// p @ V loops keep 4x4 and 8xD/32 register micro-tiles to cut shared-memory
// traffic per FMA; the loop starts at the window's first live key, so
// out-of-window prefix pages are never read.  This first version uses plain
// FMA in f32 — far from the tensor-core floor.  Moving the two products onto
// mma.sync/wgmma with TMA-fed tiles is the redesign later work does.

#include "common.cuh"

using namespace smg;

namespace {

constexpr int PF_THREADS = 256;
constexpr int PF_R = 64;   // query rows (token x head-in-group) per block
constexpr int PF_TK = 64;  // key rows per staged tile

template <typename T, int DC>  // DC = ceil(D / 32) rounded up to a power of two
__global__ void __launch_bounds__(PF_THREADS) prefill_kernel(
    const T* __restrict__ q,        // [Gs, Tn, H, D]
    const T* __restrict__ ck,       // [Gs, Tn, K*D] chunk keys
    const T* __restrict__ cv,
    const T* __restrict__ k_cache,  // [L, P, ps, K*D]
    const T* __restrict__ v_cache,
    const int* __restrict__ page_tables,  // [Gs, mp]
    const int* __restrict__ prefix_lens,  // [Gs]
    const int* __restrict__ t_reals,      // [Gs]
    T* __restrict__ out,            // [Gs, Tn, H, D]
    int Tn, int H, int K, int D, int P, int ps, int mp, int layer, int window,
    float scale, float softcap, int TQ) {
  const int qt = blockIdx.x, kh = blockIdx.y, seq = blockIdx.z;
  const int G = H / K;
  const int KD = K * D;
  const int RS = row_stride<T>(D);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t0 = qt * TQ;
  const int R = TQ * G;  // live query rows of this block (<= PF_R)
  const int prefix = prefix_lens[seq];
  const int t_real = t_reals[seq];
  const int total = mp * ps;

  // query row r <-> token t0 + r / G, head kh*G + r % G
  auto out_row = [&](int r) -> T* {
    return out + (((size_t)seq * Tn + t0 + r / G) * H + kh * G + r % G) * D;
  };
  auto row_live = [&](int r) { return r < R && t0 + r / G < Tn; };

  if (t0 >= t_real) {  // an all-padding tile
    for (int i = tid; i < PF_R * D; i += PF_THREADS) {
      const int r = i / D;
      if (row_live(r)) from_f(0.f, out_row(r) + i % D);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_s = reinterpret_cast<float*>(smem_raw);  // [R, TK] scores, then p
  T* q_s = reinterpret_cast<T*>(s_s + PF_R * PF_TK);  // [R, RS]
  T* k_s = q_s + PF_R * RS;                           // [TK, RS]
  T* v_s = k_s + PF_TK * RS;

  stage_tile(q_s, RS, PF_R, D,
             [&](int r) -> const T* {
               if (!row_live(r)) return nullptr;
               return q + (((size_t)seq * Tn + t0 + r / G) * H + kh * G + r % G) * D;
             },
             tid, PF_THREADS);

  // rows this warp owns in the softmax and p @ V phases: r = warp + 8*i;
  // the running max/sum are replicated in every lane of the owning warp
  float m[8], l[8], acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int* pt = page_tables + (size_t)seq * mp;
  const size_t layer_off = (size_t)layer * P * ps * KD;
  // (a) cached prefix from the earliest live query's window floor
  const int prefix_end = min(prefix, total);
  const int p_start = min(window > 0 ? max(prefix + t0 - window + 1, 0) : 0, prefix_end);
  // (b) the chunk's own keys up to the tile's last query (causal)
  const int c_end = min(min(t0 + TQ, t_real), max(total - prefix, 0));
  const int c_start = min(window > 0 ? max(t0 - window + 1, 0) : 0, c_end);
  const int n_prefix_tiles = (prefix_end - p_start + PF_TK - 1) / PF_TK;
  const int n_tiles = n_prefix_tiles + (c_end - c_start + PF_TK - 1) / PF_TK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool chunk = tile >= n_prefix_tiles;
    const int base = chunk ? c_start + (tile - n_prefix_tiles) * PF_TK
                           : p_start + tile * PF_TK;
    const int end = chunk ? c_end : prefix_end;
    auto k_row = [&](int r) -> const T* {
      const int i = base + r;
      if (i >= end) return nullptr;
      if (chunk) return ck + ((size_t)seq * Tn + i) * KD + kh * D;
      return k_cache + layer_off + ((size_t)pt[i / ps] * ps + i % ps) * KD + kh * D;
    };
    auto v_row = [&](int r) -> const T* {
      const int i = base + r;
      if (i >= end) return nullptr;
      if (chunk) return cv + ((size_t)seq * Tn + i) * KD + kh * D;
      return v_cache + layer_off + ((size_t)pt[i / ps] * ps + i % ps) * KD + kh * D;
    };
    stage_tile(k_s, RS, PF_TK, D, k_row, tid, PF_THREADS);
    stage_tile(v_s, RS, PF_TK, D, v_row, tid, PF_THREADS);
    __syncthreads();

    // scores: each thread a 4x4 micro-tile, rows (tid/16) + 16*i and keys
    // (tid%16) + 16*c, so a warp reads 16 distinct key rows (odd-word
    // stride: no bank conflicts) and 2 query rows
    {
      const int rb = tid / 16, jb = tid % 16;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = to_f(q_s[(rb + 16 * i) * RS + d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = to_f(k_s[(jb + 16 * c) * RS + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] += qv[i] * kv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + 16 * i;
        const int t = t0 + r / G;  // chunk index of this query row
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = jb + 16 * c;
          const int key = base + j;
          bool keep = row_live(r) && key < end;
          if (chunk) {
            keep = keep && key <= t && (window <= 0 || key > t - window);
          } else {
            keep = keep && (window <= 0 || key > prefix + t - window);
          }
          s_s[r * PF_TK + j] = keep ? cap_score(sc[i][c] * scale, softcap) : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax + p @ V: warp-owned rows, so only __syncwarp inside
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* sr = s_s + (warp + 8 * i) * PF_TK;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < PF_TK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? to_f(v_s[j * RS + d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = s_s[(warp + 8 * i) * PF_TK + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and s_s
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    if (!row_live(r)) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) from_f(acc[i][c] * inv, out_row(r) + d);
    }
  }
}

template <typename T, int DC>
cudaError_t launch_prefill_dc(const void* q, const void* ck, const void* cv,
                              const void* kc, const void* vc, const int* pt,
                              const int* prefix, const int* treal, void* out, int Gs,
                              int Tn, int H, int K, int D, int P, int ps, int mp,
                              int layer, int window, float scale, float softcap,
                              cudaStream_t stream) {
  const int G = H / K;
  const int TQ = PF_R / G;
  const size_t smem = sizeof(float) * (size_t)(PF_R * PF_TK) +
                      sizeof(T) * (size_t)((PF_R + 2 * PF_TK) * row_stride<T>(D));
  cudaError_t err = allow_smem(prefill_kernel<T, DC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + TQ - 1) / TQ, K, Gs);
  prefill_kernel<T, DC><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const T*>(kc), static_cast<const T*>(vc), pt, prefix, treal,
      static_cast<T*>(out), Tn, H, K, D, P, ps, mp, layer, window, scale, softcap, TQ);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prefill(const void* q, const void* ck, const void* cv, const void* kc,
                           const void* vc, const int* pt, const int* prefix,
                           const int* treal, void* out, int Gs, int Tn, int H, int K,
                           int D, int P, int ps, int mp, int layer, int window,
                           float scale, float softcap, cudaStream_t s) {
#define SMG_PREFILL(DC)                                                              \
  return launch_prefill_dc<T, DC>(q, ck, cv, kc, vc, pt, prefix, treal, out, Gs, Tn, \
                                  H, K, D, P, ps, mp, layer, window, scale, softcap, s)
  if (D <= 32) SMG_PREFILL(1);
  if (D <= 64) SMG_PREFILL(2);
  if (D <= 128) SMG_PREFILL(4);
  SMG_PREFILL(8);
#undef SMG_PREFILL
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int smg_prefill_attention(
    const void* q, const void* chunk_k, const void* chunk_v, const void* k_cache,
    const void* v_cache, const void* page_tables, const void* prefix_lens,
    const void* t_reals, void* out, int dtype, int Gs, int Tn, int H, int K, int D,
    int P, int ps, int mp, int layer, int window, float scale, float softcap,
    void* stream) {
  if (H % K != 0 || D % 8 != 0 || D > 256 || H / K > PF_R)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* pl = static_cast<const int*>(prefix_lens);
  const int* tr = static_cast<const int*>(t_reals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_prefill<float>(q, chunk_k, chunk_v, k_cache, v_cache, pt, pl, tr,
                                      out, Gs, Tn, H, K, D, P, ps, mp, layer, window,
                                      scale, softcap, s);
  if (dtype == 1)
    return (int)launch_prefill<__nv_bfloat16>(q, chunk_k, chunk_v, k_cache, v_cache, pt,
                                              pl, tr, out, Gs, Tn, H, K, D, P, ps, mp,
                                              layer, window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
