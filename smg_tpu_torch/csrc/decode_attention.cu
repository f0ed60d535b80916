// Paged decode attention over a read-only cache plus the megastep's side
// buffer — hand-written Hopper (sm_90a) kernels, split over the context
// (flash-decoding) with asynchronous copies.
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
// is the cache bytes over 3.35 TB/s.  Keeping HBM busy takes many bytes in
// flight on every SM, and at a small batch that needs more blocks than
// (sequence, KV head) pairs.  The design:
//  - split-KV: grid (split, KV head x head group, sequence).  Each
//    sequence's keys (window start .. entry, then its n_extra side rows) are
//    cut into equal splits of whole warp tiles, at most S (chosen by the
//    wrapper from B, K and the table capacity) and never shorter than one
//    tile per warp; blocks past a short context's last split exit at once.
//    Keys below the window are never read (a card-only test poisons them);
//  - per warp, a private cp.async pipeline of 16-byte copies gathered
//    through the page table (three stages, two at head_dim 256: one tile
//    computed while the next are in flight), so no block-wide barrier sits
//    in the key loop;
//  - bfloat16 (decode_tc_kernel): both products on the tensor cores,
//    mma.sync m16n8k16 with the G query heads of a KV head as the rows of a
//    16-row tile (padded with zero rows).  The flops are few, but issuing
//    them matters: FMA dot products with shuffle reductions take dozens of
//    warp instructions a key and kept the first split design of this
//    kernel at 0.28 ms for B=32 on an H100, against 0.12 ms on the tensor
//    cores (PERF.md).  Scores stay in registers, and P is repacked as bf16
//    A fragments (the plain version keeps P in f32);
//  - float32 (decode_fma_kernel): exact f32 FMA, lanes across head_dim (8
//    elements a lane), the heads of a group of 8 together, warp-shuffle
//    reductions — a float32 product on tensor cores would be TF32;
//  - one launch per layer: each block merges its warps in shared memory and
//    writes f32 partials (m, l, acc[GB, D]); the last block of a (sequence,
//    head group) to arrive — found by a global arrival counter that it
//    resets to 0 itself, so the buffer stays zeroed between launches with
//    no memset (and a CUDA graph could replay the kernel, given a buffer
//    that outlives the capture) — merges the partials and writes the
//    output.  A context with one split writes its output directly.
// A split with no live key (a window that ends before it, masked side rows)
// contributes m = -inf, l = 0, which the merges weigh as 0, never NaN.  Two
// launches in flight at once must not share a counter buffer: the caller
// keeps one per stream.

#include "common.cuh"

using namespace smg;

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int MAX_SPLITS = 32;  // the last block stages [splits, heads] weights in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// 2^(x - m) with m possibly -inf (no live key yet): then 0, never NaN.
__device__ __forceinline__ float exp2_shifted(float x, float m) {
  return m == -INFINITY ? 0.f : exp2f(x - m);
}

template <bool BASE2>
__device__ __forceinline__ float weight(float m_part, float m_all) {
  return BASE2 ? exp2_shifted(m_part, m_all) : exp_shifted(m_part, m_all);
}

// One sequence's key stream (cache [cache_start, cache_end), then its side
// rows) and this block's split of it.
struct Split {
  int entry, lo, lo_cache, n_cache, n_eff, k_begin, k_end;

  __device__ Split(int entry_, int mp, int ps, int n_extra, int window, int S, int tile,
                   int split) {
    entry = entry_;
    const int cache_end = entry >= mp * ps ? 0 : entry;  // padded row: no cache
    const int q_pos = entry + n_extra - 1;
    lo = window > 0 ? max(q_pos - window + 1, 0) : 0;
    const int cache_start = min(lo, cache_end);
    n_cache = cache_end - cache_start;
    lo_cache = cache_start;
    const int total = n_cache + n_extra;
    const int per = (total + S - 1) / S;
    const int split_len = max((per + tile - 1) / tile * tile, tile * DEC_WARPS);
    n_eff = (total + split_len - 1) / split_len;
    k_begin = split * split_len;
    k_end = min(total, k_begin + split_len);
  }

  // key u of the stream is attended (cache keys start at the window floor;
  // side rows may lie below it)
  __device__ bool live(int u) const {
    return u < k_end && (u < n_cache || entry + (u - n_cache) >= lo);
  }
};

// Merge the block's warps (red: [DEC_WARPS, GB, D + 2] of acc, m, l in
// shared memory), then either write the output (one split) or this split's
// partial, and let the last block to arrive merge every split's partial.
// m is in base-2 units when BASE2.
template <int GB, bool BASE2, typename T>
__device__ void merge_splits(float* red, int ng, int D, T* out, float* part, int* counter,
                             int split, int n_eff) {
  const int tid = threadIdx.x;
  const int RW = D + 2;
  const int PSZ = GB * RW;  // floats per split's partial
  for (int i = tid; i < ng * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, red[(w * GB + g) * RW + D]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = weight<BASE2>(red[(w * GB + g) * RW + D], M);
      L += f * red[(w * GB + g) * RW + D + 1];
      A += f * red[(w * GB + g) * RW + d];
    }
    if (n_eff == 1) {
      from_f(A / fmaxf(L, 1e-20f), out + (size_t)g * D + d);
    } else {
      float* pp = part + (size_t)split * PSZ + g * RW;
      pp[d] = A;
      if (d == 0) {
        pp[D] = M;
        pp[D + 1] = L;
      }
    }
  }
  if (n_eff == 1) return;

  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counter, 1);
    s_last = prev == n_eff - 1;
    if (s_last) *counter = 0;  // every split has arrived: zero for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each split's weight for each head, staged in shared memory (red is free)
  float* fac = red;  // [n_eff, GB]
  for (int i = tid; i < n_eff * ng; i += DEC_THREADS) {
    const int sp = i / ng, g = i % ng;
    fac[sp * GB + g] = __ldcg(part + (size_t)sp * PSZ + g * RW + D);
  }
  __syncthreads();
  if (tid < ng) {
    const int g = tid;
    float M = -INFINITY;
    for (int sp = 0; sp < n_eff; ++sp) M = fmaxf(M, fac[sp * GB + g]);
    float L = 0.f;
    for (int sp = 0; sp < n_eff; ++sp) {
      const float f = weight<BASE2>(fac[sp * GB + g], M);
      L += f * __ldcg(part + (size_t)sp * PSZ + g * RW + D + 1);
      fac[sp * GB + g] = f;
    }
    const float inv = 1.f / fmaxf(L, 1e-20f);
    for (int sp = 0; sp < n_eff; ++sp) fac[sp * GB + g] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    float A = 0.f;
    for (int sp = 0; sp < n_eff; ++sp)
      A += fac[sp * GB + g] * __ldcg(part + (size_t)sp * PSZ + g * RW + d);
    from_f(A, out + (size_t)g * D + d);
  }
}

// ---------------------------------------------------------------- float32

constexpr int FMA_STAGES = 3;
// query heads a block takes: one group of 8 (fewer heads are masked through
// ng).  float32 is a reference dtype whose speed nothing claims, so it gets
// one group size, and one instantiation per padded head_dim.
constexpr int FMA_GB = 8;

template <int LPK>
struct FmaCfg {
  static constexpr int KPP = 32 / LPK;  // keys per pass of a warp
  static constexpr int PASSES = 2;      // registers: 8 heads of accumulators
  static constexpr int KTW = PASSES * KPP;  // keys per warp tile (8 KB of K+V or less)
};

template <int LPK>
__global__ void __launch_bounds__(DEC_THREADS) decode_fma_kernel(
    const float* __restrict__ q,          // [B, H, D]
    const float* __restrict__ k_cache,    // [L, P, ps, K*D]
    const float* __restrict__ v_cache,
    const float* __restrict__ hk,         // [B, N, K*D]
    const float* __restrict__ hv,
    const int* __restrict__ page_tables,  // [B, mp]
    const int* __restrict__ entry_pos,    // [B]
    float* __restrict__ out,              // [B, H, D]
    float* __restrict__ part,             // [B, K*HG, S, GB, D + 2] partials (S > 1)
    int* __restrict__ counters,           // [B, K*HG] arrivals, 0 between launches
    int H, int K, int D, int P, int ps, int mp, int N, int n_extra, int layer,
    int window, float scale, float softcap, int S) {
  using C = FmaCfg<LPK>;
  constexpr int GB = FMA_GB, KPP = C::KPP, PASSES = C::PASSES, KTW = C::KTW;
  const int split = blockIdx.x, khg = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int HG = (G + GB - 1) / GB;  // head groups per KV head
  const int kh = khg / HG, g0 = (khg % HG) * GB;
  const int ng = min(GB, G - g0);  // live heads of this block
  const int KD = K * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPK, c = lane % LPK;  // key slot within a pass, 8-element chunk
  const int dch = D / 8;
  const bool c_live = c < dch;

  const Split sp(entry_pos[b], mp, ps, n_extra, window, S, KTW, split);
  if (split >= sp.n_eff) return;  // a short context needs fewer splits
  const int n_tiles = (sp.k_end - sp.k_begin + KTW - 1) / KTW;
  const int* pt = page_tables + (size_t)b * mp;
  const size_t layer_off = (size_t)layer * P * ps * KD;
  const size_t head_off = (size_t)kh * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per warp FMA_STAGES x {K, V} tiles of [KTW, D]
  float* stage_base = reinterpret_cast<float*>(smem_raw) + (size_t)warp * FMA_STAGES * 2 * KTW * D;

  auto row_of = [&](const float* cache, const float* side, int u) -> const float* {
    if (u < sp.n_cache) {
      const int pos = sp.lo_cache + u;
      return cache + layer_off + ((size_t)pt[pos / ps] * ps + pos % ps) * KD + head_off;
    }
    return side + ((size_t)b * N + (u - sp.n_cache)) * KD + head_off;
  };
  // this warp's j-th tile: tile w + j*WARPS of the split
  auto tile_base = [&](int j) { return sp.k_begin + (warp + j * DEC_WARPS) * KTW; };
  auto issue = [&](int j) {
    float* ks = stage_base + (size_t)(j % FMA_STAGES) * 2 * KTW * D;
    float* vs = ks + KTW * D;
    const int base = tile_base(j);
    const int per_row = D / 4;  // 16-byte pieces
    for (int i = lane; i < KTW * per_row; i += 32) {
      const int r = i / per_row, e = (i % per_row) * 4;
      const int u = base + r;
      const bool ok = u < sp.k_end;
      cp_async16(ks + r * D + e, ok ? row_of(k_cache, hk, u) + e : k_cache, ok ? 16 : 0);
      cp_async16(vs + r * D + e, ok ? row_of(v_cache, hv, u) + e : v_cache, ok ? 16 : 0);
    }
  };

  // this lane's 8 elements of each query head of the group
  float qr[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < ng && c_live) {
      load8(q + ((size_t)b * H + kh * G + g0 + g) * D + c * 8, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GB], l[GB], acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int n_mine = warp < n_tiles ? (n_tiles - 1 - warp) / DEC_WARPS + 1 : 0;
#pragma unroll
  for (int j = 0; j < FMA_STAGES - 1; ++j) {
    if (j < n_mine) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_mine; ++j) {
    if (j + FMA_STAGES - 1 < n_mine) issue(j + FMA_STAGES - 1);
    cp_async_commit();
    cp_async_wait<FMA_STAGES - 1>();  // tile j has landed
    __syncwarp();
    const float* ks = stage_base + (size_t)(j % FMA_STAGES) * 2 * KTW * D;
    const float* vs = ks + KTW * D;
    const int base = tile_base(j);

    float s[PASSES][GB];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = p * KPP + sub;
      float kv[8];
      if (c_live) {
        load8(ks + r * D + c * 8, kv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = 0.f;
      }
      const bool live = sp.live(base + r);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d += qr[g][e] * kv[e];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[p][g] = live ? cap_score(d * scale, softcap) : -INFINITY;
      }
    }

    // online softmax, warp-uniform: reduce over the passes, then the slots
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) mx = fmaxf(mx, s[p][g]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp_shifted(m[g], m_new);
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        s[p][g] = exp_shifted(s[p][g], m_new);
        sum += s[p][g];
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }

    // acc += p @ V over this lane's slot's keys
    if (c_live) {
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        float vv[8];
        load8(vs + (p * KPP + sub) * D + c * 8, vv);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += s[p][g] * vv[e];
      }
    }
    __syncwarp();  // the stage is refilled by a later issue
  }
  cp_async_wait<0>();

  // sum the slots' partial accumulators (same m within the warp)
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);

  __syncthreads();  // the tile stages become the merge area
  float* red = reinterpret_cast<float*>(smem_raw);  // [WARPS, GB, D + 2]
  const int RW = D + 2;
  if (sub == 0 && c_live) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * GB + g) * RW + c * 8 + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      red[(warp * GB + g) * RW + D] = m[g];
      red[(warp * GB + g) * RW + D + 1] = l[g];
    }
  }
  __syncthreads();
  const size_t row = (size_t)b * K * HG + khg;  // this (sequence, head group)
  merge_splits<GB, false>(red, ng, D, out + ((size_t)b * H + kh * G + g0) * D,
                          part + row * S * GB * RW, counters + row, split, sp.n_eff);
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

template <int DP>  // head_dim padded to 16, 32, 64, 128 or 256
struct TcDecCfg {
  static constexpr int GB = 16;   // mma rows: up to 16 query heads of one KV head
  static constexpr int KTW = 16;  // keys per warp tile
  static constexpr int STAGES = DP >= 256 ? 2 : 3;
  static constexpr int RS = DP + 8;  // shared row stride: +16 bytes, conflict-free ldmatrix
  static constexpr int CH = DP / 8;  // 16-byte chunks per row
  static constexpr size_t TILES = sizeof(bf16) * (size_t)(GB + DEC_WARPS * STAGES * 2 * KTW) * RS;
};

template <int DP>
__global__ void __launch_bounds__(DEC_THREADS) decode_tc_kernel(
    const bf16* __restrict__ q,          // [B, H, D]
    const bf16* __restrict__ k_cache,    // [L, P, ps, K*D]
    const bf16* __restrict__ v_cache,
    const bf16* __restrict__ hk,         // [B, N, K*D]
    const bf16* __restrict__ hv,
    const int* __restrict__ page_tables,  // [B, mp]
    const int* __restrict__ entry_pos,    // [B]
    bf16* __restrict__ out,              // [B, H, D]
    float* __restrict__ part,            // [B, K*HG, S, 16, D + 2] partials (S > 1)
    int* __restrict__ counters,          // [B, K*HG] arrivals, 0 between launches
    int H, int K, int D, int P, int ps, int mp, int N, int n_extra, int layer,
    int window, float scale, float softcap, int S) {
  using C = TcDecCfg<DP>;
  constexpr int GB = C::GB, KTW = C::KTW, STAGES = C::STAGES, RS = C::RS, CH = C::CH;
  const int split = blockIdx.x, khg = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int HG = (G + GB - 1) / GB;
  const int kh = khg / HG, g0 = (khg % HG) * GB;
  const int ng = min(GB, G - g0);
  const int KD = K * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dch = D / 8;

  const Split sp(entry_pos[b], mp, ps, n_extra, window, S, KTW, split);
  if (split >= sp.n_eff) return;  // a short context needs fewer splits
  const int n_tiles = (sp.k_end - sp.k_begin + KTW - 1) / KTW;
  const int* pt = page_tables + (size_t)b * mp;
  const size_t layer_off = (size_t)layer * P * ps * KD;
  const size_t head_off = (size_t)kh * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [GB, RS], zero rows past ng
  bf16* stage_base = q_s + (GB + (size_t)warp * STAGES * 2 * KTW) * RS;

  for (int i = tid; i < GB * CH; i += DEC_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < ng && c < dch;
    const bf16* src = ok ? q + ((size_t)b * H + kh * G + g0 + r) * D + c * 8 : q;
    cp_async16(q_s + r * RS + c * 8, src, ok ? 16 : 0);
  }
  cp_async_commit();

  auto tile_base = [&](int j) { return sp.k_begin + (warp + j * DEC_WARPS) * KTW; };
  // two lanes per key row: one page lookup per lane, CH/2 16-byte chunks each
  auto issue = [&](int j) {
    bf16* ks = stage_base + (size_t)(j % STAGES) * 2 * KTW * RS;
    bf16* vs = ks + KTW * RS;
    const int r = lane >> 1;
    const int u = tile_base(j) + r;
    const bool row_ok = u < sp.k_end;
    size_t off = 0;
    const bf16* kb = k_cache;
    const bf16* vb = v_cache;
    if (row_ok) {
      if (u < sp.n_cache) {
        const int pos = sp.lo_cache + u;
        off = layer_off + ((size_t)pt[pos / ps] * ps + pos % ps) * KD + head_off;
      } else {
        off = ((size_t)b * N + (u - sp.n_cache)) * KD + head_off;
        kb = hk;
        vb = hv;
      }
    }
#pragma unroll
    for (int c = lane & 1; c < CH; c += 2) {
      const bool ok = row_ok && c < dch;
      cp_async16(ks + r * RS + c * 8, ok ? kb + off + c * 8 : k_cache, ok ? 16 : 0);
      cp_async16(vs + r * RS + c * 8, ok ? vb + off + c * 8 : v_cache, ok ? 16 : 0);
    }
  };

  const int n_mine = warp < n_tiles ? (n_tiles - 1 - warp) / DEC_WARPS + 1 : 0;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_mine) issue(j);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // the query tile has landed
  __syncthreads();

  const int g8 = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix index, row within it
  uint32_t qa[DP / 16][4];  // Q as A fragments, rows = heads
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(qa[kk], q_s + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // heads g8 and g8 + 8, base-2 units
  float l_r[2] = {0.f, 0.f};              // this thread's share of the sums
  const float scale2 = scale * LOG2E;

  for (int j = 0; j < n_mine; ++j) {
    if (j + STAGES - 1 < n_mine) issue(j + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile j has landed
    __syncwarp();
    const bf16* ks = stage_base + (size_t)(j % STAGES) * 2 * KTW * RS;
    const bf16* vs = ks + KTW * RS;
    const int base = tile_base(j);

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // [heads, 16 keys]
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, ks + (mr + (mi >> 1) * 8) * RS + kk * 16 + (mi & 1) * 8);
      mma_bf16_16816(s[0], qa[kk], bk[0], bk[1]);
      mma_bf16_16816(s[1], qa[kk], bk[2], bk[3]);
    }
    if (softcap > 0.f) {  // a uniform branch: not predicated onto every element
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = cap_score(s[n][e] * scale, softcap) * LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!sp.live(base + n * 8 + 2 * tig + (e & 1))) s[n][e] = -INFINITY;

    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, m_r[h]);
      m_use[h] = mx == -INFINITY ? 0.f : mx;  // no live key yet: all terms 0
      const float alpha = exp2f(m_r[h] - m_use[h]);
      m_r[h] = mx;
      l_r[h] *= alpha;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    uint32_t pa[4];  // P as the A fragment of one k-step (16 keys)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = exp2f(s[n][0] - m_use[0]), p1 = exp2f(s[n][1] - m_use[0]);
      const float p2 = exp2f(s[n][2] - m_use[1]), p3 = exp2f(s[n][3] - m_use[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[2 * n] = pack_bf16x2(p0, p1);
      pa[2 * n + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int d2 = 0; d2 < DP / 16; ++d2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + (mr + (mi & 1) * 8) * RS + d2 * 16 + (mi >> 1) * 8);
      mma_bf16_16816(o[2 * d2], pa, bv[0], bv[1]);
      mma_bf16_16816(o[2 * d2 + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();  // the stage is refilled by a later issue
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }

  __syncthreads();  // the tile stages become the merge area
  float* red = reinterpret_cast<float*>(smem_raw);  // [WARPS, GB, D + 2]
  const int RW = D + 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = g8 + 8 * h;
    if (g >= ng) continue;
    float* rr = red + (warp * GB + g) * RW;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      if (col < D) {
        rr[col] = o[n][2 * h];
        rr[col + 1] = o[n][2 * h + 1];
      }
    }
    if (tig == 0) {
      rr[D] = m_r[h];
      rr[D + 1] = l_r[h];
    }
  }
  __syncthreads();
  const size_t row = (size_t)b * K * HG + khg;  // this (sequence, head group)
  merge_splits<GB, true>(red, ng, D, out + ((size_t)b * H + kh * G + g0) * D,
                         part + row * S * GB * RW, counters + row, split, sp.n_eff);
}

// ---------------------------------------------------------------- launch

template <int LPK>
cudaError_t launch_fma(const void* q, const void* kc, const void* vc, const void* hk,
                       const void* hv, const int* pt, const int* entry, void* out,
                       float* part, int* counters, int B, int H, int K, int D, int P, int ps,
                       int mp, int N, int n_extra, int layer, int window, float scale,
                       float softcap, int S, cudaStream_t stream) {
  const int HG = (H / K + FMA_GB - 1) / FMA_GB;
  const size_t tiles = sizeof(float) * (size_t)DEC_WARPS * FMA_STAGES * 2 * FmaCfg<LPK>::KTW * D;
  const size_t red = sizeof(float) * (size_t)DEC_WARPS * FMA_GB * (D + 2);
  const size_t smem = tiles > red ? tiles : red;
  cudaError_t err = allow_smem(decode_fma_kernel<LPK>, smem);
  if (err != cudaSuccess) return err;
  decode_fma_kernel<LPK><<<dim3(S, K * HG, B), DEC_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const float*>(hk),
      static_cast<const float*>(hv), pt, entry, static_cast<float*>(out), part, counters, H,
      K, D, P, ps, mp, N, n_extra, layer, window, scale, softcap, S);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* kc, const void* vc, const void* hk,
                      const void* hv, const int* pt, const int* entry, void* out, float* part,
                      int* counters, int B, int H, int K, int D, int P, int ps, int mp, int N,
                      int n_extra, int layer, int window, float scale, float softcap, int S,
                      cudaStream_t stream) {
  using C = TcDecCfg<DP>;
  const int HG = (H / K + C::GB - 1) / C::GB;
  const size_t red = sizeof(float) * (size_t)DEC_WARPS * C::GB * (D + 2);
  const size_t smem = C::TILES > red ? C::TILES : red;
  cudaError_t err = allow_smem(decode_tc_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  decode_tc_kernel<DP><<<dim3(S, K * HG, B), DEC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<const bf16*>(hk), static_cast<const bf16*>(hv), pt, entry,
      static_cast<bf16*>(out), part, counters, H, K, D, P, ps, mp, N, n_extra, layer, window,
      scale, softcap, S);
  return cudaGetLastError();
}

bool bad_shape(int dtype, int H, int K, int D, int num_splits) {
  return (dtype != 0 && dtype != 1) || K < 1 || H % K != 0 || D % 8 != 0 || D > 256 ||
         num_splits < 1 || num_splits > MAX_SPLITS;
}

}  // namespace

// The scratch a launch of smg_decode_attention needs, so that the caller
// does not repeat the kernel's tiling: `partial_floats` f32 partials (0 when
// num_splits is 1) and `counter_ints` arrival counters, which the caller
// zeroes once and may reuse for every later launch on the same stream (the
// kernel leaves them 0).  One block takes a group of GB query heads of a
// KV head — 16 in bfloat16, 8 in float32 — and HG = ceil((H / K) / GB)
// groups per KV head.  Returns cudaErrorInvalidValue for a shape the kernel
// rejects.
extern "C" int smg_decode_scratch(int dtype, int B, int H, int K, int D, int num_splits,
                                  long long* partial_floats, long long* counter_ints) {
  if (bad_shape(dtype, H, K, D, num_splits)) return (int)cudaErrorInvalidValue;
  const int GB = dtype == 0 ? FMA_GB : TcDecCfg<16>::GB;
  const long long groups = (long long)B * K * ((H / K + GB - 1) / GB);
  *partial_floats = num_splits > 1 ? groups * num_splits * GB * (D + 2) : 0;
  *counter_ints = groups;
  return (int)cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16.  `partials` and `counters` as sized by
// smg_decode_scratch; the counters are 0 on entry and are left 0.  Returns
// the cudaError_t of the launch.
extern "C" int smg_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* hk,
    const void* hv, const void* page_tables, const void* entry_positions, void* out,
    void* partials, void* counters, int dtype, int B, int H, int K, int D, int P, int ps,
    int mp, int N, int n_extra, int layer, int window, float scale, float softcap,
    int num_splits, void* stream) {
  if (bad_shape(dtype, H, K, D, num_splits)) return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* en = static_cast<const int*>(entry_positions);
  float* part = static_cast<float*>(partials);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SMG_ARGS                                                                            \
  q, k_cache, v_cache, hk, hv, pt, en, out, part, cnt, B, H, K, D, P, ps, mp, N, n_extra, \
      layer, window, scale, softcap, num_splits, s
  if (dtype == 0) {  // exact f32 FMA, LPK = lanes per key = D / 8 rounded up
    if (D <= 16) return (int)launch_fma<2>(SMG_ARGS);
    if (D <= 32) return (int)launch_fma<4>(SMG_ARGS);
    if (D <= 64) return (int)launch_fma<8>(SMG_ARGS);
    if (D <= 128) return (int)launch_fma<16>(SMG_ARGS);
    return (int)launch_fma<32>(SMG_ARGS);
  }
  // bfloat16: tensor cores, head_dim padded up
  if (D <= 16) return (int)launch_tc<16>(SMG_ARGS);
  if (D <= 32) return (int)launch_tc<32>(SMG_ARGS);
  if (D <= 64) return (int)launch_tc<64>(SMG_ARGS);
  if (D <= 128) return (int)launch_tc<128>(SMG_ARGS);
  return (int)launch_tc<256>(SMG_ARGS);
#undef SMG_ARGS
}
