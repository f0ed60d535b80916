// Paged prefill attention for chunked, prefix-aware prefill — hand-written
// Hopper (sm_90a) kernels, with a sequence axis so one launch serves every
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
// back under the bytes floor.
//
// bfloat16, in the style of flash-attention 2, in two kernels:
//  - one block of 4 warps per (64 query rows, KV head, sequence); a query
//    row is (token, head of the KV head's group), so a K/V tile staged once
//    serves all G heads of 64/G tokens;
//  - K/V tiles of 32 keys are gathered through the page table by 16-byte
//    cp.async into three stages: while tile i is computed, tiles i+1 and
//    i+2 are in flight, and the page-table reads of tile i+3 are issued a
//    tile before its copies, so no copy waits on a dependent read; one
//    barrier a tile;
//  - scores stay in the accumulator registers: the online softmax runs on
//    them (row max and sum across the 4 lanes of a quad, base-2 exponent),
//    and P is repacked into bf16 A fragments for P @ V with no trip through
//    shared memory (the one rounding step the plain version, which keeps P
//    in f32, lacks);
//  - masks (causal diagonal, t_real, table capacity, window edge, ragged
//    prefix end) are applied only on the tiles that cross one; the loop
//    starts at the window's first live key, so out-of-window prefix pages
//    are never read;
//  - prefill_wg_kernel (head_dim 33..128, padded to 64 or 128; Llama, Qwen):
//    both products on warpgroup instructions, wgmma.mma_async m64nNk16, with
//    Q and P from registers and K (K-major) and V (read N-major, d
//    contiguous) straight from 128-byte-swizzled shared memory through
//    matrix descriptors, so no warp copies K or V fragments into registers;
//  - prefill_tc_kernel (head_dim 16, 32 and 256; the tiny test models,
//    Gemma-2): mma.sync m16n8k16 per warp of 16 rows, fragments through
//    ldmatrix (.trans for V) from rows padded by 16 bytes so the eight rows
//    of each 8x8 matrix fall in distinct banks.
// On an H100 the mma.sync loop ran at ~1 TFLOP/s per SM whatever the tile
// shape, warp count or stage count, and about as slow with its copies
// removed; at head_dim 128 the wgmma kernel cut T=512 over a 1000-token
// prefix from 0.083 to 0.072 ms (PERF.md).  Warp-specialised TMA producers
// feeding asynchronous wgmma (FA3) are the next step.
// float32 (prefill_fma_kernel) keeps exact f32 FMA: a float32 product on
// the tensor cores is TF32 (10-bit mantissa), which would break the 2e-5
// float32 tolerance and the identical float32 greedy streams the tests and
// chip_smoke.py hold the kernel to.  Its design: one block per (64 query
// rows, KV head, sequence), synchronous staging, 4x4 and 8xD/32 register
// micro-tiles.

#include "common.cuh"

using namespace smg;

namespace {

// ---------------------------------------------------------------- float32

constexpr int PF_THREADS = 256;
constexpr int PF_R = 64;   // query rows (token x head-in-group) per block
constexpr int PF_TK = 64;  // key rows per staged tile

template <int DC>  // DC = ceil(D / 32) rounded up to a power of two
__global__ void __launch_bounds__(PF_THREADS) prefill_fma_kernel(
    const float* __restrict__ q,        // [Gs, Tn, H, D]
    const float* __restrict__ ck,       // [Gs, Tn, K*D] chunk keys
    const float* __restrict__ cv,
    const float* __restrict__ k_cache,  // [L, P, ps, K*D]
    const float* __restrict__ v_cache,
    const int* __restrict__ page_tables,  // [Gs, mp]
    const int* __restrict__ prefix_lens,  // [Gs]
    const int* __restrict__ t_reals,      // [Gs]
    float* __restrict__ out,            // [Gs, Tn, H, D]
    int Tn, int H, int K, int D, int P, int ps, int mp, int layer, int window,
    float scale, float softcap, int TQ) {
  using T = float;
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
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(rb + 16 * i) * RS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = k_s[(jb + 16 * c) * RS + d];
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
        vv[c] = d < D ? v_s[j * RS + d] : 0.f;
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
      if (d < D) out_row(r)[d] = acc[i][c] * inv;
    }
  }
}

template <int DC>
cudaError_t launch_fma(const void* q, const void* ck, const void* cv, const void* kc,
                       const void* vc, const int* pt, const int* prefix, const int* treal,
                       void* out, int Gs, int Tn, int H, int K, int D, int P, int ps, int mp,
                       int layer, int window, float scale, float softcap,
                       cudaStream_t stream) {
  const int TQ = PF_R / (H / K);
  const size_t smem = sizeof(float) * (size_t)(PF_R * PF_TK) +
                      sizeof(float) * (size_t)((PF_R + 2 * PF_TK) * row_stride<float>(D));
  cudaError_t err = allow_smem(prefill_fma_kernel<DC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + TQ - 1) / TQ, K, Gs);
  prefill_fma_kernel<DC><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck),
      static_cast<const float*>(cv), static_cast<const float*>(kc),
      static_cast<const float*>(vc), pt, prefix, treal, static_cast<float*>(out), Tn, H, K,
      D, P, ps, mp, layer, window, scale, softcap, TQ);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_R = 16 * TC_WARPS;  // query rows per block: 16 per warp
constexpr int TC_STAGES = 3;  // K/V tiles in shared memory: one computed, two in flight

template <int DP>  // head_dim padded to 16, 32, 64, 128 or 256
struct TcCfg {
  static constexpr int KT = 32;      // keys per staged tile
  static constexpr int RS = DP + 8;  // shared row stride: +16 bytes, conflict-free ldmatrix
  static constexpr int CH = DP / 8;  // 16-byte chunks per row
  // tile rows each thread copies (some threads copy none at head_dim 16)
  static constexpr int NR = (KT * CH + TC_THREADS - 1) / TC_THREADS;
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)(TC_R + 2 * TC_STAGES * KT) * RS;
  // three resident blocks (12 warps) an SM where the registers allow; the
  // head_dim 256 accumulator alone takes 128 registers a thread
  static constexpr int MIN_BLOCKS = DP >= 256 ? 1 : 3;
  static constexpr bool Q_IN_REGS = DP <= 128;  // else re-read from shared memory per tile
};

// 2^x on the special-function unit (softmax runs in base 2: scores are
// pre-multiplied by log2(e))
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- warpgroup products (wgmma, sm_90a) ----

// d[64 x N] (+)= a[64 x 16] @ b[16 x N]: bf16 in, f32 accumulators in the
// mma.sync C layout per 8 columns; A from registers (each warp's 16 rows in
// the mma.sync A layout), B through a shared-memory descriptor, K-major
// (TRANS_B = 0) or N-major (TRANS_B = 1).  scale_d = 0 overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's generic-proxy shared-memory writes (cp.async included),
// made visible to the tensor cores' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of async accumulators across the
// wgmma issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Descriptor of a 128-byte-swizzled shared-memory operand: rows of 128
// bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8), 8-row groups
// 1024 bytes apart (SBO); LBO steps between 64-element atoms along N of an
// N-major operand (unused for K-major).  Atoms start 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t s = smem_addr(p);
  return (uint64_t)((s >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS, TcCfg<DP>::MIN_BLOCKS) prefill_tc_kernel(
    const bf16* __restrict__ q,        // [Gs, Tn, H, D]
    const bf16* __restrict__ ck,       // [Gs, Tn, K*D] chunk keys
    const bf16* __restrict__ cv,
    const bf16* __restrict__ k_cache,  // [L, P, ps, K*D]
    const bf16* __restrict__ v_cache,
    const int* __restrict__ page_tables,  // [Gs, mp]
    const int* __restrict__ prefix_lens,  // [Gs]
    const int* __restrict__ t_reals,      // [Gs]
    bf16* __restrict__ out,            // [Gs, Tn, H, D]
    int Tn, int H, int K, int D, int P, int ps, int mp, int layer, int window,
    float scale, float softcap, int TQ) {
  using C = TcCfg<DP>;
  constexpr int KT = C::KT, RS = C::RS, CH = C::CH, NR = C::NR;
  constexpr float LOG2E = 1.4426950408889634f;
  const int qt = blockIdx.x, kh = blockIdx.y, seq = blockIdx.z;
  const int G = H / K;
  const int KD = K * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = qt * TQ;
  const int R = TQ * G;  // live query rows of this block (<= TC_R)
  const int prefix = prefix_lens[seq];
  const int t_real = t_reals[seq];
  const int total = mp * ps;
  const int dch = D / 8;  // 16-byte chunks of real data per row

  // query row r <-> token t0 + r / G, head kh*G + r % G
  auto row_live = [&](int r) { return r < R && t0 + r / G < Tn; };
  auto row_off = [&](int r) {
    return (((size_t)seq * Tn + t0 + r / G) * H + kh * G + r % G) * D;
  };

  if (t0 >= t_real) {  // an all-padding tile
    for (int i = tid; i < TC_R * D; i += TC_THREADS) {
      const int r = i / D;
      if (row_live(r)) out[row_off(r) + i % D] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [TC_R, RS]
  bf16* kv_s = q_s + TC_R * RS;                   // [TC_STAGES, {K, V}, KT, RS]

  for (int i = tid; i < TC_R * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row_live(r) && c < dch;
    cp_async16(q_s + r * RS + c * 8, ok ? q + row_off(r) + c * 8 : q, ok ? 16 : 0);
  }

  const int* pt = page_tables + (size_t)seq * mp;
  const size_t layer_off = (size_t)layer * P * ps * KD;
  const size_t head_off = (size_t)kh * D;
  const int t_last = t0 + TQ - 1;  // the block's last token
  // (a) cached prefix from the earliest live query's window floor
  const int prefix_end = min(prefix, total);
  const int p_start = min(window > 0 ? max(prefix + t0 - window + 1, 0) : 0, prefix_end);
  // (b) the chunk's own keys up to the tile's last query (causal)
  const int c_end = min(min(t0 + TQ, t_real), max(total - prefix, 0));
  const int c_start = min(window > 0 ? max(t0 - window + 1, 0) : 0, c_end);
  const int n_prefix_tiles = (prefix_end - p_start + KT - 1) / KT;
  const int n_tiles = n_prefix_tiles + (c_end - c_start + KT - 1) / KT;

  auto tile_base = [&](int tile) {
    return tile >= n_prefix_tiles ? c_start + (tile - n_prefix_tiles) * KT
                                  : p_start + tile * KT;
  };
  // This thread copies chunk c0 of rows r0 + k * RSTEP.  The source rows of
  // a tile (page-table reads) are looked up one tile before its copies are
  // issued, so their latency hides behind the compute in between.
  const int c0 = tid % CH, r0 = tid / CH;
  constexpr int RSTEP = TC_THREADS / CH;
  auto lookup = [&](int tile, int (&src)[NR]) {
    const bool chunk = tile >= n_prefix_tiles;
    const int base = tile_base(tile);
    const int end = chunk ? c_end : prefix_end;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int key = base + r0 + k * RSTEP;
      if (key >= end || c0 >= dch || r0 + k * RSTEP >= KT) {
        src[k] = -1;  // dead row or padding column: zero-filled
      } else if (chunk) {
        src[k] = seq * Tn + key;  // row of the chunk K/V
      } else {
        src[k] = pt[key / ps] * ps + key % ps;  // row of this layer's cache
      }
    }
  };
  auto issue = [&](int tile, const int (&src)[NR]) {
    const bool chunk = tile >= n_prefix_tiles;
    const size_t off0 = (chunk ? 0 : layer_off) + head_off + c0 * 8;
    const bf16* kb = (chunk ? ck : k_cache) + off0;
    const bf16* vb = (chunk ? cv : v_cache) + off0;
    bf16* ks = kv_s + (size_t)(tile % TC_STAGES) * 2 * KT * RS;
    bf16* vs = ks + KT * RS;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = r0 + k * RSTEP;
      if (r >= KT) break;
      const bool ok = src[k] >= 0;
      const size_t off = (size_t)src[k] * KD;
      cp_async16(ks + r * RS + c0 * 8, ok ? kb + off : k_cache, ok ? 16 : 0);
      cp_async16(vs + r * RS + c0 * 8, ok ? vb + off : v_cache, ok ? 16 : 0);
    }
  };

  // fragment coordinates: this thread's accumulator rows are rA and rA + 8
  // of the block, its columns 2*tig and 2*tig + 1 of each 8-wide tile
  const int g8 = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix index, row within it
  const int rA = warp * 16 + g8;
  const int tok[2] = {t0 + rA / G, t0 + (rA + 8) / G};  // query token of rows A, B
  const bf16* q_frag = q_s + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  uint32_t qf[C::Q_IN_REGS ? DP / 16 : 1][4];  // Q's A fragments, loaded once

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max (base-2 units) of rows A, B
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running sums
  const float scale2 = scale * LOG2E;

  int src[NR];
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < n_tiles) {
      lookup(st, src);
      issue(st, src);
    }
    cp_async_commit();  // the first group carries Q too
  }
  if (TC_STAGES - 1 < n_tiles) lookup(TC_STAGES - 1, src);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<TC_STAGES - 2>();  // this tile (and Q) have landed
    // one barrier a tile: it publishes this tile's copies, and it is passed
    // only once every warp has finished the previous tile, whose stage the
    // next issue refills
    __syncthreads();
    const int ahead = tile + TC_STAGES - 1;
    if (ahead < n_tiles) {
      issue(ahead, src);
      if (ahead + 1 < n_tiles) lookup(ahead + 1, src);
    }
    cp_async_commit();
    const bf16* ks = kv_s + (size_t)(tile % TC_STAGES) * 2 * KT * RS;
    const bf16* vs = ks + KT * RS;
    if constexpr (C::Q_IN_REGS) {
      if (tile == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
      }
    }

    // S = Q K^T: [16 rows, KT keys] per warp
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < KT / 16; ++n2) {
        uint32_t b[4];  // keys n2*16 + [0, 8) and [8, 16), d kk*16 + [0, 8) and [8, 16)
        ldmatrix_x4(b, ks + (n2 * 16 + mr + (mi >> 1) * 8) * RS + kk * 16 + (mi & 1) * 8);
        mma_bf16_16816(s[2 * n2], a, b[0], b[1]);
        mma_bf16_16816(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }

    // scale (base 2) and softcap; uniform branches around whole loops, as
    // inside them the compiler predicates the tanh onto every element
    if (softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = cap_score(s[n][e] * scale, softcap) * LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    }
    // masks, on a tile that crosses an edge only: unmasked if every key is
    // live for every row t0 .. t_last
    const bool chunk = tile >= n_prefix_tiles;
    const int base = tile_base(tile);
    const int end = chunk ? c_end : prefix_end;
    bool masked = base + KT > end;
    if (chunk) {
      masked = masked || base + KT - 1 > t0 || (window > 0 && base <= t_last - window);
    } else {
      masked = masked || (window > 0 && base <= prefix + t_last - window);
    }
    if (masked) {
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + n * 8 + 2 * tig + (e & 1);
          const int t = tok[e >> 1];
          bool keep = key < end;
          if (chunk) {
            keep = keep && key <= t && (window <= 0 || key > t - window);
          } else {
            keep = keep && (window <= 0 || key > prefix + t - window);
          }
          if (!keep) s[n][e] = -INFINITY;
        }
    }

    // online softmax on the fragments: rows A (e = 0, 1) and B (e = 2, 3)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_use[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // no live key yet: all terms 0
      const float alpha = fast_exp2(m_r[h] - m_use[h]);
      m_r[h] = mx[h];
      l_r[h] *= alpha;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    uint32_t pa[KT / 16][4];  // P as bf16 A fragments, keys j*16 + [0, 16)
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float p0 = fast_exp2(s[n][0] - m_use[0]), p1 = fast_exp2(s[n][1] - m_use[0]);
      const float p2 = fast_exp2(s[n][2] - m_use[1]), p3 = fast_exp2(s[n][3] - m_use[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16x2(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }

    // O += P V: V fragments through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
#pragma unroll
      for (int d2 = 0; d2 < DP / 16; ++d2) {
        uint32_t b[4];  // keys j*16 + [0, 8) and [8, 16), d d2*16 + [0, 8) and [8, 16)
        ldmatrix_x4_trans(b, vs + (j * 16 + mr + (mi & 1) * 8) * RS + d2 * 16 + (mi >> 1) * 8);
        mma_bf16_16816(o[2 * d2], pa[j], b[0], b[1]);
        mma_bf16_16816(o[2 * d2 + 1], pa[j], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = rA + 8 * h;
    if (!row_live(r)) continue;
    const float inv = 1.f / fmaxf(l, 1e-20f);
    bf16* orow = out + row_off(r);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      }
    }
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* ck, const void* cv, const void* kc,
                      const void* vc, const int* pt, const int* prefix, const int* treal,
                      void* out, int Gs, int Tn, int H, int K, int D, int P, int ps, int mp,
                      int layer, int window, float scale, float softcap,
                      cudaStream_t stream) {
  const int TQ = TC_R / (H / K);
  cudaError_t err = allow_smem(prefill_tc_kernel<DP>, TcCfg<DP>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + TQ - 1) / TQ, K, Gs);
  prefill_tc_kernel<DP><<<grid, TC_THREADS, TcCfg<DP>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ck),
      static_cast<const bf16*>(cv), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), pt, prefix, treal, static_cast<bf16*>(out), Tn, H, K, D,
      P, ps, mp, layer, window, scale, softcap, TQ);
  return cudaGetLastError();
}

// bfloat16, head_dim 33..128: the products on warpgroup tensor-core
// instructions (wgmma), K and V read by the tensor cores straight from
// shared memory.
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_R = 64;         // query rows per block: 16 per warp
constexpr int WG_KT = 32;        // keys per tile: the N of the score product
constexpr int WG_STAGES = 3;     // K/V tiles in shared memory: one computed, two in flight
// Pinned.  A 64-key form of this kernel (m64n64 scores, four P @ V steps a
// tile) was right at head_dim 128 and on cold rows, but wrong at head_dim
// 64 over a cached prefix (max error 0.6 against the plain version, at G=1
// and G=4), and no descriptor change (LBO, stage count) fixed it; the cause
// was not found.  A new tile shape has to pass the card tests at every
// head_dim first, padded ones included.
static_assert(WG_KT == 32, "the wgmma prefill is verified with 32-key tiles only");

template <int DP>  // head_dim padded to 64 or 128
struct WgCfg {
  static constexpr int ATOMS = DP / 64;             // 128-byte swizzle atoms along d
  static constexpr int TILE = ATOMS * WG_KT * 128;  // bytes of one K (or V) tile
  static constexpr int RS = DP + 8;                 // Q: rows padded for ldmatrix
  static constexpr int CH = DP / 8;                 // 16-byte chunks per row
  static constexpr int NR = WG_KT * CH / WG_THREADS;  // tile rows each thread copies
  // 1024 bytes of slack to align the swizzled tiles
  static constexpr size_t SMEM = 1024 + (size_t)WG_STAGES * 2 * TILE + sizeof(bf16) * WG_R * RS;
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS) prefill_wg_kernel(
    const bf16* __restrict__ q,        // [Gs, Tn, H, D]
    const bf16* __restrict__ ck,       // [Gs, Tn, K*D] chunk keys
    const bf16* __restrict__ cv,
    const bf16* __restrict__ k_cache,  // [L, P, ps, K*D]
    const bf16* __restrict__ v_cache,
    const int* __restrict__ page_tables,  // [Gs, mp]
    const int* __restrict__ prefix_lens,  // [Gs]
    const int* __restrict__ t_reals,      // [Gs]
    bf16* __restrict__ out,            // [Gs, Tn, H, D]
    int Tn, int H, int K, int D, int P, int ps, int mp, int layer, int window,
    float scale, float softcap, int TQ) {
  using C = WgCfg<DP>;
  constexpr int KT = WG_KT, RS = C::RS, CH = C::CH, NR = C::NR, TILE = C::TILE;
  constexpr float LOG2E = 1.4426950408889634f;
  const int qt = blockIdx.x, kh = blockIdx.y, seq = blockIdx.z;
  const int G = H / K;
  const int KD = K * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = qt * TQ;
  const int R = TQ * G;  // live query rows of this block (<= WG_R)
  const int prefix = prefix_lens[seq];
  const int t_real = t_reals[seq];
  const int total = mp * ps;
  const int dch = D / 8;  // 16-byte chunks of real data per row

  // query row r <-> token t0 + r / G, head kh*G + r % G
  auto row_live = [&](int r) { return r < R && t0 + r / G < Tn; };
  auto row_off = [&](int r) {
    return (((size_t)seq * Tn + t0 + r / G) * H + kh * G + r % G) * D;
  };

  if (t0 >= t_real) {  // an all-padding tile
    for (int i = tid; i < WG_R * D; i += WG_THREADS) {
      const int r = i / D;
      if (row_live(r)) out[row_off(r) + i % D] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [STAGES, {K, V}, ATOMS, KT rows, 128 B] swizzled, then Q [WG_R, RS]
  unsigned char* kv_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(kv_s + (size_t)WG_STAGES * 2 * TILE);

  for (int i = tid; i < WG_R * CH; i += WG_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row_live(r) && c < dch;
    cp_async16(q_s + r * RS + c * 8, ok ? q + row_off(r) + c * 8 : q, ok ? 16 : 0);
  }

  const int* pt = page_tables + (size_t)seq * mp;
  const size_t layer_off = (size_t)layer * P * ps * KD;
  const size_t head_off = (size_t)kh * D;
  const int t_last = t0 + TQ - 1;  // the block's last token
  // (a) cached prefix from the earliest live query's window floor
  const int prefix_end = min(prefix, total);
  const int p_start = min(window > 0 ? max(prefix + t0 - window + 1, 0) : 0, prefix_end);
  // (b) the chunk's own keys up to the tile's last query (causal)
  const int c_end = min(min(t0 + TQ, t_real), max(total - prefix, 0));
  const int c_start = min(window > 0 ? max(t0 - window + 1, 0) : 0, c_end);
  const int n_prefix_tiles = (prefix_end - p_start + KT - 1) / KT;
  const int n_tiles = n_prefix_tiles + (c_end - c_start + KT - 1) / KT;

  auto tile_base = [&](int tile) {
    return tile >= n_prefix_tiles ? c_start + (tile - n_prefix_tiles) * KT
                                  : p_start + tile * KT;
  };
  // This thread copies chunk c0 of rows r0 + k * RSTEP; page-table reads
  // run a tile ahead of the copies, as in prefill_tc_kernel.
  const int c0 = tid % CH, r0 = tid / CH;
  constexpr int RSTEP = WG_THREADS / CH;
  auto lookup = [&](int tile, int (&src)[NR]) {
    const bool chunk = tile >= n_prefix_tiles;
    const int base = tile_base(tile);
    const int end = chunk ? c_end : prefix_end;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int key = base + r0 + k * RSTEP;
      if (key >= end || c0 >= dch) {
        src[k] = -1;  // dead row or padding column: zero-filled
      } else if (chunk) {
        src[k] = seq * Tn + key;  // row of the chunk K/V
      } else {
        src[k] = pt[key / ps] * ps + key % ps;  // row of this layer's cache
      }
    }
  };
  auto issue = [&](int tile, const int (&src)[NR]) {
    const bool chunk = tile >= n_prefix_tiles;
    const size_t off0 = (chunk ? 0 : layer_off) + head_off + c0 * 8;
    const bf16* kb = (chunk ? ck : k_cache) + off0;
    const bf16* vb = (chunk ? cv : v_cache) + off0;
    unsigned char* ks = kv_s + (size_t)(tile % WG_STAGES) * 2 * TILE;
    unsigned char* vs = ks + TILE;
    const int atom = c0 / 8, cc = c0 % 8;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = r0 + k * RSTEP;
      const bool ok = src[k] >= 0;
      const size_t off = (size_t)src[k] * KD;
      const int dst = atom * KT * 128 + r * 128 + ((cc ^ (r & 7)) << 4);
      cp_async16(ks + dst, ok ? kb + off : k_cache, ok ? 16 : 0);
      cp_async16(vs + dst, ok ? vb + off : v_cache, ok ? 16 : 0);
    }
  };

  // accumulator coordinates, as in prefill_tc_kernel: rows rA and rA + 8,
  // columns 2*tig and 2*tig + 1 of each 8-wide tile (index 4*n + e)
  const int g8 = lane >> 2, tig = lane & 3;
  const int rA = warp * 16 + g8;
  const int tok[2] = {t0 + rA / G, t0 + (rA + 8) / G};  // query token of rows A, B
  const bf16* q_frag = q_s + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  uint32_t qf[DP / 16][4];  // Q's A fragments, loaded once

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max (base-2 units) of rows A, B
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running sums
  const float scale2 = scale * LOG2E;

  int src[NR];
#pragma unroll
  for (int st = 0; st < WG_STAGES - 1; ++st) {
    if (st < n_tiles) {
      lookup(st, src);
      issue(st, src);
    }
    cp_async_commit();  // the first group carries Q too
  }
  if (WG_STAGES - 1 < n_tiles) lookup(WG_STAGES - 1, src);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<WG_STAGES - 2>();  // this tile (and Q) have landed
    fence_proxy_async();
    // one barrier a tile, as in prefill_tc_kernel (the previous tile's
    // products were waited for before it)
    __syncthreads();
    const int ahead = tile + WG_STAGES - 1;
    if (ahead < n_tiles) {
      issue(ahead, src);
      if (ahead + 1 < n_tiles) lookup(ahead + 1, src);
    }
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
    }
    const unsigned char* ks = kv_s + (size_t)(tile % WG_STAGES) * 2 * TILE;
    const unsigned char* vs = ks + TILE;

    // S = Q K^T: K-major K tile, 16 d (32 bytes) a step within an atom
    float s[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n32<0>(s, qf[kk], sw128_desc(ks + (kk / 4) * KT * 128 + (kk % 4) * 32, 16, 1024),
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, softcap and masks as in prefill_tc_kernel
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] = cap_score(s[i] * scale, softcap) * LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] *= scale2;
    }
    const bool chunk = tile >= n_prefix_tiles;
    const int base = tile_base(tile);
    const int end = chunk ? c_end : prefix_end;
    bool masked = base + KT > end;
    if (chunk) {
      masked = masked || base + KT - 1 > t0 || (window > 0 && base <= t_last - window);
    } else {
      masked = masked || (window > 0 && base <= prefix + t_last - window);
    }
    if (masked) {
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + n * 8 + 2 * tig + (e & 1);
          const int t = tok[e >> 1];
          bool keep = key < end;
          if (chunk) {
            keep = keep && key <= t && (window <= 0 || key > t - window);
          } else {
            keep = keep && (window <= 0 || key > prefix + t - window);
          }
          if (!keep) s[4 * n + e] = -INFINITY;
        }
    }

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_use[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // no live key yet: all terms 0
      const float alpha = fast_exp2(m_r[h] - m_use[h]);
      m_r[h] = mx[h];
      l_r[h] *= alpha;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n + 2 * h] *= alpha;
        o[4 * n + 2 * h + 1] *= alpha;
      }
    }
    uint32_t pa[KT / 16][4];  // P as bf16 A fragments, keys j*16 + [0, 16)
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float p0 = fast_exp2(s[4 * n] - m_use[0]), p1 = fast_exp2(s[4 * n + 1] - m_use[0]);
      const float p2 = fast_exp2(s[4 * n + 2] - m_use[1]);
      const float p3 = fast_exp2(s[4 * n + 3] - m_use[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16x2(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }

    // O += P V: the V tile read N-major (d contiguous), 16 keys a step
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      const uint64_t desc = sw128_desc(vs + j * 16 * 128, KT * 128, 1024);
      if constexpr (DP == 128) {
        wgmma_m64n128<1>(o, pa[j], desc, 1);
      } else {
        wgmma_m64n64<1>(o, pa[j], desc, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = rA + 8 * h;
    if (!row_live(r)) continue;
    const float inv = 1.f / fmaxf(l, 1e-20f);
    bf16* orow = out + row_off(r);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
      }
    }
  }
}

template <int DP>
cudaError_t launch_wg(const void* q, const void* ck, const void* cv, const void* kc,
                      const void* vc, const int* pt, const int* prefix, const int* treal,
                      void* out, int Gs, int Tn, int H, int K, int D, int P, int ps, int mp,
                      int layer, int window, float scale, float softcap,
                      cudaStream_t stream) {
  const int TQ = WG_R / (H / K);
  cudaError_t err = allow_smem(prefill_wg_kernel<DP>, WgCfg<DP>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + TQ - 1) / TQ, K, Gs);
  prefill_wg_kernel<DP><<<grid, WG_THREADS, WgCfg<DP>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ck),
      static_cast<const bf16*>(cv), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), pt, prefix, treal, static_cast<bf16*>(out), Tn, H, K, D,
      P, ps, mp, layer, window, scale, softcap, TQ);
  return cudaGetLastError();
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
#define SMG_ARGS                                                                       \
  q, chunk_k, chunk_v, k_cache, v_cache, pt, pl, tr, out, Gs, Tn, H, K, D, P, ps, mp, \
      layer, window, scale, softcap, s
  if (dtype == 0) {  // exact f32 FMA
    if (D <= 32) return (int)launch_fma<1>(SMG_ARGS);
    if (D <= 64) return (int)launch_fma<2>(SMG_ARGS);
    if (D <= 128) return (int)launch_fma<4>(SMG_ARGS);
    return (int)launch_fma<8>(SMG_ARGS);
  }
  if (dtype == 1) {  // tensor cores, head_dim padded up
    if (D <= 16) return (int)launch_tc<16>(SMG_ARGS);
    if (D <= 32) return (int)launch_tc<32>(SMG_ARGS);
    if (D <= 64) return (int)launch_wg<64>(SMG_ARGS);
    if (D <= 128) return (int)launch_wg<128>(SMG_ARGS);
    return (int)launch_tc<256>(SMG_ARGS);
  }
#undef SMG_ARGS
  return (int)cudaErrorInvalidValue;
}
