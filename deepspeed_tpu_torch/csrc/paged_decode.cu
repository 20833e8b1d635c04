// Paged decode attention for Hopper (sm_90a), bound through ctypes.
//
// Replaces deepspeed_tpu/ops/pallas/paged_attention.py::_decode_kernel: one
// query per (slot, head) attends over the slot's KV history, which lives in
// pages of the layer-major pool [n_layer, num_blocks, block_size, n_head,
// head_dim] picked through tables[s, b]; positions >= lengths[s] do not count
// and pages past the length are not read. Scores, the online softmax and the
// weighted sum are float32, with a 1/sqrt(head_dim) scale; the output is
// rounded once to the pool's type (float32, bfloat16 or float16).
//
// Bound: device-memory bytes. Each live token costs K + V of one layer, read
// once: 2 * 25 * 64 * 2 B = 6,400 B per token per layer for GPT-2 1.5B in
// bf16, so the serving mix [1,17,300,1024,64,511,777,1000] (3,694 live
// tokens) moves 23.6 MB, 7.07 us at 3.35 TB/s, and 8 slots at 1024 tokens
// 52.4 MB, 15.7 us. About one flop per byte, far below the card's ridge: one
// query per head shares no K/V across heads, so tensor cores buy nothing and
// the design only has to keep the memory system busy.
//
// Two designs, chosen by one shape rule in ops/paged_attention.py
// (cluster_design: a head's row is 16 bytes times a power of two, so it is a
// TMA box row and splits evenly over the lanes of a warp):
//
// 1. paged_decode_cluster, the main path. What each part does about the bound:
//  - Split every history across CTAs. The unit of work is (slot, group of G
//    heads, split); the `splits` CTAs of one (slot, group) form a thread-block
//    cluster, and split r walks the pages r, r + splits, ... of the slot (so a
//    300-token slot spreads over 8 CTAs instead of 3). The grid (splits,
//    n_head / G, slots) comes from max_blocks, n_head and the slot count only,
//    never from the lengths: nothing is read back to the host, so the launch
//    can be captured in a CUDA graph. At the serving geometry (64 pages of
//    16, 25 heads of 64, 8 slots) that is 8 x 5 x 8 = 320 CTAs of 192
//    threads (5 consumer warps and a producer warp), no CTA walking more
//    than 8 pages. A split whose pages all lie past the length loads nothing
//    and keeps (m = -inf, l = 0, acc = 0).
//  - Keep bytes in flight. A producer warp stages each unit (Tb tokens of
//    one page for the G heads) into shared memory with one 5-D TMA box per
//    pool (tc::make_pool_map; layer and page are coordinates, so one map
//    serves every layer and the wrapper encodes it once per pool), through a
//    ring of kStages stages on full/empty mbarriers: it refills a stage as
//    soon as every consumer warp has arrived on its empty barrier, and no
//    consumer waits at a CTA-wide barrier. TMA rather than cp.async: one
//    thread issues a whole box and no register holds data in flight. The
//    producer warp reads the table entries of the CTA's pages at entry,
//    beside the length, so a page's id is in shared memory before its copy
//    is issued; the consumer warps load q meanwhile. A stage holds at most
//    20 KB (K + V; bf16 at the serving widths: 16 tokens x 5 heads x 64 x 2 B
//    x 2), so three stages and the rest take about 63 KB and three CTAs fit
//    an SM: up to 180 KB in flight per SM, 23.8 MB on 132 SMs, against the
//    3.4-6.7 MB that 3.35 TB/s needs at 1-2 us of latency. More stages (four
//    whole pages, or six half pages in the same memory) and 16-CTA clusters
//    measured no faster (PERF.md).
//  - Few instructions, and no cross-lane step, per unit. Warp 1 + w takes
//    head h0 + w, with q in registers pre-scaled by log2(e) / sqrt(D); `L`
//    lanes share a token's row in 16-byte loads and reduce its score with
//    log2(L) shuffles; each lane then runs its own online softmax (one exp2
//    per token) and p * V over its token slots, and the warp merges its
//    lanes' states once, after its last unit. A lane holds at most 16 of a
//    row's values (L = 4 at D = 64 in bf16: a 16-token page in two passes of
//    8), so q and the accumulator fit the 96 registers a thread that keep
//    three CTAs of six warps on an SM; twice as many values a lane cost the
//    third CTA, and the launch ran in two waves. A design that recomputed a
//    unit's exponentials in every thread of a head, with q in shared memory,
//    was bound by instructions, not bytes.
//  - Merge inside the launch, in a fixed order: each CTA leaves (m, l, acc)
//    of its heads in shared memory; after a cluster barrier, CTA r merges its
//    share of the output pairs from every peer's shared memory (distributed
//    shared memory), in rank order; a second cluster barrier keeps every CTA
//    resident until its peers have read it. No workspace, no atomics, no
//    second launch, and the result is the same bits on every call. Every CTA
//    reaches both barriers, the ones with no live page included.
//
// 2. paged_decode, the first design (PR 1), kept for the shapes the rule
//    sends elsewhere (head_dim 2 or 96 in bf16, say): one
//    CTA of 4 warps per (slot, head); warp w walks pages w, w + 4, ..., 8
//    tokens a step from registers; the warps merge through shared memory.

#include <cooperative_groups.h>
#include <string.h>

#include "tc_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------ value access
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// 16 bytes of T (shared or global memory, 16-aligned) as floats.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
// Two packed 16-bit values (the first in the low half) as floats, by
// register operations only.
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half) {
  return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack2(w[i], T());
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 2^x by the SFU (ex2.approx: relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ====================================================== 1. the cluster design
constexpr int kStages = 3;
constexpr int kMaxSplits = 8;         // the portable cluster size
constexpr int kMaxGroup = 8;          // heads a CTA, one consumer warp each
constexpr int kMaxThreads = 32 * (kMaxGroup + 1);   // and the producer warp
constexpr int kMaxPass = 4;           // token passes of a warp per unit

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Shared memory of one CTA, as byte offsets from a 128-byte aligned base.
struct Layout {
  int tiles, tile_bytes, pacc, pm, pl, bars, pages, total;
};

__host__ __device__ inline Layout layout(int G, int D, int Tb, int P, int es) {
  Layout L;
  L.tile_bytes = align_up(Tb * G * D * es, 128);
  L.tiles = 0;                                    // kStages x (K tile, V tile)
  int o = kStages * 2 * L.tile_bytes;
  L.pacc = o;  o += G * D * 4;                    // this split's acc, float32
  L.pm = o;    o += G * 4;                        // this split's m and l
  L.pl = o;    o += G * 4;
  o = align_up(o, 8);
  L.bars = o;  o += 2 * kStages * 8;              // full and empty barriers
  L.pages = o; o += P * 4;                        // page ids of this split
  L.total = o;
  return L;
}

__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  return p + ((128 - (tc::smem_u32(p) & 127)) & 127);
}

// Grid (splits, n_head / G, slots), cluster (splits, 1, 1), 32 * (G + 1)
// threads: warp 0 produces (lane 0 issues the copies), warp 1 + w consumes
// for head h0 + w. Unit j of split r: page b = r + (j / CH) * splits of the
// slot, tokens [(j % CH) * Tb, + Tb) of it, [Tb][G][D] in a tile. A head's row
// is L x C x E values (E per 16-byte load): lane = tl * L + cp holds the C
// loads cp, cp + L, ... of the row for token slot tl of the 32 / L slots of a
// pass; a unit takes ceil(Tb / (32 / L)) <= kMaxPass passes. Each lane runs
// its own online softmax over its token slots, merged across the warp once,
// at the end. qscale = log2(e) / sqrt(D): scores are in the log2 domain.
template <typename T, int C>
__global__ void __launch_bounds__(kMaxThreads)
paged_decode_cluster_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const T* __restrict__ q, T* __restrict__ out,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths, int n_head, int D,
                            int max_blocks, int BS, int layer, int G, int Tb,
                            int CH, int L, float qscale) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int V = C * E;                // row values a lane holds
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int h0 = blockIdx.y * G;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int P = (max_blocks + ns - 1) / ns;
  const Layout Lo = layout(G, D, Tb, P, sizeof(T));

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lo.bars);
  uint64_t* empty = full + kStages;
  float* pacc = reinterpret_cast<float*>(base + Lo.pacc);
  float* pm = reinterpret_cast<float*>(base + Lo.pm);
  float* pl = reinterpret_cast<float*>(base + Lo.pl);
  int* pages = reinterpret_cast<int*>(base + Lo.pages);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      tc::mbar_init(&full[i], 1);
      tc::mbar_init(&empty[i], G);
    }
    tc::fence_barrier_init();
  }
  // The producer warp reads this split's page ids (beside the length, before
  // any copy); the consumer warps meanwhile load q into registers, pre-scaled.
  const int length = min(lengths[s], max_blocks * BS);
  if (warp == 0) {
    const int* table = tables + static_cast<long long>(s) * max_blocks;
    for (int i = lane; i < P; i += 32) {
      const int b = r + i * ns;
      pages[i] = b < max_blocks ? table[b] : 0;
    }
  }
  // This split's units: all of its pages but the slot's last, whole, and the
  // live boxes of that one. Dead units form a suffix, so j < n_units is live.
  const int n_pages = (length + BS - 1) / BS;
  const int k_r = r < n_pages ? (n_pages - r + ns - 1) / ns : 0;
  int n_units = 0;
  if (k_r > 0) {
    const int b_last = r + (k_r - 1) * ns;
    n_units = (k_r - 1) * CH + min(CH, (length - b_last * BS + Tb - 1) / Tb);
  }
  const int hw = warp - 1;                // this consumer warp's head in the group
  const int TP = 32 / L;                  // token slots of a pass
  const int tl = lane / L;
  const int cp = lane % L;
  float qr[V];
  if (warp > 0) {
    const T* qrow = q + (static_cast<long long>(s) * n_head + h0 + hw) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float x[E];
      load16(qrow + (c * L + cp) * E, x);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[c * E + e] = x[e] * qscale;
    }
  }
  __syncthreads();                        // barriers initialised, page ids in

  if (warp == 0) {
    if (lane == 0) {
      const int box_bytes = Tb * G * D * static_cast<int>(sizeof(T));
      for (int j = 0; j < n_units; ++j) {
        const int st = j % kStages;
        if (j >= kStages) {
          tc::mbar_wait(&empty[st], (j / kStages - 1) & 1);   // the consumers are done
          tc::fence_proxy_async();
        }
        uint8_t* kt = base + Lo.tiles + st * 2 * Lo.tile_bytes;
        tc::mbar_arrive_expect_tx(&full[st], 2 * box_bytes);
        const int page = pages[j / CH];
        tc::tma_load_5d(kt, &kmap, &full[st], 0, h0, (j % CH) * Tb, page, layer);
        tc::tma_load_5d(kt + Lo.tile_bytes, &vmap, &full[st], 0, h0, (j % CH) * Tb, page,
                        layer);
      }
    }
    __syncwarp();
  } else {
    const int npass = (Tb + TP - 1) / TP;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    float m = -INFINITY, l = 0.f;         // this lane's token slots
    for (int j = 0; j < n_units; ++j) {
      const int st = j % kStages;
      tc::mbar_wait(&full[st], (j / kStages) & 1);
      const T* kt = reinterpret_cast<const T*>(base + Lo.tiles + st * 2 * Lo.tile_bytes);
      const T* vt = reinterpret_cast<const T*>(base + Lo.tiles + st * 2 * Lo.tile_bytes +
                                               Lo.tile_bytes);
      const int b = r + (j / CH) * ns;
      const int n_tok = min(Tb, min(BS, length - b * BS) - (j % CH) * Tb);   // >= 1

      float sc[kMaxPass];
      float mt = -INFINITY;
#pragma unroll
      for (int ps = 0; ps < kMaxPass; ++ps) {
        sc[ps] = -INFINITY;
        if (ps < npass) {                 // uniform across the warp
          const int t = ps * TP + tl;
          float d = 0.f;
          if (t < n_tok) {
            const T* row = kt + (t * G + hw) * D;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float k[E];
              load16(row + (c * L + cp) * E, k);
              float dc = 0.f;
#pragma unroll
              for (int e = 0; e < E; ++e) dc = fmaf(qr[c * E + e], k[e], dc);
              d += dc;
            }
          }
          for (int o = 1; o < L; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          if (t < n_tok) sc[ps] = d;
          mt = fmaxf(mt, sc[ps]);
        }
      }
      const float m_new = fmaxf(m, mt);
      if (m_new != -INFINITY) {           // else no live token of this lane yet
        const float alpha = exp2_(m - m_new);   // 0 while m = -inf
        l *= alpha;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] *= alpha;
#pragma unroll
        for (int ps = 0; ps < kMaxPass; ++ps) {
          const int t = ps * TP + tl;
          if (ps < npass && t < n_tok) {
            const float p = exp2_(sc[ps] - m_new);
            const T* row = vt + (t * G + hw) * D;
            l += p;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float v[E];
              load16(row + (c * L + cp) * E, v);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[c * E + e] = fmaf(p, v[e], acc[c * E + e]);
            }
          }
        }
        m = m_new;
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(&empty[st]);   // this warp is done with the stage
    }

    // The lanes' states into the warp's: rescale to the warp's max, then sum
    // over token slots (lanes of one slot hold the same tokens).
    float mw = m;
    for (int o = 1; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float w = m == -INFINITY ? 0.f : exp2_(m - mw);
    l *= w;
    for (int o = L; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc[i] *= w;
      for (int o = L; o < 32; o <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    if (tl == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int e = 0; e < E; ++e) pacc[hw * D + (c * L + cp) * E + e] = acc[c * E + e];
      }
    }
    if (lane == 0) {
      pm[hw] = mw;
      pl[hw] = l;
    }
  }

  // The splits' states merged through distributed shared memory, in rank
  // order, each CTA taking its share of the output pairs.
  cluster.sync();
  const int half = D / 2;
  const int n_pairs = G * half;
  const int per = (n_pairs + ns - 1) / ns;
  for (int p = r * per + threadIdx.x; p < min(n_pairs, (r + 1) * per); p += blockDim.x) {
    const int h = p / half;
    float mk[kMaxSplits], lk[kMaxSplits];
    float2 ak[kMaxSplits];
    float mx = -INFINITY;                 // finite: split 0 holds token 0
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      if (k < ns) {
        mk[k] = *cluster.map_shared_rank(pm + h, k);
        lk[k] = *cluster.map_shared_rank(pl + h, k);
        ak[k] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(pacc + 2 * p, k));
        mx = fmaxf(mx, mk[k]);
      }
    }
    float den = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      if (k < ns) {
        const float wk = exp2_(mk[k] - mx);   // 0 for a split with no live token
        den += wk * lk[k];
        n0 += wk * ak[k].x;
        n1 += wk * ak[k].y;
      }
    }
    store2(out + (static_cast<long long>(s) * n_head + h0) * D + 2 * p, n0 / den, n1 / den);
  }
  cluster.sync();                         // peers may still read this CTA
}

template <typename T, int C>
cudaError_t launch_cluster(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q,
                           void* out, const int* tables, const int* lengths, int S,
                           int n_head, int D, int MB, int BS, int layer, int G, int Tb,
                           int CH, int splits, int L, float qscale, cudaStream_t st) {
  const int P = (MB + splits - 1) / splits;
  const int smem = layout(G, D, Tb, P, sizeof(T)).total + 128;
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_cluster_kernel<T, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_head / G, S);
  cfg.blockDim = dim3(32 * (G + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_decode_cluster_kernel<T, C>, kmap, vmap,
                            static_cast<const T*>(q), static_cast<T*>(out), tables, lengths,
                            n_head, D, MB, BS, layer, G, Tb, CH, L, qscale);
}

// C: 16-byte loads a lane, at most 16 values (2 in 16-bit types, 4 in float32).
template <typename T>
cudaError_t launch_cluster(int C, const CUtensorMap& kmap, const CUtensorMap& vmap,
                           const void* q, void* out, const int* tables, const int* lengths,
                           int S, int n_head, int D, int MB, int BS, int layer, int G, int Tb,
                           int CH, int splits, int L, float qscale, cudaStream_t st) {
  switch (C) {
    case 1: return launch_cluster<T, 1>(kmap, vmap, q, out, tables, lengths, S, n_head, D, MB,
                                        BS, layer, G, Tb, CH, splits, L, qscale, st);
    case 2: return launch_cluster<T, 2>(kmap, vmap, q, out, tables, lengths, S, n_head, D, MB,
                                        BS, layer, G, Tb, CH, splits, L, qscale, st);
    default:
      if constexpr (sizeof(T) == 4) {
        return launch_cluster<T, 4>(kmap, vmap, q, out, tables, lengths, S, n_head, D, MB, BS,
                                    layer, G, Tb, CH, splits, L, qscale, st);
      }
      return cudaErrorInvalidValue;
  }
}

// ====================================================== 2. the first design
constexpr int kWarps = 4;
constexpr int kChunk = 8;             // tokens per online-softmax update
constexpr int kMaxPairsPerLane = 4;   // head_dim <= 256

// NP: pairs of head_dim elements each lane holds, ceil(head_dim / 64).
template <typename T, int NP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, T* __restrict__ out,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, int n_head, int head_dim,
                    int max_blocks, int block_size, long long layer_offset,
                    long long stride_block, long long stride_tok,
                    long long stride_head, float scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_pairs = head_dim / 2;

  const int length = lengths[s];
  const int n_pages =
      min((length + block_size - 1) / block_size, max_blocks);
  const int* table = tables + static_cast<long long>(s) * max_blocks;
  const long long row_qo = (static_cast<long long>(s) * n_head + h) * head_dim;

  bool has[NP];
  float qf[2 * NP], acc[2 * NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    has[i] = p < n_pairs;
    const float2 v = has[i] ? load2(q + row_qo + 2 * p) : make_float2(0.f, 0.f);
    qf[2 * i] = v.x;
    qf[2 * i + 1] = v.y;
    acc[2 * i] = 0.f;
    acc[2 * i + 1] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* k_head = k_pool + layer_offset + h * stride_head;
  const T* v_head = v_pool + layer_offset + h * stride_head;
  // n_pages and n_tok are uniform across the warp, so every lane reaches
  // each shuffle below.
  for (int b = warp; b < n_pages; b += kWarps) {
    const long long page_off = static_cast<long long>(table[b]) * stride_block;
    const int n_tok = min(block_size, length - b * block_size);
    for (int t0 = 0; t0 < n_tok; t0 += kChunk) {
      float2 kr[kChunk][NP], vr[kChunk][NP];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool live = t0 + j < n_tok;
        const long long row = page_off + (t0 + j) * stride_tok;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int p = lane + 32 * i;
          if (live && has[i]) {
            kr[j][i] = load2(k_head + row + 2 * p);
            vr[j][i] = load2(v_head + row + 2 * p);
          } else {
            kr[j][i] = make_float2(0.f, 0.f);
            vr[j][i] = make_float2(0.f, 0.f);
          }
        }
      }
      float sc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          d += qf[2 * i] * kr[j][i].x + qf[2 * i + 1] * kr[j][i].y;
        }
        sc[j] = d;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sc[j] = (t0 + j < n_tok) ? sc[j] * scale : -INFINITY;
        cmax = fmaxf(cmax, sc[j]);
      }
      const float m_new = fmaxf(m, cmax);   // finite: token t0 is live
      const float alpha = expf(m - m_new);  // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 2 * NP; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float pj = expf(sc[j] - m_new);  // 0 for masked tokens
        l += pj;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[2 * i] += pj * vr[j][i].x;
          acc[2 * i + 1] += pj * vr[j][i].y;
        }
      }
      m = m_new;
    }
  }

  // Merge the warps' partial softmax states. A warp that got no page keeps
  // m = -inf, l = 0, acc = 0 and weighs nothing; warp 0 always has page 0
  // because lengths[s] >= 1.
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][64 * kMaxPairsPerLane];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (has[i]) {
      sm_acc[warp][2 * p] = acc[2 * i];
      sm_acc[warp][2 * p + 1] = acc[2 * i + 1];
    }
  }
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kWarps];
  float denom = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
    denom += sm_l[w] * wgt[w];
  }
  for (int p = threadIdx.x; p < n_pairs; p += kWarps * 32) {
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sm_acc[w][2 * p] * wgt[w];
      c += sm_acc[w][2 * p + 1] * wgt[w];
    }
    store2(out + row_qo + 2 * p, a / denom, c / denom);
  }
}

template <typename T>
void launch(int np, dim3 grid, cudaStream_t st, const void* q,
            const void* k_pool, const void* v_pool, void* out,
            const int* tables, const int* lengths, int n_head, int head_dim,
            int max_blocks, int block_size, long long layer_offset,
            long long stride_block, long long stride_tok,
            long long stride_head, float scale) {
  const dim3 block(kWarps * 32);
#define PAGED_DECODE_LAUNCH(NP)                                             \
  paged_decode_kernel<T, NP><<<grid, block, 0, st>>>(                       \
      static_cast<const T*>(q), static_cast<const T*>(k_pool),              \
      static_cast<const T*>(v_pool), static_cast<T*>(out), tables, lengths, \
      n_head, head_dim, max_blocks, block_size, layer_offset, stride_block, \
      stride_tok, stride_head, scale)
  switch (np) {
    case 1: PAGED_DECODE_LAUNCH(1); break;
    case 2: PAGED_DECODE_LAUNCH(2); break;
    case 3: PAGED_DECODE_LAUNCH(3); break;
    default: PAGED_DECODE_LAUNCH(4); break;
  }
#undef PAGED_DECODE_LAUNCH
}

}  // namespace

// Encode the TMA map of one pool [n_layer, num_blocks, block_size, n_head,
// head_dim] (dtype 0 float32, 1 bfloat16, 2 float16) with a box of `rows`
// tokens x `heads` heads into map_out (128 bytes, any alignment). The wrapper
// keeps it per pool. Returns a cudaError.
extern "C" int paged_decode_pool_map(void* map_out, const void* pool, int dtype,
                                     long long n_layer, long long num_blocks, int block_size,
                                     int n_head, int head_dim, int heads, int rows) {
  const int es = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || reinterpret_cast<uintptr_t>(pool) % 16 != 0 ||
      head_dim < 1 || head_dim > 256 || (head_dim * es) % 16 != 0 || heads < 1 ||
      heads > n_head || rows < 1 || rows > 256 || rows > block_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const cudaError_t err = tc::make_pool_map(&map, pool, dtype, n_layer, num_blocks, block_size,
                                            n_head, head_dim, heads, rows);
  if (err == cudaSuccess) memcpy(map_out, &map, sizeof(map));
  return static_cast<int>(err);
}

// The cluster design. q, out: [n_slots, n_head, 1, head_dim] contiguous;
// k_map, v_map: the pools' maps from paged_decode_pool_map with box (heads,
// rows) = (heads_per_group, tokens_per_box); tables: int32 [n_slots,
// max_blocks]; lengths: int32 [n_slots], each >= 1. The plan
// (ops/paged_attention.py cluster_plan): head_dim * element size is 16 bytes
// times a power of two R, split as lanes x C loads with C = min(R, 16 values);
// heads_per_group <= 8 divides n_head; tokens_per_box * boxes_per_page >=
// block_size; a box takes at most 4 passes of 32 / lanes tokens; splits <= 8
// CTAs a cluster. Returns the launch's cudaError.
extern "C" int paged_decode_cluster(const void* q, const void* k_map, const void* v_map,
                                    void* out, const void* tables, const void* lengths,
                                    int n_slots, int n_head, int head_dim, int max_blocks,
                                    int block_size, int layer, int heads_per_group,
                                    int tokens_per_box, int boxes_per_page, int splits,
                                    int lanes, float scale, int dtype, void* stream) {
  const int G = heads_per_group, Tb = tokens_per_box, CH = boxes_per_page, L = lanes;
  const int es = dtype == 0 ? 4 : 2;
  const int R = head_dim * es / 16;                 // 16-byte loads in a row
  const int C = R < es ? R : es;                    // at most 16 values a lane
  if (dtype < 0 || dtype > 2 || n_slots < 1 || n_slots > 65535 || head_dim < 2 ||
      head_dim > 256 || (head_dim * es) % 16 != 0 || (R & (R - 1)) != 0 || L < 1 ||
      L * C != R || L > 16 || G < 1 || G > kMaxGroup || n_head % G != 0 ||
      n_head / G > 65535 || block_size < 1 || max_blocks < 1 || Tb < 1 || Tb > 256 ||
      Tb > kMaxPass * (32 / L) || CH < 1 || Tb * CH < block_size || splits < 1 ||
      splits > kMaxSplits || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap kmap, vmap;
  memcpy(&kmap, k_map, sizeof(kmap));
  memcpy(&vmap, v_map, sizeof(vmap));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const float qscale = scale * 1.4426950408889634f;   // scores in the log2 domain
  cudaError_t err;
  if (dtype == 0) {
    err = launch_cluster<float>(C, kmap, vmap, q, out, tb, ln, n_slots, n_head, head_dim,
                                max_blocks, block_size, layer, G, Tb, CH, splits, L, qscale, st);
  } else if (dtype == 1) {
    err = launch_cluster<__nv_bfloat16>(C, kmap, vmap, q, out, tb, ln, n_slots, n_head, head_dim,
                                        max_blocks, block_size, layer, G, Tb, CH, splits, L,
                                        qscale, st);
  } else {
    err = launch_cluster<__half>(C, kmap, vmap, q, out, tb, ln, n_slots, n_head, head_dim,
                                 max_blocks, block_size, layer, G, Tb, CH, splits, L, qscale,
                                 st);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The first design. q, out: [n_slots, n_head, 1, head_dim]; pools:
// [n_layer, num_blocks, block_size, n_head, head_dim] with the given element
// strides; tables: int32 [n_slots, max_blocks]; lengths: int32 [n_slots],
// each >= 1. layer_offset = li * (layer stride); dtype 0 float32,
// 1 bfloat16, 2 float16. Returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, void* out, const void* tables,
                            const void* lengths, int n_slots, int n_head,
                            int head_dim, int max_blocks, int block_size,
                            long long layer_offset, long long stride_block,
                            long long stride_tok, long long stride_head,
                            float scale, int dtype, void* stream) {
  const int np = (head_dim / 2 + 31) / 32;
  if (head_dim % 2 != 0 || np < 1 || np > kMaxPairsPerLane || n_slots < 1 ||
      n_head < 1 || block_size < 1 || max_blocks < 1 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_slots, n_head);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1) {
    launch<__nv_bfloat16>(np, grid, st, q, k_pool, v_pool, out, tb, ln,
                          n_head, head_dim, max_blocks, block_size,
                          layer_offset, stride_block, stride_tok, stride_head,
                          scale);
  } else if (dtype == 2) {
    launch<__half>(np, grid, st, q, k_pool, v_pool, out, tb, ln, n_head,
                   head_dim, max_blocks, block_size, layer_offset,
                   stride_block, stride_tok, stride_head, scale);
  } else {
    launch<float>(np, grid, st, q, k_pool, v_pool, out, tb, ln, n_head,
                  head_dim, max_blocks, block_size, layer_offset,
                  stride_block, stride_tok, stride_head, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
