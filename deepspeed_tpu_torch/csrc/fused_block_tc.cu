// Fused attention half of a transformer block on Hopper's tensor cores
// (sm_90a), bound through ctypes:  out = x + proj(attention(qkv(layernorm(x)))).
//
// Replaces the kernel body _fused_block_kernel of
// deepspeed_tpu/ops/pallas/fused_block.py (launched by _fused_block_impl),
// for 16-bit x (bfloat16, float16) at the widths ops/fused_block.py's shape
// rule (tensor_core_plan) admits; fused_block.cu's CUDA-core design takes
// float32 and the other shapes. It computes what the TPU body computes, not
// its blocking, in two entries:
//   fused_block_qkv_tc   LayerNorm of 64 rows into shared memory, then the
//                        whole qkv product (q, k and v) plus bias into a
//                        head-major [3, B, H, T, D] workspace of x's type;
//   fused_block_attn_tc  for a 64-row q tile, per head flash attention over
//                        the workspace's K/V tiles, each head's context cast
//                        into a [64, E] buffer in shared memory, then the
//                        output projection against streamed weight tiles,
//                        + b_proj + x, one rounding, one store.
// What reaches device memory: the workspace (q, k and v, 3 * B*T*E values of
// x's type) and the output. The normalized activations, the scores, the
// probabilities, the per-head contexts and the pre-residual output do not.
//
// Rounding points, as the TPU body and fused_block.cu: LayerNorm in f32
// (two-pass variance) cast to x's type; every product accumulates in f32 over
// operands of x's type; the qkv bias added in f32 before the one cast; scores
// * sm_scale in f32 (carried as * sm_scale * log2(e) for exp2), causal lanes
// masked on the diagonal tile and tiles above it skipped; online softmax,
// exp(s - running max) rounded to x's type before its product with V, the row
// sum over the unrounded values; each head's context (divided by its row sum)
// cast to x's type; x + out + b_proj summed in f32 and cast once.
//
// Bound: operations. At GPT-2 124M's shape (x [8, 1024, 768] bf16, 12 heads
// of 64, causal) the op does 38.7 GFLOP of weight products and 12.9 GFLOP of
// attention: 52 us at 989 TFLOP/s, against 9 us for its 30 MB.
//
// Design. Both entries: a CTA owns 64 rows (the wgmma M) and runs n_wg (1 or
// 2) consumer warpgroups, each fed by its own producer warp through its own
// ring of TMA stages with full/empty mbarriers; shared memory holds [64, E]
// in 128-byte-swizzled atoms of [64 rows, 64 columns] (E / 64 of them, 8 KB
// each: 96 KB at E 768, 200 KB at E 1600), so E is a multiple of 64 and the
// plan (ops/fused_block.py, tensor_core_plan) sizes the rings to what is left
// of the 227 KB.
// - qkv: TMA puts the CTA's 64 rows of x in the atoms and the consumer warps
//   normalize them in place (16 bytes a lane); the producers stream [64 k,
//   NC] tiles of w_qkv, warpgroup w taking column chunks w, w + n_wg, ...;
//   per stage four wgmma.m64nNCk16 (A the rows, K-major; B the weight tile,
//   MN-major) with one group in flight; epilogue bias + cast + store.
// - attn: a cluster of 2 CTAs owns a q tile, so that the causal mask's
//   heaviest tiles (16 K/V tiles a head at T 1024, against 8.5 on average)
//   are spread over two SMs: CTA r takes the heads r, r + 2, ..., its
//   warpgroups taking turns. A producer puts the head's q tile by TMA
//   straight into the head's own atoms of the context buffer when D is a
//   multiple of 64 (else into a q tile of its own), then the head's 64-key K
//   and V tiles through the ring. S = q K^T by wgmma into registers, the
//   online softmax on the accumulator fragments, P packed into A registers
//   for O += P V (as flash_attention.cu's flash_fwd_tc); tiles above the
//   causal diagonal skipped; heaviest q tiles first. The context O / l is
//   written over the head's columns of the buffer. Then each CTA copies the
//   peer's heads' columns from the peer's buffer (distributed shared memory,
//   handshakes on two mbarriers), and its producers, whose rings the
//   attention has released, stream [64 k, NC] tiles of w_proj for its half
//   of the output column chunks, which its warpgroups multiply by the whole
//   buffer. No atomics, no split-K: each output element has one owner, so
//   the output is deterministic.
// Left for a later change: a TMA store epilogue; overlapping a head's
// softmax with its next product.

#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "tc_tiles.cuh"

namespace {

using tc::col;
using tc::exp2_;
using tc::quad_max;
using tc::quad_sum;
using tc::row8;
using tc::store2;

constexpr int kRows = 64;                 // rows a CTA (the wgmma M)
constexpr int kAtom = 64 * 128;           // bytes of a [64 rows, 64 columns] atom
constexpr int kMaxThreads = 320;          // two consumer warpgroups, two producer warps
constexpr long long kSmemMax = 232448;    // dynamic shared memory a CTA may use
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;  // _MASK_VALUE of the TPU kernel, in exp2's units

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------ shared memory
// Bytes a CTA asks for; ops/fused_block.py (_qkv_smem, _attn_smem) computes
// the same to choose the plan.
long long qkv_smem(int E, int nc, int n_wg, int stages) {
  return 1024LL + static_cast<long long>(E / 64) * kAtom +
         static_cast<long long>(n_wg) * stages * (nc / 64) * kAtom + (n_wg * 2 * stages + 1) * 8;
}
long long attn_smem(int E, int dp, bool q_in_ctx, int n_wg, int kv_stages, int proj_stages) {
  return 1024LL + static_cast<long long>(E / 64) * kAtom +
         (q_in_ctx ? 0 : static_cast<long long>(n_wg) * (dp / 64) * kAtom) +
         static_cast<long long>(n_wg) * kv_stages * 2 * (dp / 64) * kAtom +
         (n_wg * (2 * kv_stages + 2 * proj_stages + 2) + 2) * 8;
}

// LayerNorm in place of the 64 rows of x that TMA put in the swizzled atoms
// at sA, in x's type; rows row0 + r >= M (zeros) stay zero. Warp `warp` of
// `n_warps` (4 or 8) takes rows warp + n_warps k, all of them at once so
// that their reductions overlap; a lane takes the 16-byte chunks lane, lane +
// 32, ... of each row, and reads back only what it wrote, so no barrier is
// needed inside. Each chunk's scale and bias are read once for all rows.
template <typename T, int kMaxRows>
__device__ __forceinline__ void layer_norm_rows(uint8_t* sA, long long row0, long long M, int E,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias, float eps,
                                                int warp, int n_warps, int lane) {
  const int chunks = E / 8, n_rows = kRows / n_warps;
  float mean[kMaxRows], rstd[kMaxRows];
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) mean[k] = rstd[k] = 0.f;
  for (int c = lane; c < chunks; c += 32)
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k >= n_rows) break;
      const uint4 v = *reinterpret_cast<const uint4*>(sA + tc::sw128(warp + n_warps * k, 8 * c));
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) mean[k] += to_f(e[j]);
    }
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) mean[k] = warp_sum(mean[k]) / static_cast<float>(E);
  for (int c = lane; c < chunks; c += 32)
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k >= n_rows) break;
      const uint4 v = *reinterpret_cast<const uint4*>(sA + tc::sw128(warp + n_warps * k, 8 * c));
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = to_f(e[j]) - mean[k];
        rstd[k] += d * d;
      }
    }
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k)
    rstd[k] = 1.f / sqrtf(warp_sum(rstd[k]) / static_cast<float>(E) + eps);
  for (int c = lane; c < chunks; c += 32) {
    float g[8], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] = scale[8 * c + j];
      b[j] = bias[8 * c + j];
    }
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k >= n_rows) break;
      const int r = warp + n_warps * k;
      uint4* at = reinterpret_cast<uint4*>(sA + tc::sw128(r, 8 * c));
      uint4 v = *at;
      T* e = reinterpret_cast<T*>(&v);
      const bool valid = row0 + r < M;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = from_f<T>(valid ? (to_f(e[j]) - mean[k]) * rstd[k] * g[j] + b[j] : 0.f);
      *at = v;
    }
  }
}

// A warpgroup's ring: `stages` stages at base, a full barrier (the
// producer's expect_tx and the TMA bytes) and an empty one (one arrival per
// consumer warp) each.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
};

// The producer's side: weight tiles [64 k, NC] of the [K, N] map for column
// chunks first, first + step, ... below n_chunks, each over the whole K.
template <int NC>
__device__ __forceinline__ void produce_weights(const CUtensorMap* map, const Ring& r, int first,
                                                int step, int n_chunks, int ksteps) {
  constexpr int kStage = NC / 64 * kAtom;
  int i = 0;
  for (int c = first; c < n_chunks; c += step)
    for (int ks = 0; ks < ksteps; ++ks, ++i) {
      const int s = i % r.stages;
      if (i >= r.stages) tc::mbar_wait(&r.empty[s], ((i / r.stages) - 1) & 1);
      tc::mbar_arrive_expect_tx(&r.full[s], kStage);
#pragma unroll
      for (int a = 0; a < NC / 64; ++a)
        tc::tma_load(r.base + s * kStage + a * kAtom, map, &r.full[s], c * NC + 64 * a, 64 * ks, 0);
    }
}

// The consumers' side: one [64, NC] chunk of A (the [64, K] atoms at sA,
// K-major) times K / 64 weight stages from stage counter i on. One wgmma
// group stays in flight; a stage is released once the next one's group is
// issued and its own has finished, so the ring needs two stages or more.
template <bool kHalf, int NC>
__device__ __forceinline__ void chunk_product(float (&acc)[NC / 2], const uint8_t* sA,
                                              const Ring& r, int ksteps, int& i, int lane) {
  constexpr int kStage = NC / 64 * kAtom;
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) acc[e] = 0.f;
  for (int ks = 0; ks < ksteps; ++ks, ++i) {
    const int s = i % r.stages;
    tc::mbar_wait(&r.full[s], (i / r.stages) & 1);
    const uint8_t* wt = r.base + s * kStage;
    tc::fence_regs(acc);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_ss_t<kHalf>(acc, tc::desc_k(sA, 4 * ks + kk, kAtom), tc::desc_mn(wt, kk, kAtom),
                            ks | kk);
    tc::wg_commit();
    tc::wg_wait1();
    tc::fence_regs(acc);
    if (ks > 0 && lane == 0) tc::mbar_arrive(&r.empty[(i - 1) % r.stages]);
  }
  tc::wg_wait();
  tc::fence_regs(acc);
  if (lane == 0) tc::mbar_arrive(&r.empty[(i - 1) % r.stages]);
}

// ---------------------------------------------------------------- qkv
// Grid: ceil(B*T / 64) CTAs of 160 * n_wg threads: warps 0 .. 4 n_wg - 1 are
// the consumers, warp 4 n_wg + w warpgroup w's producer; warpgroup 0's
// producer also puts the CTA's 64 rows of x by TMA (mx: x as [B*T, E],
// boxes of 64 rows).
template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads, 1)
qkv_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
           const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
           const float* __restrict__ b_qkv, T* __restrict__ ws, int B, int Tn, int E, int H,
           float eps, int n_wg, int stages) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kStage = NC / 64 * kAtom;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = tc::align1024(smem_raw);                        // E / 64 atoms
  uint8_t* rings = sA + (E / 64) * kAtom;                       // n_wg x stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + n_wg * stages * kStage);
  uint64_t* x_full = bars + 2 * n_wg * stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_cons = 4 * n_wg;                                  // consumer warps
  const long long M = static_cast<long long>(B) * Tn;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int n_chunks = 3 * E / NC, ksteps = E / 64;

  if (threadIdx.x == 0) {
    for (int w = 0; w < n_wg; ++w)
      for (int s = 0; s < stages; ++s) {
        tc::mbar_init(&bars[2 * w * stages + s], 1);       // expect_tx, and the bytes
        tc::mbar_init(&bars[(2 * w + 1) * stages + s], 4); // each consumer warp
      }
    tc::mbar_init(x_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  const int wg = warp < n_cons ? warp / 4 : warp - n_cons;
  const Ring ring{rings + wg * stages * kStage, bars + 2 * wg * stages,
                  bars + (2 * wg + 1) * stages, stages};
  if (warp >= n_cons) {   // ------------------------------------- producer
    if (lane == 0) {
      if (wg == 0) {
        tc::mbar_arrive_expect_tx(x_full, E * 128);
        for (int a = 0; a < E / 64; ++a) tc::tma_load(sA + a * kAtom, &mx, x_full, 64 * a, row0, 0);
      }
      produce_weights<NC>(&mw, ring, wg, n_wg, n_chunks, ksteps);
    }
  } else {                // ------------------------------------ consumers
    tc::mbar_wait(x_full, 0);
    if (n_wg == 2)
      layer_norm_rows<T, 8>(sA, row0, M, E, ln_scale, ln_bias, eps, warp, n_cons, lane);
    else
      layer_norm_rows<T, 16>(sA, row0, M, E, ln_scale, ln_bias, eps, warp, n_cons, lane);
    tc::fence_proxy_async();
    tc::named_sync(1, 128 * n_wg);

    const int w = warp % 4, g = lane / 4, t = lane % 4;
    const int D = E / H;
    // this thread's two rows: where row (b, t) of each head starts
    long long row_at[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long m = row0 + 16 * w + g + 8 * r;
      const long long b = m / Tn;
      row_at[r] = m < M ? (b * H * Tn + (m - b * Tn)) * D : -1;
    }
    int i = 0;
    for (int c = wg; c < n_chunks; c += n_wg) {
      float acc[NC / 2];
      chunk_product<kHalf, NC>(acc, sA, ring, ksteps, i, lane);
      // + bias, rounded, and stored 16 bytes a lane: combo k of column
      // groups j, j + 1 is row r = k & 1, group j + k / 2 (8 columns, which
      // never straddle a head: D % 8 == 0)
#pragma unroll
      for (int j = 0; j < NC / 8; j += 2) {
        uint32_t wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int jj = j + k / 2, r = k % 2;
          const float* bq = b_qkv + c * NC + 8 * jj + 2 * t;
          wv[k] = tc::pack2<kHalf>(acc[4 * jj + 2 * r] + bq[0], acc[4 * jj + 2 * r + 1] + bq[1]);
        }
        tc::quad_transpose(wv, t);
        const int r = t % 2, n0 = c * NC + 8 * (j + t / 2);
        const int which = n0 / E, h = (n0 - which * E) / D;
        const long long head = ((static_cast<long long>(which) * B * H + h) * Tn) * D +
                               (n0 - which * E - h * D);
        if (row_at[r] >= 0)
          *reinterpret_cast<uint4*>(ws + head + row_at[r]) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      }
    }
  }
}

// ---------------------------------------------------------------- attn
// The scores of one key tile in exp2's units, in place: scaled, masked, and
// each of the thread's two rows' maximum. kEdge: the tile is the causal
// diagonal's (diag) or reaches past the last key, and its elements are
// tested; the other tiles skip the tests.
template <bool kEdge>
__device__ __forceinline__ void tile_scores(float (&sc)[32], float (&mx)[2], float scale2, int k0,
                                            int r0, int t, bool diag, int Tn) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int kj = k0 + col(e, t);
    float x = sc[e] * scale2;
    if (kEdge) {
      if (kj >= Tn) {
        x = -INFINITY;
      } else if (diag && kj > r0 + 8 * row8(e)) {
        x = kMasked;
      }
    }
    sc[e] = x;
    mx[row8(e)] = fmaxf(mx[row8(e)], x);
  }
}

// Grid: 2 * B * ceil(T / 64) CTAs in clusters of 2, of 160 * n_wg threads
// laid out as qkv_kernel's. Cluster p takes q tile n_qt - 1 - p / B of
// sequence p % B (heaviest tiles first, over all sequences); its CTA of rank
// r the heads r, r + 2, ... (warpgroup w: r + 2 w, r + 2 (w + n_wg), ...),
// then, with the peer's contexts copied in, the output column chunks r + 2 w,
// .... Shared memory: the context buffer (E / 64 atoms), the q tiles (none
// when D % 64 == 0: q lands in the head's own atoms), the rings (n_wg x
// kv_stages of a K and a V tile; the projection's proj_stages of NC / 64
// atoms reuse them), per warpgroup the barriers (K/V full and empty,
// projection full and empty, q full and empty), and two for the exchange:
// ctx_ready (the peer's contexts are written) and ctx_read (the peer has
// copied this CTA's), each taking an arrival from every consumer thread of
// the peer.
template <typename T, int DP, int NC>
__global__ void __launch_bounds__(kMaxThreads, 1)
attn_kernel(const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mw,
            const T* __restrict__ x, const float* __restrict__ b_proj, T* __restrict__ out,
            int B, int Tn, int E, int H, float scale2, int causal, int n_wg, int kv_stages,
            int proj_stages) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = DP / 64 * kAtom;       // one [64, DP] tile
  constexpr int kKV = 2 * kTile;               // a K/V stage
  const int D = E / H;
  const bool q_in_ctx = D % 64 == 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sC = tc::align1024(smem_raw);                         // E / 64 atoms
  uint8_t* sQ = sC + (E / 64) * kAtom;                           // n_wg q tiles, or none
  uint8_t* rings = sQ + (q_in_ctx ? 0 : n_wg * kTile);           // n_wg x kv_stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + n_wg * kv_stages * kKV);
  const int nb = 2 * kv_stages + 2 * proj_stages + 2;            // barriers a warpgroup
  uint64_t* ctx_ready = bars + n_wg * nb;
  uint64_t* ctx_read = ctx_ready + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_cons = 4 * n_wg;
  const uint32_t rank = tc::cluster_rank(), peer = rank ^ 1;
  const int n_qt = (Tn + kRows - 1) / kRows;
  const int pair = blockIdx.x / 2;
  const int qt = n_qt - 1 - pair / B;                            // heaviest first
  const int b = pair % B;
  const int q0 = qt * kRows;
  const int n_tiles = causal ? qt + 1 : n_qt;                    // key tiles a head needs
  const int n_chunks = E / NC, ksteps = E / 64;

  if (threadIdx.x == 0) {
    for (int w = 0; w < n_wg; ++w) {
      uint64_t* wb = bars + w * nb;
      for (int s = 0; s < kv_stages; ++s) {
        tc::mbar_init(&wb[s], 1);
        tc::mbar_init(&wb[kv_stages + s], 4);
      }
      for (int s = 0; s < proj_stages; ++s) {
        tc::mbar_init(&wb[2 * kv_stages + s], 1);
        tc::mbar_init(&wb[2 * kv_stages + proj_stages + s], 4);
      }
      tc::mbar_init(&wb[nb - 2], 1);   // q full
      tc::mbar_init(&wb[nb - 1], 4);   // q empty
    }
    tc::mbar_init(ctx_ready, 128 * n_wg);
    tc::mbar_init(ctx_read, 128 * n_wg);
    tc::fence_barrier_init();
  }
  tc::cluster_sync();   // the peer's exchange barriers are ready

  const int wg = warp < n_cons ? warp / 4 : warp - n_cons;
  uint64_t* wb = bars + wg * nb;
  uint8_t* ring_base = rings + wg * kv_stages * kKV;
  const Ring kv{ring_base, wb, wb + kv_stages, kv_stages};
  const Ring proj{ring_base, wb + 2 * kv_stages, wb + 2 * kv_stages + proj_stages, proj_stages};
  uint64_t* q_full = wb + nb - 2;
  uint64_t* q_empty = wb + nb - 1;
  uint8_t* myQ = sQ + wg * kTile;
  const int h_first = rank + 2 * wg, h_step = 2 * n_wg;          // this warpgroup's heads and chunks

  if (warp >= n_cons) {   // ------------------------------------- producer
    if (lane != 0) return;
    int i = 0, j = 0;     // K/V tiles and heads issued
    for (int h = h_first; h < H; h += h_step, ++j) {
      // one q tile in flight: q_full takes one arrival a phase, and a q
      // tile of its own is overwritten only once the last head's S is done
      uint8_t* qdst = q_in_ctx ? sC + (h * D / 64) * kAtom : myQ;
      if (j > 0) tc::mbar_wait(q_empty, (j - 1) & 1);
      tc::mbar_arrive_expect_tx(q_full, kTile);
#pragma unroll
      for (int a = 0; a < DP / 64; ++a)
        tc::tma_load(qdst + a * kAtom, &mqkv, q_full, 64 * a, q0, b * H + h);
      const int kbh = (B + b) * H + h, vbh = (2 * B + b) * H + h;
      for (int kt = 0; kt < n_tiles; ++kt, ++i) {
        const int s = i % kv_stages;
        if (i >= kv_stages) tc::mbar_wait(&kv.empty[s], ((i / kv_stages) - 1) & 1);
        tc::mbar_arrive_expect_tx(&kv.full[s], kKV);
        uint8_t* st = kv.base + s * kKV;
#pragma unroll
        for (int a = 0; a < DP / 64; ++a) {
          tc::tma_load(st + a * kAtom, &mqkv, &kv.full[s], 64 * a, kt * kRows, kbh);
          tc::tma_load(st + kTile + a * kAtom, &mqkv, &kv.full[s], 64 * a, kt * kRows, vbh);
        }
      }
    }
    // every K/V stage released before the ring takes weight tiles
    for (int k = i > kv_stages ? i - kv_stages : 0; k < i; ++k)
      tc::mbar_wait(&kv.empty[k % kv_stages], (k / kv_stages) & 1);
    produce_weights<NC>(&mw, proj, h_first, h_step, n_chunks, ksteps);
    return;
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x;                 // 0 .. 128 n_wg - 1
  const int w = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * w + g;              // this thread's rows r0, r0 + 8
  int i = 0, j = 0;
  for (int h = h_first; h < H; h += h_step, ++j) {
    const uint8_t* q = q_in_ctx ? sC + (h * D / 64) * kAtom : myQ;
    tc::mbar_wait(q_full, j & 1);
    float o[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int kt = 0; kt < n_tiles; ++kt, ++i) {
      const int s = i % kv_stages;
      tc::mbar_wait(&kv.full[s], (i / kv_stages) & 1);
      const uint8_t* ktile = kv.base + s * kKV;
      const uint8_t* vtile = ktile + kTile;
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(sc, tc::desc_k(q, kk, kAtom), tc::desc_k(ktile, kk, kAtom), kk);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(sc);
      if (kt == n_tiles - 1 && lane == 0) tc::mbar_arrive(q_empty);

      const int k0 = kt * kRows;
      const bool diag = causal && kt == qt;
      float mx[2];
      if (diag || k0 + kRows > Tn)
        tile_scores<true>(sc, mx, scale2, k0, r0, t, diag, Tn);
      else
        tile_scores<false>(sc, mx, scale2, k0, r0, t, diag, Tn);
      // the first tile holds key 0, which no row masks: m_new is finite
      float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2_(m[r] - m_new[r]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = exp2_(sc[e] - m_new[row8(e)]);
        rs[row8(e)] += p;
        sc[e] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o[e] *= alpha[row8(e)];

      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::acc_to_a<kHalf>(sc, kk, pa[kk]);
      tc::fence_regs(o);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::wgmma_rs<kHalf>(o, pa[kk], tc::desc_mn(vtile, kk, kAtom), 1);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(o);
      if (lane == 0) tc::mbar_arrive(&kv.empty[s]);
    }

    // the head's context over its columns of the buffer (over q, when q
    // landed there: every product that read it has finished)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * w + g + 8 * r;
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c < D)
          store2(reinterpret_cast<T*>(sC + tc::sw128(row, h * D + c)), o[4 * jj + 2 * r] / l[r],
                 o[4 * jj + 2 * r + 1] / l[r]);
      }
    }
  }

  // The exchange: this CTA's contexts are written (each thread releases its
  // own writes to the peer); once the peer's are, copy the peer's heads'
  // columns (whole 16-byte chunks: D % 8 == 0) from its buffer into the same
  // places of this one, and tell the peer its buffer has been read.
  tc::mbar_arrive_cluster(ctx_ready, peer);
  tc::mbar_wait<true>(ctx_ready, 0);
  const int row_chunks = E / 8;
  for (int idx = tid; idx < kRows * row_chunks; idx += 128 * n_wg) {
    const int row = idx / row_chunks, col = 8 * (idx % row_chunks);
    if ((col / D) % 2 == static_cast<int>(peer)) {
      const uint32_t off = tc::sw128(row, col);
      *reinterpret_cast<uint4*>(sC + off) = tc::ld_cluster_v4(sC + off, peer);
    }
  }
  tc::mbar_arrive_cluster(ctx_read, peer);
  tc::fence_proxy_async();
  tc::named_sync(1, 128 * n_wg);   // every head's context is in the buffer

  // out = x + y w_proj + b_proj over this CTA's column chunks
  int p = 0;
  for (int c = h_first; c < n_chunks; c += h_step) {
    float acc[NC / 2];
    chunk_product<kHalf, NC>(acc, sC, proj, ksteps, p, lane);
    // x + out + b_proj in f32, rounded once, stored 16 bytes a lane (as in
    // qkv_kernel's epilogue)
    const long long rows[2] = {(static_cast<long long>(b) * Tn + r0) * E,
                               (static_cast<long long>(b) * Tn + r0 + 8) * E};
#pragma unroll
    for (int j = 0; j < NC / 8; j += 2) {
      uint32_t wv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jj = j + k / 2, r = k % 2;
        const int n = c * NC + 8 * jj + 2 * t;
        const float* bp = b_proj + n;
        float x0 = 0.f, x1 = 0.f;
        if (r0 + 8 * r < Tn) {
          const T* xp = x + rows[r] + n;
          x0 = to_f(xp[0]);
          x1 = to_f(xp[1]);
        }
        wv[k] = tc::pack2<kHalf>(x0 + acc[4 * jj + 2 * r] + bp[0], x1 + acc[4 * jj + 2 * r + 1] + bp[1]);
      }
      tc::quad_transpose(wv, t);
      const int r = t % 2;
      if (r0 + 8 * r < Tn)
        *reinterpret_cast<uint4*>(out + rows[r] + c * NC + 8 * (j + t / 2)) =
            make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
  }
  tc::mbar_wait<true>(ctx_read, 0);   // the peer is done with this CTA's buffer
}

// ---------------------------------------------------------------- launch
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shapes both entries take: 16-bit x, E a multiple of 64 (and of NC),
// H heads of D = E / H <= 128 a multiple of 8, 1 or 2 warpgroups.
bool supported(int B, int T, int E, int H, int nc, int n_wg, int dtype) {
  if (B < 1 || T < 1 || B > 65535 || E < 64 || E % 64 != 0 || H < 1 || E % H != 0) return false;
  const int D = E / H;
  if (D % 8 != 0 || D > 128 || (nc != 64 && nc != 128) || E % nc != 0) return false;
  if ((n_wg != 1 && n_wg != 2) || (dtype != 1 && dtype != 2)) return false;
  return static_cast<long long>(B) * T <= 2147483647LL - kRows;
}

template <typename T, int NC>
cudaError_t launch_qkv(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* w_qkv, const void* b_qkv, void* ws, int B, int Tn, int E,
                       int H, float eps, int n_wg, int stages, long long smem, cudaStream_t st) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  const long long M = static_cast<long long>(B) * Tn;
  CUtensorMap mx, mw;
  cudaError_t err;
  if ((err = tc::make_map(&mx, x, kHalf, 1, static_cast<int>(M), E, kRows)) != cudaSuccess ||
      (err = tc::make_map(&mw, w_qkv, kHalf, 1, E, 3 * E, kRows)) != cudaSuccess) {
    return err;
  }
  auto kernel = qkv_kernel<T, NC>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((M + kRows - 1) / kRows), 160 * n_wg, smem, st>>>(
      mx, mw, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const float*>(b_qkv), static_cast<T*>(ws), B, Tn, E, H, eps, n_wg, stages);
  return cudaGetLastError();
}

template <typename T, int DP, int NC>
cudaError_t launch_attn(const void* ws, const void* x, const void* w_proj, const void* b_proj,
                        void* out, int B, int Tn, int E, int H, float sm_scale, int causal,
                        int n_wg, int kv_stages, int proj_stages, long long smem,
                        cudaStream_t st) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  CUtensorMap mqkv, mw;
  cudaError_t err;
  if ((err = tc::make_map(&mqkv, ws, kHalf, 3 * B * H, Tn, E / H, kRows)) != cudaSuccess ||
      (err = tc::make_map(&mw, w_proj, kHalf, 1, E, E, kRows)) != cudaSuccess) {
    return err;
  }
  auto kernel = attn_kernel<T, DP, NC>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * B * ((Tn + kRows - 1) / kRows));
  cfg.blockDim = dim3(160 * n_wg);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, mqkv, mw, static_cast<const T*>(x),
                            static_cast<const float*>(b_proj), static_cast<T*>(out), B, Tn, E, H,
                            sm_scale * kLog2e, causal, n_wg, kv_stages, proj_stages);
}

}  // namespace

// x: [B, T, E] contiguous, dtype 1 (bfloat16) or 2 (float16), 16-byte
// aligned as w_qkv and ws are; w_qkv: [E, 3E] of that type; ln_scale,
// ln_bias: float32 [E]; b_qkv: float32 [3E]; ws:
// [3, B, H, T, E / H] of x's type, written (q, k, v head-major). nc, n_wg,
// stages (>= 2): the plan (ops/fused_block.py, tensor_core_plan). Returns the
// launch's cudaError; cudaErrorInvalidValue for shapes or a plan it does not
// take.
extern "C" int fused_block_qkv_tc(const void* x, const void* ln_scale, const void* ln_bias,
                                  const void* w_qkv, const void* b_qkv, void* ws, int B, int T,
                                  int E, int H, float eps, int nc, int n_wg, int stages,
                                  int dtype, void* stream) {
  const long long smem = qkv_smem(E, nc, n_wg, stages);
  if (!supported(B, T, E, H, nc, n_wg, dtype) || stages < 2 || smem > kSmemMax ||
      !aligned16(x) || !aligned16(w_qkv) || !aligned16(ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = nc == 128 ? launch_qkv<__nv_bfloat16, 128>(x, ln_scale, ln_bias, w_qkv, b_qkv, ws, B, T,
                                                     E, H, eps, n_wg, stages, smem, st)
                    : launch_qkv<__nv_bfloat16, 64>(x, ln_scale, ln_bias, w_qkv, b_qkv, ws, B, T,
                                                    E, H, eps, n_wg, stages, smem, st);
  } else {
    err = nc == 128 ? launch_qkv<__half, 128>(x, ln_scale, ln_bias, w_qkv, b_qkv, ws, B, T, E, H,
                                              eps, n_wg, stages, smem, st)
                    : launch_qkv<__half, 64>(x, ln_scale, ln_bias, w_qkv, b_qkv, ws, B, T, E, H,
                                             eps, n_wg, stages, smem, st);
  }
  return static_cast<int>(err);
}

// ws: what fused_block_qkv_tc wrote for the same x; w_proj: [E, E] of x's
// type; b_proj: float32 [E]; out: as x, written. kv_stages, proj_stages: the
// plan; proj_stages (>= 2) stages of nc / 64 atoms must fit the kv_stages of
// the ring.
extern "C" int fused_block_attn_tc(const void* ws, const void* x, const void* w_proj,
                                   const void* b_proj, void* out, int B, int T, int E, int H,
                                   float sm_scale, int causal, int nc, int n_wg, int kv_stages,
                                   int proj_stages, int dtype, void* stream) {
  if (!supported(B, T, E, H, nc, n_wg, dtype) || kv_stages < 1 || proj_stages < 2 ||
      3LL * B * H > 2147483647LL || 2LL * B * ((T + kRows - 1) / kRows) > 2147483647LL || !aligned16(ws) || !aligned16(x) || !aligned16(w_proj) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = E / H;
  const int dp = D <= 64 ? 64 : 128;
  const long long smem = attn_smem(E, dp, D % 64 == 0, n_wg, kv_stages, proj_stages);
  if (smem > kSmemMax || proj_stages * (nc / 64) > kv_stages * 2 * (dp / 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == 1;
  cudaError_t err;
#define FB_ATTN(TY, DPV, NCV)                                                                   \
  launch_attn<TY, DPV, NCV>(ws, x, w_proj, b_proj, out, B, T, E, H, sm_scale, causal, n_wg,    \
                            kv_stages, proj_stages, smem, st)
  if (dp == 64) {
    if (nc == 128) err = bf ? FB_ATTN(__nv_bfloat16, 64, 128) : FB_ATTN(__half, 64, 128);
    else err = bf ? FB_ATTN(__nv_bfloat16, 64, 64) : FB_ATTN(__half, 64, 64);
  } else {
    if (nc == 128) err = bf ? FB_ATTN(__nv_bfloat16, 128, 128) : FB_ATTN(__half, 128, 128);
    else err = bf ? FB_ATTN(__nv_bfloat16, 128, 64) : FB_ATTN(__half, 128, 64);
  }
#undef FB_ATTN
  return static_cast<int>(err);
}
