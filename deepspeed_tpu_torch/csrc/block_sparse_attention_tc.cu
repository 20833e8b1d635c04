// Block-sparse attention on Hopper's tensor cores (sm_90a): the forward, dq
// and dk/dv over the active blocks of a [H, T/block, T/block] layout, bound
// through ctypes.
//
// Replaces, for bf16/fp16 with D <= 128 a multiple of 8 and a layout block
// that is a multiple of 64 (ops/block_sparse_attention.py,
// tensor_core_path), the kernel bodies of
// deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   bs_fwd_tc <- _bs_fwd_kernel_res and _bs_fwd_kernel  (launched by _bs_fwd)
//   bs_dq_tc  <- _bs_dq_kernel_res  and _bs_dq_kernel   (launched by _bs_bwd)
//   bs_dkv_tc <- _bs_dkv_kernel_res and _bs_dkv_kernel  (launched by _bs_bwd)
// The other shapes (float32, D > 128, blocks of 16 or 32) keep the CUDA-core
// entries bs_fwd / bs_dq / bs_dkv of block_sparse_attention.cu. Both designs
// compute the same function, element for element: scores q.k in f32, then
// times sm_scale (here sm_scale * log2(e) on the f32 score fragments, so that
// the exponents are powers of 2: no operand is scaled and rounded); lanes
// that the causal mask drops (q < k, in blocks on the diagonal) set to
// exactly 0 by a select. Forward: the online softmax, p rounded to v's type
// before p.v, the normalizer l summed unrounded and floored at 1e-30, out =
// acc / l, lse = m + log(l) in natural log; a row with no allowed key writes
// out 0 and lse -inf (its running max stays -inf, and neither exp2(m - m_new)
// nor exp2(s - m) is taken there). Backward: p = exp(s - lse), dS = p * (dO.v
// - delta); dv = p.dO with p rounded to v's type; dS rounded to the operand
// type before dS.q and dS.k; dq = sm_scale * dS.k and dk = sm_scale * dS.q in
// f32, then cast. A row with no allowed key has lse -inf; its lse * log2e is
// taken as +inf, so that its p is exp2(-inf) = 0 and no inf * 0 arises. A
// column with no allowed query writes dk = dv = 0, a row dq = 0; nothing is
// NaN.
//
// Bound: operations, barely. At the slice's shape (B 1, H 16, T 8192, D 64,
// the Variable layout at block 256, 92 of 528 causal blocks a head) the
// forward does 2, dq 3 and dk/dv 4 products of 10.2 GFLOP over the kept
// lanes, on 68-102 MB of inputs and outputs: 0.021, 0.031 and 0.041 ms at 989
// TFLOP/s against 0.020-0.030 ms at 3.35 TB/s.
//
// Design: the flash kernels' (flash_attention.cu, flash_fwd_tc,
// flash_bwd_dq_tc and flash_bwd_dkv_tc): a CTA owns 64 rows of its own side
// per consumer warpgroup (q for the forward and dq, k for dk/dv), resident in
// shared memory by TMA (3-D maps [B*H, T, D], 128-byte swizzle); one producer
// warp streams the other side's 64-row tiles through a ring of kStages stages
// with full/empty mbarriers; S = Q K^T (S^T = K Q^T) and dP by
// wgmma.m64n64k16 from shared memory into f32 registers; P and dS packed to
// 16-bit A fragments in registers for the RS products (O += P V; dQ += dS K;
// dV += P^T dO, dK += dS^T Q), B read MN-major from the streamed tile. What
// differs:
// - The tile walk comes from the LUT. The producer walks the other side's
//   blocks of its line in the LUT (forward and dq: cols of its layout row;
//   dk/dv: rows_t of its layout column), each block as block / 64 tiles,
//   skipping under causal the tiles wholly on the masked side of the CTA's
//   rows before loading them, and publishes each tile's first row in shared
//   memory beside it; a stage whose row is -1 ends the walk. Only the
//   diagonal block's tile that lines up with a warpgroup's rows is tested
//   element by element; the others take the untested path, and a tile wholly
//   on the masked side of one warpgroup's rows (staged for the other) is
//   passed over by it.
// - A CTA's rows lie in one layout row (column): two consumer warpgroups (128
//   rows) where the block is a multiple of 128 (and, for dk/dv, D <= 64: at
//   DP = 128 one warpgroup's registers are all a thread has), else one. Both
//   warpgroups follow the CTA's one list, so each staged tile serves 128 rows.
// - Work items from the host (ops/block_sparse_attention.py, build_work; the
//   forward and dq share one list): a CTA runs one item, a range [first,
//   last) of slots of its line's list for one tile of rows. A list whose
//   tiles exceed the balanced share over the SMs (the global column of the
//   BigBird, Longformer and Variable layouts, which every q-block attends:
//   128 tile steps a CTA at the slice's shape against 89 when spread evenly;
//   the global rows of Longformer and the bidirectional layouts, which attend
//   every block) is split into parts; items run heaviest first. Each part of
//   a split list writes its f32 accumulators (the forward: its unnormalised
//   acc and each row's m and l) to a workspace slot of its own and counts its
//   arrival on the group's integer counter; the last to arrive merges every
//   part's slot in part order (the forward: M = max m_p, L = sum l_p 2^(m_p -
//   M), acc = sum acc_p 2^(m_p - M), a part at m_p = -inf adding 0) and
//   stores the result. The result is the same whichever part arrives last,
//   and no float atomics are used: two launches are bit identical.
// Registers: dk/dv at DP = 64 with two warpgroups takes a 384-thread CTA
// whose producer warpgroup hands its registers to the consumers (setmaxnreg:
// 24 + 2 x 240), as flash_bwd_dkv_tc; the others run NWG warpgroups and one
// producer warp, and may use 224-255 registers a thread, except the forward
// at DP = 64: held to two CTAs an SM (at most 112 registers a thread), so
// that one CTA's softmax, prologue and epilogue overlap the other's wgmma
// (0.114 -> 0.084 ms at the slice's shape on an H100 80GB HBM3 at 700 W,
// for 24 bytes of spill; a third ring stage made it slower:
// scripts/block_sparse_fwd_variants.py).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;             // wgmma M: a warpgroup's rows; the streamed tile
constexpr int kStages = 2;            // ring depth
constexpr int kAtom = kRows * 128;    // bytes of one [64 rows, 64 columns] 16-bit atom

template <int DP>
__host__ __device__ constexpr int tile_bytes() { return kRows * DP * 2; }

// One CTA's work (ops/block_sparse_attention.py, build_work, writes these as
// int32 rows of 8).
struct Item {
  int line;     // h * nb + r: the layout row (dq) or column (dk/dv) r of head h
  int tile;     // the CTA's rows: r * block + tile * NWG * 64 onwards
  int first;    // slots [first, last) of the line's list
  int last;
  int group;    // -1: the whole list; else the split group of the parts
  int part;     // this part's index in the group
  int parts;    // the group's parts
  int ws;       // the group's first workspace slot
};
static_assert(sizeof(Item) == 32, "the host writes 8 int32 an item");

struct Params {
  int H, T, D, block, nb;
  float sm_scale;
  float scale2;          // sm_scale * log2(e)
  int causal;
  const int* lut;        // [H * nb, width]: the line's other-side blocks, ascending
  int width;
  const Item* items;
  float* ws;             // [B, ws_parts, part floats]: partial sums of split items
  int ws_parts;
  int* arrivals;         // [B, n_groups]: counters of split groups, 0 at launch
  int n_groups;
};

template <int NWG>
constexpr int dkv_threads() { return NWG == 2 ? 384 : 160; }
template <int NWG>
constexpr int dq_threads() { return NWG * 128 + 32; }   // the forward's too

template <int DP, int NWG>
constexpr int dkv_smem() {   // K, V x NWG; Q, dO x kStages; lse2, delta; barriers; rows, flag
  return 1024 + 2 * (NWG + kStages) * tile_bytes<DP>() + 2 * kStages * kRows * 4 +
         (2 * kStages + 1) * 8 + (kStages + 1) * 4;
}
template <int DP, int NWG>
constexpr int dq_smem() {    // Q, dO x NWG; K, V x kStages; barriers; rows, flag
  return 1024 + 2 * (NWG + kStages) * tile_bytes<DP>() + (2 * kStages + 1) * 8 +
         (kStages + 1) * 4;
}
template <int DP, int NWG>
constexpr int fwd_smem() {   // Q x NWG; K, V x kStages; barriers; rows, flag
  return 1024 + (NWG + 2 * kStages) * tile_bytes<DP>() + (2 * kStages + 1) * 8 +
         (kStages + 1) * 4;
}

using tc::align1024;
using tc::col;
using tc::exp2_;
using tc::row8;
using tc::store2;

// lse * log2(e) of a row, +inf where the row has no allowed key (lse -inf):
// exp2(s - inf) = 0 then gives the row p = 0 without an inf * 0.
__device__ __forceinline__ float lse2_of(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// The producer warp: walk the item's slots of its LUT line, each other-side
// block as block / 64 tiles; skip under causal a tile wholly on the masked
// side of the CTA's rows [own0, own0 + own_rows) (dk/dv: every query before
// every key; dq: every key after every query); stage each kept tile's two
// tensors by TMA (dk/dv: Q and dO, with each row's lse2 and delta by the
// lanes; dq: K and V) and its first row in sPos; then a stage whose row is
// -1 ends the consumers' walk.
template <int DP, bool kDkv>
__device__ __forceinline__ void produce(const CUtensorMap* ma, const CUtensorMap* mb,
                                        uint8_t* sA, uint8_t* sB, float* sL, float* sD,
                                        int* sPos, uint64_t* full, uint64_t* empty,
                                        const Params& P, const Item& it, int bh, int own0,
                                        int own_rows, const float* lse, const float* delta,
                                        int lane) {
  constexpr int kTile = tile_bytes<DP>();
  const int* line = P.lut + static_cast<long long>(it.line) * P.width;
  const int sub = P.block / kRows;
  int i = 0;
  for (int slot = it.first; slot < it.last; ++slot) {
    const int ob = line[slot];
    for (int j = 0; j < sub; ++j) {
      const int r0 = ob * P.block + j * kRows;
      if (P.causal && (kDkv ? r0 + kRows - 1 < own0 : r0 > own0 + own_rows - 1)) continue;
      const int s = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      if constexpr (kDkv) {
        for (int c = lane; c < kRows; c += 32) {
          const long long row = static_cast<long long>(bh) * P.T + r0 + c;
          sL[s * kRows + c] = lse2_of(lse[row]);
          sD[s * kRows + c] = delta[row];
        }
      }
      if (lane == 0) {
        sPos[s] = r0;
        tc::mbar_arrive_expect_tx(&full[s], 2 * kTile);
        for (int a = 0; a < DP / 64; ++a) {
          tc::tma_load(sA + s * kTile + a * kAtom, ma, &full[s], 64 * a, r0, bh);
          tc::tma_load(sB + s * kTile + a * kAtom, mb, &full[s], 64 * a, r0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
      ++i;
    }
  }
  const int s = i % kStages;
  if (i >= kStages) tc::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
  if (lane == 0) sPos[s] = -1;
  tc::mbar_arrive(&full[s]);
}

// dk/dv's P^T and dS^T of one query tile, in place of S^T (unscaled q.k) and
// dP^T. kDiag: the tile lines up with the warpgroup's keys on the causal
// diagonal, and lanes with q < k are dropped.
template <bool kDiag>
__device__ __forceinline__ void dkv_probs(float (&sc)[32], float (&dp)[32], const Params& P,
                                          const float* lse_s, const float* dlt_s, int q0,
                                          int kr0, int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    float p = exp2_(sc[e] * P.scale2 - lse_s[col(e, t)]);
    if (kDiag && q0 + col(e, t) < kr0 + 8 * row8(e)) p = 0.f;
    dp[e] = p * (dp[e] - dlt_s[col(e, t)]);
    sc[e] = p;
  }
}

// dq's dS of one key tile, in place of S (unscaled q.k); kDiag as above.
template <bool kDiag>
__device__ __forceinline__ void dq_grads(float (&sc)[32], const float (&dp)[32],
                                         const Params& P, const float (&lse2)[2],
                                         const float (&dlt)[2], int k0, int r0, int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = row8(e);
    float p = exp2_(sc[e] * P.scale2 - lse2[r]);
    if (kDiag && r0 + 8 * r < k0 + col(e, t)) p = 0.f;
    sc[e] = p * (dp[e] - dlt[r]);
  }
}

// The forward's online softmax over one key tile, in place of S (unscaled
// q.k): the scores times sm_scale * log2(e), lanes the causal mask drops
// (kDiag: the tile lines up with the warpgroup's rows on the diagonal, and
// lanes with q < k are dropped) at -inf; the running max m (log2 units) and
// sum l of the thread's two rows updated and o rescaled; sc becomes p = 2^(s -
// m). A row whose lanes so far are all dropped keeps m = -inf, p = 0 and its
// l and o at 0.
template <bool kDiag, int N>
__device__ __forceinline__ void fwd_probs(float (&sc)[32], float (&m)[2], float (&l)[2],
                                          float (&o)[N], const Params& P, int k0, int r0,
                                          int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    float x = sc[e] * P.scale2;
    if (kDiag && r0 + 8 * row8(e) < k0 + col(e, t)) x = -INFINITY;
    sc[e] = x;
    mx[row8(e)] = fmaxf(mx[row8(e)], x);
  }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], tc::quad_max(mx[r]));
    alpha[r] = m_new == -INFINITY ? 1.f : exp2_(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = row8(e);
    const float p = m[r] == -INFINITY ? 0.f : exp2_(sc[e] - m[r]);
    rs[r] += p;
    sc[e] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + tc::quad_sum(rs[r]);
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] *= alpha[row8(e)];
}

// A split item's part of the sum: N accumulator floats a thread at ws[e *
// stride], the consumer threads of a part side by side (stride = their count).
template <int N>
__device__ __forceinline__ void store_part(const float (&acc)[N], float* ws, int stride) {
#pragma unroll
  for (int e = 0; e < N; ++e) __stcg(ws + e * stride, acc[e]);
}

// acc = the sum of the group's parts' floats at the thread's positions, in
// part order (so the same sums whichever part arrives last).
template <int N>
__device__ __forceinline__ void sum_parts(float (&acc)[N], const float* ws0, long long part_floats,
                                          int parts, int stride) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float* w = ws0 + p * part_floats;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += __ldcg(w + e * stride);
  }
}

// After every consumer thread stored its part: count the CTA's arrival on the
// group's counter; true in the last part to arrive, whose threads may then
// read every part. Named barrier 1 over the n consumer threads.
__device__ __forceinline__ bool arrive_last(const Params& P, const Item& it, int b, int* flag,
                                            int n) {
  __threadfence();
  tc::named_sync(1, n);
  if (threadIdx.x == 0) {
    const int before = atomicAdd(&P.arrivals[b * P.n_groups + it.group], 1);
    *flag = before == it.parts - 1;
  }
  tc::named_sync(1, n);
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------- forward
template <typename T, int DP, int NWG>
__global__ void __launch_bounds__(dq_threads<NWG>(), DP == 64 ? 2 : 1)
bs_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, T* __restrict__ out,
                 float* __restrict__ lse, Params P) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = tile_bytes<DP>();
  constexpr int kConsumers = NWG * 128;
  constexpr int kCtaRows = NWG * kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);               // NWG tiles, resident
  uint8_t* sK = sQ + NWG * kTile;                  // kStages tiles
  uint8_t* sV = sK + kStages * kTile;              // kStages tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  int* sPos = reinterpret_cast<int*>(q_full + 1);  // [kStages] first key
  int* sFlag = sPos + kStages;

  const Item it = P.items[blockIdx.x];
  const int b = blockIdx.y;
  const int h = it.line / P.nb;
  const int bh = b * P.H + h;
  const int q0 = (it.line % P.nb) * P.block + it.tile * kCtaRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 4 * NWG);
    }
    tc::mbar_init(q_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // ------------------------------------- producer
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(q_full, NWG * kTile);
      for (int w = 0; w < NWG; ++w)
        for (int a = 0; a < DP / 64; ++a)
          tc::tma_load(sQ + w * kTile + a * kAtom, &mq, q_full, 64 * a, q0 + kRows * w, bh);
    }
    produce<DP, false>(&mk, &mv, sK, sV, nullptr, nullptr, sPos, full, empty, P, it, bh, q0,
                       kCtaRows, nullptr, nullptr, lane);
    return;
  }

  // ---------------------------------------------------------- consumers
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int q0w = q0 + kRows * wg;
  const int r0 = q0w + 16 * w + g;                         // this thread's rows r0, r0 + 8
  const uint8_t* myQ = sQ + wg * kTile;
  tc::mbar_wait(q_full, 0);

  float o[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0;; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    const int k0 = sPos[s];
    if (k0 < 0) break;
    // a key tile wholly after this warpgroup's queries is all masked
    if (!(P.causal && k0 > q0w + kRows - 1)) {
      const uint8_t* ktile = sK + s * kTile;
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(sc, tc::desc_k(myQ, kk, kAtom), tc::desc_k(ktile, kk, kAtom), kk);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(sc);

      if (P.causal && k0 == q0w)
        fwd_probs<true>(sc, m, l, o, P, k0, r0, t);
      else
        fwd_probs<false>(sc, m, l, o, P, k0, r0, t);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::acc_to_a<kHalf>(sc, kk, pa[kk]);
      const uint8_t* vtile = sV + s * kTile;
      tc::fence_regs(o);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<kHalf>(o, pa[kk], tc::desc_mn(vtile, kk, kAtom), 1);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(o);
    }
    if (lane == 0) tc::mbar_arrive(&empty[s]);
  }

  if (it.group >= 0) {     // a part of a split row: merge in part order
    // a part's slot: acc at [e * kConsumers + thread], then m and l of each
    // of the CTA's rows
    const long long part_floats = static_cast<long long>(kConsumers) * (DP / 2 + 1);
    const float* ws0 = P.ws + (static_cast<long long>(b) * P.ws_parts + it.ws) * part_floats;
    float* mine = P.ws + (static_cast<long long>(b) * P.ws_parts + it.ws + it.part) * part_floats;
    const int row = kRows * wg + 16 * w + g;               // the CTA's row of r0
    store_part(o, mine + wg * 128 + tid, kConsumers);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __stcg(mine + kConsumers * (DP / 2) + row + 8 * r, m[r]);
        __stcg(mine + kConsumers * (DP / 2) + kCtaRows + row + 8 * r, l[r]);
      }
    }
    if (!arrive_last(P, it, b, sFlag, kConsumers)) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    for (int p = 0; p < it.parts; ++p) {
      const float* ml = ws0 + p * part_floats + kConsumers * (DP / 2);
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], __ldcg(ml + row + 8 * r));
    }
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
    for (int p = 0; p < it.parts; ++p) {
      const float* part = ws0 + p * part_floats;
      const float* ml = part + kConsumers * (DP / 2);
      float f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mp = __ldcg(ml + row + 8 * r);
        f[r] = mp == -INFINITY ? 0.f : exp2_(mp - m[r]);
        l[r] += __ldcg(ml + kCtaRows + row + 8 * r) * f[r];
      }
#pragma unroll
      for (int e = 0; e < DP / 2; ++e)
        o[e] += __ldcg(part + e * kConsumers + wg * 128 + tid) * f[row8(e)];
    }
  }

  const long long base = static_cast<long long>(bh) * P.T * P.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    const float li = fmaxf(l[r], 1e-30f);
    T* orow = out + base + static_cast<long long>(qi) * P.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < P.D) store2(orow + c, o[4 * j + 2 * r] / li, o[4 * j + 2 * r + 1] / li);
    }
    if (t == 0) lse[static_cast<long long>(bh) * P.T + qi] = m[r] / kLog2e + logf(li);
  }
}

// ---------------------------------------------------------------- dk, dv
template <typename T, int DP, int NWG>
__global__ void __launch_bounds__(dkv_threads<NWG>(), 1)
bs_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, Params P) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = tile_bytes<DP>();
  constexpr int kConsumers = NWG * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);               // NWG tiles, resident
  uint8_t* sV = sK + NWG * kTile;                  // NWG tiles, resident
  uint8_t* sQ = sV + NWG * kTile;                  // kStages tiles
  uint8_t* sO = sQ + kStages * kTile;              // dO, kStages tiles
  float* sL = reinterpret_cast<float*>(sO + kStages * kTile);   // [kStages][64] lse2
  float* sD = sL + kStages * kRows;                              // [kStages][64] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(sD + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  int* sPos = reinterpret_cast<int*>(kv_full + 1);               // [kStages] first query
  int* sFlag = sPos + kStages;

  const Item it = P.items[blockIdx.x];
  const int b = blockIdx.y;
  const int h = it.line / P.nb;
  const int bh = b * P.H + h;
  const int k0 = (it.line % P.nb) * P.block + it.tile * NWG * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);         // the producer's lanes, and the TMA bytes
      tc::mbar_init(&empty[s], 4 * NWG);   // one arrival per consumer warp
    }
    tc::mbar_init(kv_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // ------------------------------- producer (warp)
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp > 4 * NWG) return;
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(kv_full, 2 * NWG * kTile);
      for (int w = 0; w < NWG; ++w)
        for (int a = 0; a < DP / 64; ++a) {
          tc::tma_load(sK + w * kTile + a * kAtom, &mk, kv_full, 64 * a, k0 + kRows * w, bh);
          tc::tma_load(sV + w * kTile + a * kAtom, &mv, kv_full, 64 * a, k0 + kRows * w, bh);
        }
    }
    produce<DP, true>(&mq, &mdo, sQ, sO, sL, sD, sPos, full, empty, P, it, bh, k0,
                      NWG * kRows, lse, delta, lane);
    return;
  }

  // ---------------------------------------------------------- consumers
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int k0w = k0 + kRows * wg;
  const int kr0 = k0w + 16 * w + g;                    // this thread's keys kr0, kr0 + 8
  const uint8_t* myK = sK + wg * kTile;
  const uint8_t* myV = sV + wg * kTile;
  tc::mbar_wait(kv_full, 0);

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dka[e] = dva[e] = 0.f;

  for (int i = 0;; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    const int q0 = sPos[s];
    if (q0 < 0) break;
    // a query tile wholly before this warpgroup's keys is all masked
    if (!(P.causal && q0 + kRows - 1 < k0w)) {
      const uint8_t* qtile = sQ + s * kTile;
      const uint8_t* otile = sO + s * kTile;
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(sc, tc::desc_k(myK, kk, kAtom), tc::desc_k(qtile, kk, kAtom), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(dp, tc::desc_k(myV, kk, kAtom), tc::desc_k(otile, kk, kAtom), kk);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(sc);
      tc::fence_regs(dp);

      const float* lse_s = sL + s * kRows;
      const float* dlt_s = sD + s * kRows;
      if (P.causal && q0 == k0w)
        dkv_probs<true>(sc, dp, P, lse_s, dlt_s, q0, kr0, t);
      else
        dkv_probs<false>(sc, dp, P, lse_s, dlt_s, q0, kr0, t);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        tc::acc_to_a<kHalf>(sc, kk, pa[kk]);
        tc::acc_to_a<kHalf>(dp, kk, da[kk]);
      }
      tc::fence_regs(dva);
      tc::fence_regs(dka);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<kHalf>(dva, pa[kk], tc::desc_mn(otile, kk, kAtom), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<kHalf>(dka, da[kk], tc::desc_mn(qtile, kk, kAtom), 1);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(dva);
      tc::fence_regs(dka);
    }
    if (lane == 0) tc::mbar_arrive(&empty[s]);
  }

  if (it.group >= 0) {     // a part of a split column: merge in part order
    const long long part_floats = static_cast<long long>(kConsumers) * DP;
    float* ws0 = P.ws + (static_cast<long long>(b) * P.ws_parts + it.ws) * part_floats +
                 wg * 128 + tid;
    store_part(dka, ws0 + it.part * part_floats, kConsumers);
    store_part(dva, ws0 + it.part * part_floats + (DP / 2) * kConsumers, kConsumers);
    if (!arrive_last(P, it, b, sFlag, kConsumers)) return;
    sum_parts(dka, ws0, part_floats, it.parts, kConsumers);
    sum_parts(dva, ws0 + (DP / 2) * kConsumers, part_floats, it.parts, kConsumers);
  }

  const long long base = static_cast<long long>(bh) * P.T * P.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = base + static_cast<long long>(kr0 + 8 * r) * P.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < P.D) {
        store2(dk + at + c, dka[4 * j + 2 * r] * P.sm_scale, dka[4 * j + 2 * r + 1] * P.sm_scale);
        store2(dv + at + c, dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dq
template <typename T, int DP, int NWG>
__global__ void __launch_bounds__(dq_threads<NWG>(), 1)
bs_dq_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Params P) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = tile_bytes<DP>();
  constexpr int kConsumers = NWG * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);               // NWG tiles, resident
  uint8_t* sO = sQ + NWG * kTile;                  // dO, NWG tiles, resident
  uint8_t* sK = sO + NWG * kTile;                  // kStages tiles
  uint8_t* sV = sK + kStages * kTile;              // kStages tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  int* sPos = reinterpret_cast<int*>(q_full + 1);  // [kStages] first key
  int* sFlag = sPos + kStages;

  const Item it = P.items[blockIdx.x];
  const int b = blockIdx.y;
  const int h = it.line / P.nb;
  const int bh = b * P.H + h;
  const int q0 = (it.line % P.nb) * P.block + it.tile * NWG * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 4 * NWG);
    }
    tc::mbar_init(q_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // ------------------------------------- producer
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(q_full, 2 * NWG * kTile);
      for (int w = 0; w < NWG; ++w)
        for (int a = 0; a < DP / 64; ++a) {
          tc::tma_load(sQ + w * kTile + a * kAtom, &mq, q_full, 64 * a, q0 + kRows * w, bh);
          tc::tma_load(sO + w * kTile + a * kAtom, &mdo, q_full, 64 * a, q0 + kRows * w, bh);
        }
    }
    produce<DP, false>(&mk, &mv, sK, sV, nullptr, nullptr, sPos, full, empty, P, it, bh, q0,
                       NWG * kRows, nullptr, nullptr, lane);
    return;
  }

  // ---------------------------------------------------------- consumers
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int q0w = q0 + kRows * wg;
  const int r0 = q0w + 16 * w + g;                         // this thread's rows r0, r0 + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = static_cast<long long>(bh) * P.T + r0 + 8 * r;
    lse2[r] = lse2_of(lse[row]);
    dlt[r] = delta[row];
  }
  const uint8_t* myQ = sQ + wg * kTile;
  const uint8_t* myO = sO + wg * kTile;
  tc::mbar_wait(q_full, 0);

  float dqa[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dqa[e] = 0.f;

  for (int i = 0;; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    const int k0 = sPos[s];
    if (k0 < 0) break;
    // a key tile wholly after this warpgroup's queries is all masked
    if (!(P.causal && k0 > q0w + kRows - 1)) {
      const uint8_t* ktile = sK + s * kTile;
      const uint8_t* vtile = sV + s * kTile;
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(sc, tc::desc_k(myQ, kk, kAtom), tc::desc_k(ktile, kk, kAtom), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(dp, tc::desc_k(myO, kk, kAtom), tc::desc_k(vtile, kk, kAtom), kk);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(sc);
      tc::fence_regs(dp);

      if (P.causal && k0 == q0w)
        dq_grads<true>(sc, dp, P, lse2, dlt, k0, r0, t);
      else
        dq_grads<false>(sc, dp, P, lse2, dlt, k0, r0, t);
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::acc_to_a<kHalf>(sc, kk, da[kk]);
      tc::fence_regs(dqa);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<kHalf>(dqa, da[kk], tc::desc_mn(ktile, kk, kAtom), 1);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(dqa);
    }
    if (lane == 0) tc::mbar_arrive(&empty[s]);
  }

  if (it.group >= 0) {     // a part of a split row: merge in part order
    const long long part_floats = static_cast<long long>(kConsumers) * (DP / 2);
    float* ws0 = P.ws + (static_cast<long long>(b) * P.ws_parts + it.ws) * part_floats +
                 wg * 128 + tid;
    store_part(dqa, ws0 + it.part * part_floats, kConsumers);
    if (!arrive_last(P, it, b, sFlag, kConsumers)) return;
    sum_parts(dqa, ws0, part_floats, it.parts, kConsumers);
  }

  const long long base = static_cast<long long>(bh) * P.T * P.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = dq + base + static_cast<long long>(r0 + 8 * r) * P.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < P.D)
        store2(row + c, dqa[4 * j + 2 * r] * P.sm_scale, dqa[4 * j + 2 * r + 1] * P.sm_scale);
    }
  }
}

// ---------------------------------------------------------------- launch
enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

// o1, o2: the forward's out and lse, dq's dq, or dk/dv's dk and dv
template <int kPass, typename T, int DP, int NWG>
cudaError_t launch(int B, int n_items, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta, void* o1, void* o2,
                   const Params& P, cudaStream_t st) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  const int BH = B * P.H;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = tc::make_map(&mq, q, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess ||
      (err = tc::make_map(&mk, k, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess ||
      (err = tc::make_map(&mv, v, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess ||
      (kPass != kFwd &&
       (err = tc::make_map(&mdo, dout, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess)) {
    return err;
  }
  const dim3 grid(n_items, B);
  if constexpr (kPass == kFwd) {
    constexpr int smem = fwd_smem<DP, NWG>();
    auto kernel = bs_fwd_tc_kernel<T, DP, NWG>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    constexpr int threads = dq_threads<NWG>();
    kernel<<<grid, threads, smem, st>>>(mq, mk, mv, static_cast<T*>(o1), static_cast<float*>(o2),
                                        P);
  } else if constexpr (kPass == kDq) {
    constexpr int smem = dq_smem<DP, NWG>();
    auto kernel = bs_dq_tc_kernel<T, DP, NWG>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    constexpr int threads = dq_threads<NWG>();
    kernel<<<grid, threads, smem, st>>>(mq, mk, mv, mdo, lse, delta, static_cast<T*>(o1), P);
  } else {
    constexpr int smem = dkv_smem<DP, NWG>();
    auto kernel = bs_dkv_tc_kernel<T, DP, NWG>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    constexpr int threads = dkv_threads<NWG>();
    kernel<<<grid, threads, smem, st>>>(mq, mk, mv, mdo, lse, delta, static_cast<T*>(o1),
                                        static_cast<T*>(o2), P);
  }
  return cudaGetLastError();
}

// DP 64 or 128 by D; two warpgroups where rows is 128 (never dk/dv at DP 128)
template <int kPass, typename T>
cudaError_t dispatch(int rows, int B, int n_items, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta, void* o1, void* o2,
                     const Params& P, cudaStream_t st) {
  if (P.D <= 64) {
    return rows == 128
               ? launch<kPass, T, 64, 2>(B, n_items, q, k, v, dout, lse, delta, o1, o2, P, st)
               : launch<kPass, T, 64, 1>(B, n_items, q, k, v, dout, lse, delta, o1, o2, P, st);
  }
  if constexpr (kPass != kDkv) {
    if (rows == 128)
      return launch<kPass, T, 128, 2>(B, n_items, q, k, v, dout, lse, delta, o1, o2, P, st);
  }
  return launch<kPass, T, 128, 1>(B, n_items, q, k, v, dout, lse, delta, o1, o2, P, st);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kPass>
int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, const int* lut, int width, const void* items, int n_items,
        float* ws, int ws_parts, int* arrivals, int n_groups, int rows, void* o1, void* o2,
        int B, int H, int T, int D, int block, float sm_scale, int causal, int dtype,
        void* stream) {
  // rows: the CTA's rows, 64 or 128 (two warpgroups: a block that is a
  // multiple of 128, and for dk/dv D <= 64)
  const bool rows_ok = rows == 64 || (rows == 128 && block % 128 == 0 &&
                                      (kPass != kDkv || D <= 64));
  if (B < 1 || B > 65535 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || block < 64 ||
      block % 64 != 0 || T < block || T % block != 0 || width < 1 || n_items < 1 ||
      !rows_ok || (dtype != 1 && dtype != 2) || (n_groups > 0 && (!ws || !arrivals)) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      (kPass != kFwd && !aligned16(dout))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{H, T, D, block, T / block, sm_scale, sm_scale * kLog2e, causal, lut, width,
           static_cast<const Item*>(items), ws, ws_parts, arrivals, n_groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch<kPass, __nv_bfloat16>(rows, B, n_items, q, k, v, dout, lse, delta,
                                                  o1, o2, P, st)
                 : dispatch<kPass, __half>(rows, B, n_items, q, k, v, dout, lse, delta, o1, o2,
                                           P, st);
  return static_cast<int>(err);
}

}  // namespace

// q, k, v (, dout): [B*H, T, D] contiguous of one type (dtype 1 bfloat16, 2
// float16), 16-byte aligned, D <= 128 a multiple of 8; lse, delta: float32
// [B*H, T]; lut: int32 [H * nb, width] (nb = T / block, block a multiple of
// 64), the forward's cols for the forward and dq, the transposed rows_t for
// dk/dv; items: int32 [n_items, 8] from build_work at the same rows (the
// CTA's, 64 or 128); ws: float32 [B, ws_parts, F] with F = rows * (DP + 2)
// for the forward, rows * DP for dq and 2 * rows * DP for dk/dv (DP = 64 or
// 128, D padded), and arrivals: int32 [B, n_groups], zeroed, where n_groups >
// 0, else null. The grid is (n_items, B). Each returns the launch's
// cudaError; anything else returns cudaErrorInvalidValue.

// out: as q; lse: float32 [B*H, T], natural log.
extern "C" int bs_fwd_tc(const void* q, const void* k, const void* v, const int* cols,
                         int width, const void* items, int n_items, float* ws, int ws_parts,
                         int* arrivals, int n_groups, int rows, void* out, float* lse, int B,
                         int H, int T, int D, int block, float sm_scale, int causal, int dtype,
                         void* stream) {
  return run<kFwd>(q, k, v, nullptr, nullptr, nullptr, cols, width, items, n_items, ws,
                   ws_parts, arrivals, n_groups, rows, out, lse, B, H, T, D, block, sm_scale,
                   causal, dtype, stream);
}

extern "C" int bs_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const int* cols, int width,
                        const void* items, int n_items, float* ws, int ws_parts, int* arrivals,
                        int n_groups, int rows, void* dq, int B, int H, int T, int D, int block,
                        float sm_scale, int causal, int dtype, void* stream) {
  return run<kDq>(q, k, v, dout, lse, delta, cols, width, items, n_items, ws, ws_parts,
                  arrivals, n_groups, rows, dq, nullptr, B, H, T, D, block, sm_scale, causal,
                  dtype, stream);
}

// dk, dv: as k.
extern "C" int bs_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const int* rows_t, int width_t,
                         const void* items, int n_items, float* ws, int ws_parts, int* arrivals,
                         int n_groups, int rows, void* dk, void* dv, int B, int H, int T, int D,
                         int block, float sm_scale, int causal, int dtype, void* stream) {
  return run<kDkv>(q, k, v, dout, lse, delta, rows_t, width_t, items, n_items, ws, ws_parts,
                   arrivals, n_groups, rows, dk, dv, B, H, T, D, block, sm_scale, causal, dtype,
                   stream);
}
