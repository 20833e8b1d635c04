// Flash attention for Hopper (sm_90a): forward, dq and dk/dv, bound through
// ctypes.
//
// Replaces the three kernel bodies of deepspeed_tpu/ops/pallas/flash_attention.py:
//   flash_fwd     <- _fwd_kernel      (launched by _flash_fwd)
//   flash_bwd_dq  <- _bwd_dq_kernel   (launched by _flash_bwd)
//   flash_bwd_dkv <- _bwd_dkv_kernel  (launched by _flash_bwd)
// Each computes what its TPU body computes, not its blocking: q, k, v
// [B*H, T, D] row-major, one T for q and k; the softmax runs in base 2 with
// sm_scale * log2(e) folded into q (into k in the dk/dv pass) and the scaled
// operand rounded back to its type; f32 online softmax (m, l, acc) with l
// floored at 1e-30; the natural-log lse [B*H, T]; causal tiles above the
// diagonal skipped and the diagonal tile masked with -0.7 * FLT_MAX; an
// optional additive key bias [B, T] added as bias * log2(e); optional dropout
// by the coordinate hash of _dropout_bits over (seed, b*H + h, global q,
// global k), keeping bits >= threshold, scaled by 1 / (1 - rate), with the
// normalizer l taken over the undropped probabilities. The probabilities and
// dS are rounded to the operand type before their products, as the TPU
// kernels cast them before their dots.
//
// Bound: operations. At GPT-2 1.5B's shape (B 4, H 25, T 1024, D 64, causal)
// a forward does 2 * B*H*T^2*D / 2 * 2 = 13.4 GFLOP on 52 MB of inputs and
// outputs, 258 flops per byte, at the card's ridge; the backward passes do
// 3 and 4 such products on about twice the bytes.
//
// Two designs; the wrapper picks one by shape (ops/flash_attention.py,
// _tensor_core_path), never by a failure:
// - tensor cores (flash_fwd_tc, flash_bwd_dq_tc, flash_bwd_dkv_tc): bf16/fp16
//   with D <= 128 a multiple of 8 — every model of the repository. Described
//   at the tensor-core section below.
// - CUDA cores (flash_fwd, flash_bwd_dq, flash_bwd_dkv): every dtype and even
//   D <= 256; float32 and the other head dims take it.
//
// CUDA-core design (the simple one): float tiles in shared memory and f32 FMA
// on the CUDA cores. A CTA of 256 threads owns a tile of BM
// rows (64, or 32 at D > 128) and walks the other side's tiles of BM rows
// staged in shared memory (rows padded to D + 1 floats, so column walks hit
// distinct banks). Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i
// and columns tx + 16 j of each score tile; a row's max and sum reduce over
// the 16 lanes of a half warp with shuffles. The probability (or dS) tile
// goes through shared memory to its product with V (K, dO, Q). The head dim
// is padded to DP (64, 128 or 256) with zeros. T need not be a multiple of
// the tile: rows and columns past T are masked or dropped. Tiles are visited
// heaviest first under causal masking (the grid's x index runs backwards).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "tc_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE

// _dropout_bits: lowbias32-style avalanche of the absolute coordinate
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t bh,
                                                 int qg, int kg) {
  uint32_t x = static_cast<uint32_t>(qg) * 0x9E3779B1u +
               static_cast<uint32_t>(kg) * 0x85EBCA77u + bh * 0xC2B2AE3Du + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Params {
  int H, T, D;
  float sm_scale;    // softmax scale
  float op_scale;    // sm_scale * log2(e), folded into q (fwd, dq) or k (dkv)
  int causal;
  const float* bias;  // [B, T] or null
  float rate;         // dropout rate, 0 for none
  uint32_t threshold;
  uint32_t seed;
  int q_off, k_off;   // global coordinates of local position 0
  // the second segment of each side (the sequence-parallel ring's zigzag
  // layout, the TPU kernels' segmented (7,) seed operand): local positions
  // from *_half on start at global *_off1; a contiguous side has its half
  // past every position
  int q_half, q_off1, k_half, k_off1;
};

// The one map from a local position to its global coordinate, for the causal
// mask and the dropout hash alike (the TPU kernels' _read_seed_ref). The
// boundary may fall inside a tile, so it is taken per element. Causal tile
// pruning (the CUDA-core kernels' last and masked_tile, the tensor-core
// kernels' n_tiles, n_mine, first and diag) stays in local coordinates: that
// is exact because a causal call's q and k maps are identical and keep the
// local order (the wrapper refuses any other), so local order is global
// order, as for the TPU kernels' bounds (flash_attention.py:165-167).
__device__ __forceinline__ int seg_map(int p, int off0, int half, int off1) {
  return p < half ? p + off0 : p - half + off1;
}
__device__ __forceinline__ int gq(const Params& P, int p) {
  return seg_map(p, P.q_off, P.q_half, P.q_off1);
}
__device__ __forceinline__ int gk(const Params& P, int p) {
  return seg_map(p, P.k_off, P.k_half, P.k_off1);
}

template <int DP, int BM>
constexpr int fwd_smem_floats() { return 3 * BM * (DP + 1) + BM * (BM + 1) + BM; }
template <int DP, int BM>
constexpr int bwd_smem_floats() { return 4 * BM * (DP + 1) + BM * (BM + 1) + 3 * BM; }

// ---------------------------------------------------------------- forward
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Params P) {
  constexpr int R = BM / 16;   // rows (and columns) per thread
  constexpr int CD = DP / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * (DP + 1);
  float* sV = sK + BM * (DP + 1);
  float* sP = sV + BM * (DP + 1);
  float* sB = sP + BM * (BM + 1);

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BM;
  const int D = P.D;
  const long long base = static_cast<long long>(bh) * P.T * D;
  const float* bias_row = P.bias ? P.bias + static_cast<long long>(bh / P.H) * P.T : nullptr;
  const float inv_keep = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;

  load_tile<T, DP, BM>(sQ, q + base, q0, P.T, D, P.op_scale, true);

  float m[R], l[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (P.T + BM - 1) / BM;
  const int last = P.causal ? min(n_kt, qt + 1) : n_kt;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();
    load_tile<T, DP, BM>(sK, k + base, k0, P.T, D, 1.f, false);
    load_tile<T, DP, BM>(sV, v + base, k0, P.T, D, 1.f, false);
    if (bias_row) {
      for (int c = threadIdx.x; c < BM; c += kThreads)
        sB[c] = k0 + c < P.T ? bias_row[k0 + c] * kLog2e : 0.f;
    }
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) {
      float qa[R], kb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qa[i] = sQ[(ty + 16 * i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < R; ++j) kb[j] = sK[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] += qa[i] * kb[j];
    }

    const bool masked_tile = P.causal && k0 + BM - 1 > q0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j];
        if (kj >= P.T) {
          x = -INFINITY;
        } else {
          if (bias_row) x += sB[tx + 16 * j];
          if (masked_tile && gq(P, qi) < gk(P, kj)) x = kMaskValue;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = m_new == -INFINITY ? 0.f : exp2f(s[i][j] - m_new);
        rs += p;
        if (P.rate > 0.f) {
          const uint32_t bits =
              dropout_bits(P.seed, bh, gq(P, qi), gk(P, kj));
          p = bits >= P.threshold ? p * inv_keep : 0.f;
        }
        sP[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BM; ++c) {
      float vb[CD];
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) vb[cd] = sV[c * (DP + 1) + tx + 16 * cd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sP[(ty + 16 * i) * (BM + 1) + c];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) acc[i][cd] += p * vb[cd];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= P.T) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) out[base + static_cast<long long>(qi) * D + d] = from_f<T>(acc[i][cd] / li);
    }
    if (tx == 0) lse[static_cast<long long>(bh) * P.T + qi] = m[i] / kLog2e + logf(li);
  }
}

// ---------------------------------------------------------------- dq
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Params P) {
  constexpr int R = BM / 16;
  constexpr int CD = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BM * (DP + 1);
  float* sK = sDO + BM * (DP + 1);
  float* sV = sK + BM * (DP + 1);
  float* sS = sV + BM * (DP + 1);
  float* sB = sS + BM * (BM + 1);

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BM;
  const int D = P.D;
  const long long base = static_cast<long long>(bh) * P.T * D;
  const float* bias_row = P.bias ? P.bias + static_cast<long long>(bh / P.H) * P.T : nullptr;
  const float inv_keep = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;

  load_tile<T, DP, BM>(sQ, q + base, q0, P.T, D, P.op_scale, true);
  load_tile<T, DP, BM>(sDO, dout + base, q0, P.T, D, 1.f, false);
  float lse2[R], dlt[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    const long long row = static_cast<long long>(bh) * P.T + qi;
    lse2[i] = qi < P.T ? lse[row] * kLog2e : 0.f;
    dlt[i] = qi < P.T ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (P.T + BM - 1) / BM;
  const int last = P.causal ? min(n_kt, qt + 1) : n_kt;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BM;
    __syncthreads();
    load_tile<T, DP, BM>(sK, k + base, k0, P.T, D, 1.f, false);
    load_tile<T, DP, BM>(sV, v + base, k0, P.T, D, 1.f, false);
    if (bias_row) {
      for (int c = threadIdx.x; c < BM; c += kThreads)
        sB[c] = k0 + c < P.T ? bias_row[k0 + c] * kLog2e : 0.f;
    }
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qa[R], da[R], kb[R], vb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qa[i] = sQ[(ty + 16 * i) * (DP + 1) + d];
        da[i] = sDO[(ty + 16 * i) * (DP + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kb[j] = sK[(tx + 16 * j) * (DP + 1) + d];
        vb[j] = sV[(tx + 16 * j) * (DP + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] += qa[i] * kb[j];
          dp[i][j] += da[i] * vb[j];
        }
    }

    const bool masked_tile = P.causal && k0 + BM - 1 > q0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kj < P.T) {
          float x = s[i][j];
          if (bias_row) x += sB[tx + 16 * j];
          if (masked_tile && gq(P, qi) < gk(P, kj)) x = kMaskValue;
          const float p = exp2f(x - lse2[i]);
          float g = dp[i][j];
          if (P.rate > 0.f) {
            const uint32_t bits =
                dropout_bits(P.seed, bh, gq(P, qi), gk(P, kj));
            g = bits >= P.threshold ? g * inv_keep : 0.f;
          }
          ds = p * (g - dlt[i]);
        }
        sS[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BM; ++c) {
      float kb[CD];
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) kb[cd] = sK[c * (DP + 1) + tx + 16 * cd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float g = sS[(ty + 16 * i) * (BM + 1) + c];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) acc[i][cd] += g * kb[cd];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= P.T) continue;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) dq[base + static_cast<long long>(qi) * D + d] = from_f<T>(acc[i][cd] * P.sm_scale);
    }
  }
}

// ---------------------------------------------------------------- dk, dv
// Transposed roles: a CTA owns BM keys (rows ty + 16 i) and walks the query
// tiles (columns tx + 16 j), so each score it forms is s^T[k][q].
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, Params P) {
  constexpr int R = BM / 16;
  constexpr int CD = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BM * (DP + 1);
  float* sQ = sV + BM * (DP + 1);
  float* sDO = sQ + BM * (DP + 1);
  float* sS = sDO + BM * (DP + 1);
  float* sL = sS + BM * (BM + 1);   // lse * log2(e) of the query tile
  float* sD = sL + BM;              // delta of the query tile

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_t = (P.T + BM - 1) / BM;
  // causal: the last key tiles have the fewest query tiles, so run them last
  const int kt = P.causal ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int k0 = kt * BM;
  const int D = P.D;
  const long long base = static_cast<long long>(bh) * P.T * D;
  const float* bias_row = P.bias ? P.bias + static_cast<long long>(bh / P.H) * P.T : nullptr;
  const float inv_keep = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;

  load_tile<T, DP, BM>(sK, k + base, k0, P.T, D, P.op_scale, true);
  load_tile<T, DP, BM>(sV, v + base, k0, P.T, D, 1.f, false);
  float bk[R], dka[R][CD], dva[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    bk[i] = bias_row && kj < P.T ? bias_row[kj] * kLog2e : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[i][c] = dva[i][c] = 0.f;
  }

  for (int qt = P.causal ? kt : 0; qt < n_t; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_tile<T, DP, BM>(sQ, q + base, q0, P.T, D, 1.f, false);
    load_tile<T, DP, BM>(sDO, dout + base, q0, P.T, D, 1.f, false);
    for (int c = threadIdx.x; c < BM; c += kThreads) {
      const long long row = static_cast<long long>(bh) * P.T + q0 + c;
      sL[c] = q0 + c < P.T ? lse[row] * kLog2e : 0.f;
      sD[c] = q0 + c < P.T ? delta[row] : 0.f;
    }
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float ka[R], va[R], qb[R], db[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ka[i] = sK[(ty + 16 * i) * (DP + 1) + d];
        va[i] = sV[(ty + 16 * i) * (DP + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        qb[j] = sQ[(tx + 16 * j) * (DP + 1) + d];
        db[j] = sDO[(tx + 16 * j) * (DP + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] += ka[i] * qb[j];
          dp[i][j] += va[i] * db[j];
        }
    }

    // query tiles whose first row is past this tile's last key need no mask
    const bool masked_tile = P.causal && q0 < k0 + BM - 1;
    float ds[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qi = q0 + tx + 16 * j;
        float pd = 0.f, g = 0.f;
        if (qi < P.T) {
          float x = s[i][j] + bk[i];
          if (masked_tile && gq(P, qi) < gk(P, kj)) x = kMaskValue;
          const float p = exp2f(x - sL[tx + 16 * j]);
          float keep = 1.f;
          if (P.rate > 0.f) {
            const uint32_t bits =
                dropout_bits(P.seed, bh, gq(P, qi), gk(P, kj));
            keep = bits >= P.threshold ? inv_keep : 0.f;
          }
          pd = p * keep;
          g = p * (dp[i][j] * keep - sD[tx + 16 * j]);
        }
        sS[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = round_to<T>(pd);
        ds[i][j] = g;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BM; ++c) {
      float ob[CD];
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) ob[cd] = sDO[c * (DP + 1) + tx + 16 * cd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sS[(ty + 16 * i) * (BM + 1) + c];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) dva[i][cd] += p * ob[cd];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        sS[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BM; ++c) {
      float qb[CD];
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) qb[cd] = sQ[c * (DP + 1) + tx + 16 * cd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float g = sS[(ty + 16 * i) * (BM + 1) + c];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) dka[i][cd] += g * qb[cd];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= P.T) continue;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) {
        const long long at = base + static_cast<long long>(kj) * D + d;
        dk[at] = from_f<T>(dka[i][cd] * P.sm_scale);
        dv[at] = from_f<T>(dva[i][cd]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch
enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DP, int BM>
cudaError_t launch(int pass, int BH, const void* q, const void* k, const void* v,
                   const void* dout, float* lse, const float* delta, void* o1,
                   void* o2, const Params& P, cudaStream_t st) {
  const dim3 grid((P.T + BM - 1) / BM, BH);
  const dim3 block(kThreads);
  const size_t smem = sizeof(float) * (pass == kFwd ? fwd_smem_floats<DP, BM>()
                                                    : bwd_smem_floats<DP, BM>());
  cudaError_t err = cudaSuccess;
  if (pass == kFwd) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<T, DP, BM><<<grid, block, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o1), lse, P);
  } else if (pass == kDq) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, DP, BM><<<grid, block, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(o1), P);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, DP, BM><<<grid, block, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(o1),
        static_cast<T*>(o2), P);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int pass, int BH, const void* q, const void* k,
                         const void* v, const void* dout, float* lse,
                         const float* delta, void* o1, void* o2, const Params& P,
                         cudaStream_t st) {
  if (P.D <= 64) return launch<T, 64, 64>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  if (P.D <= 128) return launch<T, 128, 64>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  return launch<T, 256, 32>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
}

int run(int pass, const void* q, const void* k, const void* v, const void* dout,
        float* lse, const float* delta, const float* bias, void* o1, void* o2,
        int BH, int H, int T, int D, float sm_scale, float op_scale, int causal,
        float rate, unsigned threshold, unsigned seed, int q_off, int k_off,
        int q_half, int q_off1, int k_half, int k_off1, int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || T < 1 || D < 2 || D > 256 || D % 2 != 0 ||
      BH > 65535 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{H,     T,    D,     sm_scale, op_scale, causal, bias,   rate,
           threshold, seed, q_off, k_off,    q_half,   q_off1, k_half, k_off1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dim<float>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  } else if (dtype == 1) {
    err = dispatch_dim<__nv_bfloat16>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  } else {
    err = dispatch_dim<__half>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  }
  return static_cast<int>(err);
}

// ============================================================================
// Tensor-core design (flash_fwd_tc, flash_bwd_dq_tc, flash_bwd_dkv_tc):
// bf16/fp16, D <= 128 a
// multiple of 8, padded to DP = 64 or 128 by TMA's zero fill. Same function as
// the CUDA-core kernels above, element for element: the masks, bias, dropout
// hash and roundings sit at the same points.
//
// Forward (replaces _fwd_kernel): a CTA owns 128 query rows, two consumer
// warpgroups of 64 (the wgmma M) and one producer warp. The producer puts Q
// once, then 64-key K and V tiles, through a ring of kStages shared-memory
// stages by TMA from 3-D tensor maps [B*H, T, D] (128-byte swizzle; a box
// never crosses into the next head, the ragged tail arrives as zeros), each
// stage with a full and an empty mbarrier; its lanes also stage the tile's
// key bias. Each warpgroup scales its Q tile in place by op_scale (rounded
// to the type, then fence.proxy.async), then per key tile: S = Q K^T by
// wgmma.m64n64k16 from shared memory into f32 registers; the online softmax
// on the accumulator fragments (a row lives in the 4 threads of a quad:
// shuffles; the causal mask, bias and dropout per element at its global
// (q, k)); P packed to 16-bit pairs in registers as the A operand of
// O += P V (wgmma.m64nDPk16, V from shared memory MN-major, transposed). No
// shared-memory round trip for P. Heaviest tiles first under causal.
//
// dk/dv (replaces _bwd_dkv_kernel): a CTA owns 64 keys per consumer
// warpgroup (two at DP = 64, one at DP = 128) with K (scaled by op_scale,
// rounded) and V resident in shared memory; the producer streams 64-row Q
// and dO tiles and their lse * log2(e) and delta through the ring. Per q
// tile: S^T = K Q^T and dP^T = V dO^T by wgmma into registers; P^T =
// exp2(S^T - lse2), masked on diagonal tiles; the keep bits by the same
// hash; dV += (P^T keep) dO and dK += dS^T Q, dS^T = P^T (dP^T keep -
// delta), each with its 16-bit A operand in registers and B (dO, Q) from
// shared memory, transposed. Registers: at DP = 64 a 384-thread CTA (its
// third warpgroup the producer) gives each thread 168, too few for dK, dV,
// S^T and dP^T (ptxas spilled); setmaxnreg moves the producer's to the
// consumers (24 + 2 x 240). At DP = 128 one consumer warpgroup and a
// producer warp, 160 threads, may use 255 a thread (ptxas: 240).
//
// dq (replaces _bwd_dq_kernel): the forward's CTA (128 query rows in two
// consumer warpgroups, one producer warp) with Q (scaled, rounded) and dO
// resident, loaded once by TMA, and each row's lse * log2(e) and delta in
// registers; the producer streams 64-key K and V tiles and the key bias
// through the ring. Per key tile: S = Q K^T and dP = dO V^T by wgmma from
// shared memory; dS = P (dP keep - delta), P = exp2(S - lse2), masked on the
// diagonal tile, on the fragments; dS packed into the A registers of
// dQ += dS K, K read a second time from the same shared-memory tile as an
// MN-major B operand. One CTA owns its rows: no atomics, dq stored once,
// deterministic. Registers at DP = 128: dQ 64, S 32, dP 32, dS as A 16.
//
// Bound at GPT-2 1.5B's shape: operations (the tensor cores' 989 TFLOP/s),
// as above. On the card the elementwise softmax work per score, not the
// tensor cores, bounds the forward and dk/dv (a build without it ran several
// times faster), so the tiles inside the diagonal and the keys are compiled
// without per-element tests, and exp2 is the SFU's ex2.approx. Left for a
// later change: overlapping one tile's softmax with the next tile's wgmma
// (two score buffers, or ping-pong between the warpgroups), a TMA store
// epilogue, persistent CTAs.
namespace tcfa {

constexpr int kRows = 64;             // wgmma M: a warpgroup's rows; the streamed tile
constexpr int kStages = 2;            // ring depth
constexpr int kAtom = kRows * 128;    // bytes of one [64 rows, 64 columns] 16-bit atom

template <int DP>
__host__ __device__ constexpr int tile_bytes() { return kRows * DP * 2; }

// dk/dv's threads: two consumer warpgroups and a producer warpgroup that
// hands its registers to them (setmaxnreg: 24 + 2 x 240 = 3 x 168), or one
// consumer warpgroup and a producer warp (160 threads may use 255 registers)
template <int NWG>
__host__ __device__ constexpr int dkv_threads() { return NWG == 2 ? 384 : 160; }

template <int DP>
constexpr int fwd_smem() {            // Q x 2, K and V x kStages, bias, 5 barriers
  return 1024 + (2 + 2 * kStages) * tile_bytes<DP>() + kStages * kRows * 4 +
         (2 * kStages + 1) * 8;
}
template <int DP, int NWG>
constexpr int dkv_smem() {            // K and V x NWG, Q and dO x kStages, lse and delta
  return 1024 + 2 * (NWG + kStages) * tile_bytes<DP>() + 2 * kStages * kRows * 4 +
         (2 * kStages + 1) * 8;
}
template <int DP>
constexpr int dq_smem() { return fwd_smem<DP>() + 2 * tile_bytes<DP>(); }   // and dO x 2

using tc::align1024;
using tc::col;
using tc::exp2_;
using tc::quad_max;
using tc::quad_sum;
using tc::row8;
using tc::store2;

// x * scale rounded back to T over a tile, 16 bytes a thread at a time
// (elementwise, so the swizzle does not matter)
template <typename T>
__device__ __forceinline__ void scale_tile(uint8_t* tile, int bytes, float scale, int tid) {
  for (int i = tid * 16; i < bytes; i += 128 * 16) {
    uint4 v = *reinterpret_cast<uint4*>(tile + i);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = from_f<T>(to_f(e[j]) * scale);
    *reinterpret_cast<uint4*>(tile + i) = v;
  }
}

// The forward's scores of one key tile, in place: bias added, masked, and
// each of the thread's two rows' maximum. kEdge: the tile is the causal
// diagonal's (diag) or reaches past the last key, and its elements are
// tested; the other tiles skip the tests.
template <bool kEdge>
__device__ __forceinline__ void fwd_scores(float (&sc)[32], float (&mx)[2], const Params& P,
                                           const float* bias_s, int k0, int r0, int t,
                                           bool diag) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int kj = k0 + col(e, t);
    float x = sc[e];
    if (kEdge && kj >= P.T) {
      x = -INFINITY;
    } else {
      if (P.bias) x += bias_s[col(e, t)];
      if (kEdge && diag && gq(P, r0 + 8 * row8(e)) < gk(P, kj)) x = kMaskValue;
    }
    sc[e] = x;
    mx[row8(e)] = fmaxf(mx[row8(e)], x);
  }
}

// dk/dv's P^T (dropped, scaled) and dS^T of one query tile, in place of S^T
// and dP^T; kEdge as above (the diagonal's tile, or queries past T).
template <bool kEdge>
__device__ __forceinline__ void dkv_probs(float (&sc)[32], float (&dp)[32], const Params& P,
                                          const float* lse_s, const float* dlt_s,
                                          const float (&bk)[2], int q0, int kr0, int t,
                                          bool diag, uint32_t bh, float inv_keep) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int qi = q0 + col(e, t);
    const int kj = kr0 + 8 * row8(e);
    float pd = 0.f, gd = 0.f;
    if (!kEdge || qi < P.T) {
      float x = sc[e] + bk[row8(e)];
      if (kEdge && diag && gq(P, qi) < gk(P, kj)) x = kMaskValue;
      const float p = exp2_(x - lse_s[col(e, t)]);
      float keep = 1.f;
      if (P.rate > 0.f) {
        const uint32_t bits = dropout_bits(P.seed, bh, gq(P, qi), gk(P, kj));
        keep = bits >= P.threshold ? inv_keep : 0.f;
      }
      pd = p * keep;
      gd = p * (dp[e] * keep - dlt_s[col(e, t)]);
    }
    sc[e] = pd;
    dp[e] = gd;
  }
}

// dq's dS of one key tile, in place of S; kEdge as in the forward (the
// diagonal's tile, or keys past T, whose dS is 0).
template <bool kEdge>
__device__ __forceinline__ void dq_grads(float (&sc)[32], const float (&dp)[32], const Params& P,
                                         const float* bias_s, const float (&lse2)[2],
                                         const float (&dlt)[2], int k0, int r0, int t,
                                         bool diag, uint32_t bh, float inv_keep) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int kj = k0 + col(e, t);
    const int r = row8(e);
    float ds = 0.f;
    if (!kEdge || kj < P.T) {
      float x = sc[e];
      if (P.bias) x += bias_s[col(e, t)];
      if (kEdge && diag && gq(P, r0 + 8 * r) < gk(P, kj)) x = kMaskValue;
      const float p = exp2_(x - lse2[r]);
      float g = dp[e];
      if (P.rate > 0.f) {
        const uint32_t bits = dropout_bits(P.seed, bh, gq(P, r0 + 8 * r), gk(P, kj));
        g = bits >= P.threshold ? g * inv_keep : 0.f;
      }
      ds = p * (g - dlt[r]);
    }
    sc[e] = ds;
  }
}

// The producer warp of the forward and dq: the resident tiles of the CTA's
// n_wg warpgroups once (Q, and dO when mdo is given) on q_full, then each key
// tile's K and V by TMA and its key bias by the lanes through the ring.
template <int DP>
__device__ __forceinline__ void produce_rows_and_keys(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk, const CUtensorMap* mv,
    uint8_t* sQ, uint8_t* sO, uint8_t* sK, uint8_t* sV, float* sBias, uint64_t* full,
    uint64_t* empty, uint64_t* q_full, const Params& P, int bh, int q0, int n_wg, int n_tiles,
    int lane) {
  constexpr int kTile = tile_bytes<DP>();
  const float* bias_row = P.bias ? P.bias + static_cast<long long>(bh / P.H) * P.T : nullptr;
  if (lane == 0) {
    tc::mbar_arrive_expect_tx(q_full, (mdo ? 2 : 1) * n_wg * kTile);
    for (int w = 0; w < n_wg; ++w)
      for (int a = 0; a < DP / 64; ++a) {
        tc::tma_load(sQ + w * kTile + a * kAtom, mq, q_full, 64 * a, q0 + kRows * w, bh);
        if (mdo) tc::tma_load(sO + w * kTile + a * kAtom, mdo, q_full, 64 * a, q0 + kRows * w, bh);
      }
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    if (i >= kStages) tc::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
    const int k0 = i * kRows;
    if (bias_row) {
      for (int c = lane; c < kRows; c += 32)
        sBias[s * kRows + c] = k0 + c < P.T ? bias_row[k0 + c] * kLog2e : 0.f;
    }
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(&full[s], 2 * kTile);
      for (int a = 0; a < DP / 64; ++a) {
        tc::tma_load(sK + s * kTile + a * kAtom, mk, &full[s], 64 * a, k0, bh);
        tc::tma_load(sV + s * kTile + a * kAtom, mv, &full[s], 64 * a, k0, bh);
      }
    } else {
      tc::mbar_arrive(&full[s]);
    }
  }
}

// ---------------------------------------------------------------- forward
template <typename T, int DP>
__global__ void __launch_bounds__(288, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, T* __restrict__ out,
                    float* __restrict__ lse, Params P) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = tile_bytes<DP>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);               // one tile per consumer warpgroup
  uint8_t* sK = sQ + 2 * kTile;                    // kStages tiles
  uint8_t* sV = sK + kStages * kTile;              // kStages tiles
  float* sBias = reinterpret_cast<float*>(sV + kStages * kTile);   // [kStages][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * 2 * kRows;
  const int n_wg = q0 + kRows < P.T ? 2 : 1;       // warpgroups with a row below T
  const int n_kt = (P.T + kRows - 1) / kRows;
  // causal: up to the last warpgroup's diagonal tile
  const int n_tiles = P.causal ? q0 / kRows + n_wg : n_kt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);         // the producer's lanes, and the TMA bytes
      tc::mbar_init(&empty[s], 4 * n_wg);  // one arrival per consumer warp
    }
    tc::mbar_init(q_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // ------------------------------------------- producer
    produce_rows_and_keys<DP>(&mq, nullptr, &mk, &mv, sQ, nullptr, sK, sV, sBias, full, empty,
                              q_full, P, bh, q0, n_wg, n_tiles, lane);
    return;
  }

  // ---------------------------------------------------------- consumers
  const int wg = warp / 4;
  if (wg >= n_wg) return;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int q0w = q0 + kRows * wg;
  const int n_mine = P.causal ? q0w / kRows + 1 : n_kt;   // key tiles this warpgroup needs
  const int r0 = q0w + 16 * w + g;                         // this thread's rows r0, r0 + 8
  const float inv_keep = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;
  uint8_t* myQ = sQ + wg * kTile;

  tc::mbar_wait(q_full, 0);
  scale_tile<T>(myQ, kTile, P.op_scale, tid);
  tc::fence_proxy_async();
  tc::named_sync(1 + wg, 128);

  float o[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    if (i < n_mine) {
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      const uint8_t* ktile = sK + s * kTile;
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<kHalf>(sc, tc::desc_k(myQ, kk, kAtom), tc::desc_k(ktile, kk, kAtom), kk);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(sc);

      const int k0 = i * kRows;
      const float* bias_s = sBias + s * kRows;
      const bool diag = P.causal && k0 + kRows - 1 > q0w;
      float mx[2];
      if (diag || k0 + kRows > P.T)
        fwd_scores<true>(sc, mx, P, bias_s, k0, r0, t, diag);
      else
        fwd_scores<false>(sc, mx, P, bias_s, k0, r0, t, diag);
      float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = m_new[r] == -INFINITY ? 1.f : exp2_(m[r] - m_new[r]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = row8(e);
        float p = m_new[r] == -INFINITY ? 0.f : exp2_(sc[e] - m_new[r]);
        rs[r] += p;
        if (P.rate > 0.f) {
          const uint32_t bits =
              dropout_bits(P.seed, bh, gq(P, r0 + 8 * r), gk(P, k0 + col(e, t)));
          p = bits >= P.threshold ? p * inv_keep : 0.f;
        }
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
      const uint8_t* vtile = sV + s * kTile;
      tc::fence_regs(o);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::wgmma_rs<kHalf>(o, pa[kk], tc::desc_mn(vtile, kk, kAtom), 1);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_regs(o);
    }
    if (lane == 0) tc::mbar_arrive(&empty[s]);
  }

  const long long base = static_cast<long long>(bh) * P.T * P.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= P.T) continue;
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
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, Params P) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = tile_bytes<DP>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);               // NWG tiles, resident
  uint8_t* sV = sK + NWG * kTile;                  // NWG tiles, resident
  uint8_t* sQ = sV + NWG * kTile;                  // kStages tiles
  uint8_t* sO = sQ + kStages * kTile;              // dO, kStages tiles
  float* sL = reinterpret_cast<float*>(sO + kStages * kTile);   // [kStages][64] lse * log2(e)
  float* sD = sL + kStages * kRows;                              // [kStages][64] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(sD + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  // causal: the first key tiles have the most query tiles, so run them first
  const int kt = P.causal ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int k0 = kt * NWG * kRows;
  const int n_wg = min(NWG, (P.T - k0 + kRows - 1) / kRows);
  const int first = P.causal ? k0 / kRows : 0;     // the first query tile
  const int n_tiles = (P.T + kRows - 1) / kRows - first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 4 * n_wg);
    }
    tc::mbar_init(kv_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // ------------------------------- producer (warp)
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp > 4 * NWG) return;
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(kv_full, 2 * n_wg * kTile);
      for (int w = 0; w < n_wg; ++w)
        for (int a = 0; a < DP / 64; ++a) {
          tc::tma_load(sK + w * kTile + a * kAtom, &mk, kv_full, 64 * a, k0 + kRows * w, bh);
          tc::tma_load(sV + w * kTile + a * kAtom, &mv, kv_full, 64 * a, k0 + kRows * w, bh);
        }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      const int q0 = (first + i) * kRows;
      for (int c = lane; c < kRows; c += 32) {
        const bool in = q0 + c < P.T;
        const long long row = static_cast<long long>(bh) * P.T + q0 + c;
        sL[s * kRows + c] = in ? lse[row] * kLog2e : 0.f;
        sD[s * kRows + c] = in ? delta[row] : 0.f;
      }
      if (lane == 0) {
        tc::mbar_arrive_expect_tx(&full[s], 2 * kTile);
        for (int a = 0; a < DP / 64; ++a) {
          tc::tma_load(sQ + s * kTile + a * kAtom, &mq, &full[s], 64 * a, q0, bh);
          tc::tma_load(sO + s * kTile + a * kAtom, &mdo, &full[s], 64 * a, q0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = warp / 4;
  if (wg >= n_wg) return;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int k0w = k0 + kRows * wg;
  const int first_mine = P.causal ? k0w / kRows : 0;  // query tiles before it: all masked
  const int kr0 = k0w + 16 * w + g;                    // this thread's keys kr0, kr0 + 8
  const float inv_keep = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;
  const float* bias_row = P.bias ? P.bias + static_cast<long long>(bh / P.H) * P.T : nullptr;
  float bk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    bk[r] = bias_row && kr0 + 8 * r < P.T ? bias_row[kr0 + 8 * r] * kLog2e : 0.f;
  uint8_t* myK = sK + wg * kTile;
  const uint8_t* myV = sV + wg * kTile;

  tc::mbar_wait(kv_full, 0);
  scale_tile<T>(myK, kTile, P.op_scale, tid);
  tc::fence_proxy_async();
  tc::named_sync(1 + wg, 128);

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dka[e] = dva[e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    const int qt = first + i;
    if (qt >= first_mine) {
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

      // query tiles whose first row is past this warpgroup's last key need
      // no mask; the last tile may reach past T
      const int q0 = qt * kRows;
      const float* lse_s = sL + s * kRows;
      const float* dlt_s = sD + s * kRows;
      const bool diag = P.causal && q0 < k0w + kRows - 1;
      if (diag || q0 + kRows > P.T)
        dkv_probs<true>(sc, dp, P, lse_s, dlt_s, bk, q0, kr0, t, diag, bh, inv_keep);
      else
        dkv_probs<false>(sc, dp, P, lse_s, dlt_s, bk, q0, kr0, t, diag, bh, inv_keep);
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

  const long long base = static_cast<long long>(bh) * P.T * P.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kr0 + 8 * r;
    if (kj >= P.T) continue;
    const long long at = base + static_cast<long long>(kj) * P.D;
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
// The forward's roles: Q (scaled, rounded) and dO resident, K and V streamed.
template <typename T, int DP>
__global__ void __launch_bounds__(288, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, Params P) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTile = tile_bytes<DP>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);               // one tile per consumer warpgroup
  uint8_t* sO = sQ + 2 * kTile;                    // dO, one tile per consumer warpgroup
  uint8_t* sK = sO + 2 * kTile;                    // kStages tiles
  uint8_t* sV = sK + kStages * kTile;              // kStages tiles
  float* sBias = reinterpret_cast<float*>(sV + kStages * kTile);   // [kStages][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * 2 * kRows;
  const int n_wg = q0 + kRows < P.T ? 2 : 1;       // warpgroups with a row below T
  const int n_kt = (P.T + kRows - 1) / kRows;
  const int n_tiles = P.causal ? q0 / kRows + n_wg : n_kt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 4 * n_wg);
    }
    tc::mbar_init(q_full, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // ------------------------------------------- producer
    produce_rows_and_keys<DP>(&mq, &mdo, &mk, &mv, sQ, sO, sK, sV, sBias, full, empty, q_full,
                              P, bh, q0, n_wg, n_tiles, lane);
    return;
  }

  // ---------------------------------------------------------- consumers
  const int wg = warp / 4;
  if (wg >= n_wg) return;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int q0w = q0 + kRows * wg;
  const int n_mine = P.causal ? q0w / kRows + 1 : n_kt;   // key tiles this warpgroup needs
  const int r0 = q0w + 16 * w + g;                         // this thread's rows r0, r0 + 8
  const float inv_keep = P.rate > 0.f ? 1.f / (1.f - P.rate) : 1.f;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    const long long row = static_cast<long long>(bh) * P.T + qi;
    lse2[r] = qi < P.T ? lse[row] * kLog2e : 0.f;
    dlt[r] = qi < P.T ? delta[row] : 0.f;
  }
  uint8_t* myQ = sQ + wg * kTile;
  const uint8_t* myO = sO + wg * kTile;

  tc::mbar_wait(q_full, 0);
  scale_tile<T>(myQ, kTile, P.op_scale, tid);
  tc::fence_proxy_async();
  tc::named_sync(1 + wg, 128);

  float dqa[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dqa[e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    if (i < n_mine) {
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

      const int k0 = i * kRows;
      const float* bias_s = sBias + s * kRows;
      const bool diag = P.causal && k0 + kRows - 1 > q0w;
      if (diag || k0 + kRows > P.T)
        dq_grads<true>(sc, dp, P, bias_s, lse2, dlt, k0, r0, t, diag, bh, inv_keep);
      else
        dq_grads<false>(sc, dp, P, bias_s, lse2, dlt, k0, r0, t, diag, bh, inv_keep);
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

  const long long base = static_cast<long long>(bh) * P.T * P.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= P.T) continue;
    T* row = dq + base + static_cast<long long>(qi) * P.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < P.D)
        store2(row + c, dqa[4 * j + 2 * r] * P.sm_scale, dqa[4 * j + 2 * r + 1] * P.sm_scale);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int DP>
cudaError_t launch_tc(int pass, int BH, const void* q, const void* k, const void* v,
                      const void* dout, float* lse, const float* delta, void* o1, void* o2,
                      const Params& P, cudaStream_t st) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = tc::make_map(&mq, q, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess ||
      (err = tc::make_map(&mk, k, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess ||
      (err = tc::make_map(&mv, v, kHalf, BH, P.T, P.D, kRows)) != cudaSuccess) {
    return err;
  }
  if (pass == kFwd) {
    constexpr int smem = fwd_smem<DP>();
    auto kernel = flash_fwd_tc_kernel<T, DP>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P.T + 2 * kRows - 1) / (2 * kRows), BH);
    kernel<<<grid, 288, smem, st>>>(mq, mk, mv, static_cast<T*>(o1), lse, P);
    return cudaGetLastError();
  }
  err = tc::make_map(&mdo, dout, kHalf, BH, P.T, P.D, kRows);
  if (err != cudaSuccess) return err;
  if (pass == kDq) {
    constexpr int smem = dq_smem<DP>();
    auto kernel = flash_bwd_dq_tc_kernel<T, DP>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P.T + 2 * kRows - 1) / (2 * kRows), BH);
    kernel<<<grid, 288, smem, st>>>(mq, mk, mv, mdo, lse, delta, static_cast<T*>(o1), P);
  } else {
    constexpr int NWG = DP == 64 ? 2 : 1;
    constexpr int smem = dkv_smem<DP, NWG>();
    auto kernel = flash_bwd_dkv_tc_kernel<T, DP, NWG>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P.T + NWG * kRows - 1) / (NWG * kRows), BH);
    kernel<<<grid, dkv_threads<NWG>(), smem, st>>>(mq, mk, mv, mdo, lse, delta, static_cast<T*>(o1),
                                               static_cast<T*>(o2), P);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int run_tc(int pass, const void* q, const void* k, const void* v, const void* dout,
           float* lse, const float* delta, const float* bias, void* o1, void* o2, int BH,
           int H, int T, int D, float sm_scale, float op_scale, int causal, float rate,
           unsigned threshold, unsigned seed, int q_off, int k_off, int q_half, int q_off1,
           int k_half, int k_off1, int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || T < 1 || D < 8 || D > 128 || D % 8 != 0 ||
      BH > 65535 || (dtype != 1 && dtype != 2) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{H,     T,    D,     sm_scale, op_scale, causal, bias,   rate,
           threshold, seed, q_off, k_off,    q_half,   q_off1, k_half, k_off1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = D <= 64 ? launch_tc<__nv_bfloat16, 64>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st)
                  : launch_tc<__nv_bfloat16, 128>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  } else {
    err = D <= 64 ? launch_tc<__half, 64>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st)
                  : launch_tc<__half, 128>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  }
  return static_cast<int>(err);
}

}  // namespace tcfa

}  // namespace

// q, k, v, out: [B*H, T, D] contiguous of one type (dtype 0 float32,
// 1 bfloat16, 2 float16); lse: float32 [B*H, T]; bias: float32 [B, T] or
// null; op_scale = sm_scale * log2(e); q_off, k_off and the second segments
// q_half, q_off1, k_half, k_off1 as in Params. Each returns the launch's
// cudaError.
#define FLASH_TAIL                                                                  \
  int BH, int H, int T, int D, float sm_scale, float op_scale, int causal, float rate, \
      unsigned threshold, unsigned seed, int q_off, int k_off, int q_half, int q_off1,  \
      int k_half, int k_off1, int dtype, void* stream
#define FLASH_TAIL_ARGS                                                                \
  BH, H, T, D, sm_scale, op_scale, causal, rate, threshold, seed, q_off, k_off, q_half, \
      q_off1, k_half, k_off1, dtype, stream

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, FLASH_TAIL) {
  return run(kFwd, q, k, v, nullptr, lse, nullptr, bias, out, nullptr, FLASH_TAIL_ARGS);
}

// dout, dq: as q; lse, delta: float32 [B*H, T].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const float* bias, void* dq,
                            FLASH_TAIL) {
  return run(kDq, q, k, v, dout, const_cast<float*>(lse), delta, bias, dq, nullptr,
             FLASH_TAIL_ARGS);
}

// dk, dv: as k.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const float* bias, void* dk,
                             void* dv, FLASH_TAIL) {
  return run(kDkv, q, k, v, dout, const_cast<float*>(lse), delta, bias, dk, dv,
             FLASH_TAIL_ARGS);
}

// The tensor-core entries: the arguments of flash_fwd, flash_bwd_dq and
// flash_bwd_dkv, for dtype 1 (bfloat16) or 2 (float16), D <= 128 a multiple
// of 8, and q, k, v, dout 16-byte aligned; anything else returns
// cudaErrorInvalidValue.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, const float* bias,
                            void* out, float* lse, FLASH_TAIL) {
  return tcfa::run_tc(kFwd, q, k, v, nullptr, lse, nullptr, bias, out, nullptr,
                      FLASH_TAIL_ARGS);
}

extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const float* bias,
                               void* dq, FLASH_TAIL) {
  return tcfa::run_tc(kDq, q, k, v, dout, const_cast<float*>(lse), delta, bias, dq, nullptr,
                      FLASH_TAIL_ARGS);
}

extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const float* bias,
                                void* dk, void* dv, FLASH_TAIL) {
  return tcfa::run_tc(kDkv, q, k, v, dout, const_cast<float*>(lse), delta, bias, dk, dv,
                      FLASH_TAIL_ARGS);
}
