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
// Design (the simple one): float tiles in shared memory and f32 FMA on the
// CUDA cores; no tensor cores yet. A CTA of 256 threads owns a tile of BM
// rows (64, or 32 at D > 128) and walks the other side's tiles of BM rows
// staged in shared memory (rows padded to D + 1 floats, so column walks hit
// distinct banks). Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i
// and columns tx + 16 j of each score tile; a row's max and sum reduce over
// the 16 lanes of a half warp with shuffles. The probability (or dS) tile
// goes through shared memory to its product with V (K, dO, Q). The head dim
// is padded to DP (64, 128 or 256) with zeros. T need not be a multiple of
// the tile: rows and columns past T are masked or dropped. Tiles are visited
// heaviest first under causal masking (the grid's x index runs backwards).
// Left for a later change: wgmma on bf16/fp16 tiles staged by TMA, and warp
// specialization; this kernel is far from the bound above.

#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

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
};

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
          if (masked_tile && qi + P.q_off < kj + P.k_off) x = kMaskValue;
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
              dropout_bits(P.seed, bh, qi + P.q_off, kj + P.k_off);
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
          if (masked_tile && qi + P.q_off < kj + P.k_off) x = kMaskValue;
          const float p = exp2f(x - lse2[i]);
          float g = dp[i][j];
          if (P.rate > 0.f) {
            const uint32_t bits =
                dropout_bits(P.seed, bh, qi + P.q_off, kj + P.k_off);
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
          if (masked_tile && qi + P.q_off < kj + P.k_off) x = kMaskValue;
          const float p = exp2f(x - sL[tx + 16 * j]);
          float keep = 1.f;
          if (P.rate > 0.f) {
            const uint32_t bits =
                dropout_bits(P.seed, bh, qi + P.q_off, kj + P.k_off);
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
        int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || T < 1 || D < 2 || D > 256 || D % 2 != 0 ||
      BH > 65535 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{H, T, D, sm_scale, op_scale, causal, bias, rate, threshold, seed, q_off, k_off};
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

}  // namespace

// q, k, v, out: [B*H, T, D] contiguous of one type (dtype 0 float32,
// 1 bfloat16, 2 float16); lse: float32 [B*H, T]; bias: float32 [B, T] or
// null; op_scale = sm_scale * log2(e). Each returns the launch's cudaError.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const float* bias, void* out, float* lse, int BH, int H,
                         int T, int D, float sm_scale, float op_scale, int causal,
                         float rate, unsigned threshold, unsigned seed, int q_off,
                         int k_off, int dtype, void* stream) {
  return run(kFwd, q, k, v, nullptr, lse, nullptr, bias, out, nullptr, BH, H, T, D,
             sm_scale, op_scale, causal, rate, threshold, seed, q_off, k_off, dtype,
             stream);
}

// dout, dq: as q; lse, delta: float32 [B*H, T].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            const float* bias, void* dq, int BH, int H, int T, int D,
                            float sm_scale, float op_scale, int causal, float rate,
                            unsigned threshold, unsigned seed, int q_off, int k_off,
                            int dtype, void* stream) {
  return run(kDq, q, k, v, dout, const_cast<float*>(lse), delta, bias, dq, nullptr,
             BH, H, T, D, sm_scale, op_scale, causal, rate, threshold, seed, q_off,
             k_off, dtype, stream);
}

// dk, dv: as k.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             const float* bias, void* dk, void* dv, int BH, int H,
                             int T, int D, float sm_scale, float op_scale, int causal,
                             float rate, unsigned threshold, unsigned seed, int q_off,
                             int k_off, int dtype, void* stream) {
  return run(kDkv, q, k, v, dout, const_cast<float*>(lse), delta, bias, dk, dv, BH,
             H, T, D, sm_scale, op_scale, causal, rate, threshold, seed, q_off, k_off,
             dtype, stream);
}
