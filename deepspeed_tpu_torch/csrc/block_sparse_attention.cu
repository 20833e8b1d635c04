// Block-sparse attention for Hopper (sm_90a): forward, dq and dk/dv over the
// active blocks of a [H, T/block, T/block] layout, bound through ctypes.
//
// Replaces the kernel bodies of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   bs_fwd <- _bs_fwd_kernel_res and _bs_fwd_kernel   (launched by _bs_fwd)
//   bs_dq  <- _bs_dq_kernel_res  and _bs_dq_kernel    (launched by _bs_bwd)
//   bs_dkv <- _bs_dkv_kernel_res and _bs_dkv_kernel   (launched by _bs_bwd)
// The TPU file has a VMEM-resident and a DMA variant of each pass, and packs
// several layout rows into one grid cell for its 128 x 128 matrix unit; both
// are TPU artifacts, so each pass is one kernel here and reads the group-1
// LUT: counts[h * nb + r] active k-blocks cols[h * nb + r][:] (ascending) for
// the forward and dq, and the transposed counts_t / rows_t for dk/dv.
//
// What each pass computes is what its TPU body computes, and it rounds where
// that body rounds: scores q.k in float32, then times sm_scale; natural exp;
// lanes that the causal mask drops (token level, q < k, in blocks on the
// diagonal) set to exactly 0 by a select; the probabilities rounded to v's
// type before p.v, the normalizer l summed unrounded and floored at 1e-30;
// lse = m + log(l). dq: p = exp(s - lse), dS = p * (dO.v - delta) rounded to
// k's type, dq = sm_scale * dS.k. dk/dv: dv = p.dO with p rounded, dk =
// sm_scale * dS.q with dS rounded to q's type. A row with no active block
// (or none left after the causal mask) writes 0 and lse -inf; a column with
// none writes dk = dv = 0; nothing there is NaN.
//
// Bound: operations, barely. At the slice's shape (B 1, H 16, T 8192, D 64,
// block 256, 92 of 528 causal blocks a head) a pass does 2, 3 or 4 products
// of 10.2 GFLOP over the lanes that the layout and the causal mask keep, on
// 68-102 MB of inputs and outputs: 0.021-0.041 ms at 989 TFLOP/s against
// 0.020-0.030 ms at 3.35 TB/s.
//
// Design (the simple one of flash_attention.cu): float tiles in shared memory
// and f32 FMA on the CUDA cores, no tensor cores. A CTA of 256 threads (a
// 16 x 16 grid, each thread owning R x R scores) owns BM rows of its own side
// (q for the forward and dq, k for dk/dv) and walks the other side's active
// blocks in sub-tiles of BM rows; BM is the largest of 64, 32, 16 that divides
// the layout block (at most 32 at D > 128), so a tile never straddles two
// layout rows. Under the causal mask a sub-tile wholly on the masked side of
// the diagonal is skipped before it is loaded. The grid's x index is b * H + h
// and its y index the tile, so that the tiles of layout row (column) 0, the
// global row or column of the BigBird, Longformer and Variable layouts, are
// the first to be scheduled. bf16/fp16 at D <= 128 (a multiple of 8) and
// layout blocks of a multiple of 64 take the tensor-core design instead
// (block_sparse_attention_tc.cu: wgmma on tiles staged by TMA, a heavy row
// or column split across CTAs); this file takes float32, the other head
// dims and blocks of 16 or 32.

#include <math.h>

#include "attention_tiles.cuh"

namespace {

struct Params {
  int H, T, D;
  int block, nb;       // layout block and T / block
  float sm_scale;
  int causal;
  const int* counts;   // [H * nb]: active blocks of each layout row (column)
  const int* lut;      // [H * nb, width]: their indices, ascending
  int width;
};

template <int DP, int BM>
constexpr int fwd_smem_floats() { return 3 * BM * (DP + 1) + BM * (BM + 1); }
template <int DP, int BM>
constexpr int bwd_smem_floats() { return 4 * BM * (DP + 1) + BM * (BM + 1) + 2 * BM; }

// ---------------------------------------------------------------- forward
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
bs_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, Params P) {
  constexpr int R = BM / 16;   // rows (and columns) per thread
  constexpr int CD = DP / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * (DP + 1);
  float* sV = sK + BM * (DP + 1);
  float* sP = sV + BM * (DP + 1);

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BM;
  const int D = P.D;
  const long long base = static_cast<long long>(bh) * P.T * D;
  const int row = (bh % P.H) * P.nb + q0 / P.block;
  const int n_active = P.counts[row];
  const int* kbs = P.lut + static_cast<long long>(row) * P.width;
  const int sub = P.block / BM;

  load_tile<T, DP, BM>(sQ, q + base, q0, P.T, D, 1.f, false);

  float m[R], l[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_active; ++j) {
    const int kb = kbs[j];
    for (int st = 0; st < sub; ++st) {
      const int k0 = kb * P.block + st * BM;
      if (P.causal && k0 > q0 + BM - 1) continue;  // wholly above the diagonal
      __syncthreads();
      load_tile<T, DP, BM>(sK, k + base, k0, P.T, D, 1.f, false);
      load_tile<T, DP, BM>(sV, v + base, k0, P.T, D, 1.f, false);
      __syncthreads();

      float s[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < R; ++jj) s[i][jj] = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) {
        float qa[R], kb_[R];
#pragma unroll
        for (int i = 0; i < R; ++i) qa[i] = sQ[(ty + 16 * i) * (DP + 1) + d];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) kb_[jj] = sK[(tx + 16 * jj) * (DP + 1) + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < R; ++jj) s[i][jj] += qa[i] * kb_[jj];
      }

      const bool masked_tile = P.causal && k0 + BM - 1 > q0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qi = q0 + ty + 16 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int kj = k0 + tx + 16 * jj;
          const float x = masked_tile && qi < kj ? -INFINITY : s[i][jj] * P.sm_scale;
          s[i][jj] = x;
          mx = fmaxf(mx, x);
        }
        mx = half_warp_max(mx);
        const float m_new = fmaxf(m[i], mx);
        const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const float p = s[i][jj] == -INFINITY ? 0.f : expf(s[i][jj] - m_new);
          rs += p;
          sP[(ty + 16 * i) * (BM + 1) + tx + 16 * jj] = round_to<T>(p);
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
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) out[base + static_cast<long long>(qi) * D + d] = from_f<T>(acc[i][cd] / li);
    }
    if (tx == 0) lse[static_cast<long long>(bh) * P.T + qi] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------- dq
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
bs_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, Params P) {
  constexpr int R = BM / 16;
  constexpr int CD = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BM * (DP + 1);
  float* sK = sDO + BM * (DP + 1);
  float* sV = sK + BM * (DP + 1);
  float* sS = sV + BM * (DP + 1);

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BM;
  const int D = P.D;
  const long long base = static_cast<long long>(bh) * P.T * D;
  const int row = (bh % P.H) * P.nb + q0 / P.block;
  const int n_active = P.counts[row];
  const int* kbs = P.lut + static_cast<long long>(row) * P.width;
  const int sub = P.block / BM;

  load_tile<T, DP, BM>(sQ, q + base, q0, P.T, D, 1.f, false);
  load_tile<T, DP, BM>(sDO, dout + base, q0, P.T, D, 1.f, false);
  float lr[R], dlt[R], acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long at = static_cast<long long>(bh) * P.T + q0 + ty + 16 * i;
    lr[i] = lse[at];
    dlt[i] = delta[at];
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_active; ++j) {
    const int kb = kbs[j];
    for (int st = 0; st < sub; ++st) {
      const int k0 = kb * P.block + st * BM;
      if (P.causal && k0 > q0 + BM - 1) continue;
      __syncthreads();
      load_tile<T, DP, BM>(sK, k + base, k0, P.T, D, 1.f, false);
      load_tile<T, DP, BM>(sV, v + base, k0, P.T, D, 1.f, false);
      __syncthreads();

      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < R; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        float qa[R], da[R], kb_[R], vb[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qa[i] = sQ[(ty + 16 * i) * (DP + 1) + d];
          da[i] = sDO[(ty + 16 * i) * (DP + 1) + d];
        }
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          kb_[jj] = sK[(tx + 16 * jj) * (DP + 1) + d];
          vb[jj] = sV[(tx + 16 * jj) * (DP + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            s[i][jj] += qa[i] * kb_[jj];
            dp[i][jj] += da[i] * vb[jj];
          }
      }

      const bool masked_tile = P.causal && k0 + BM - 1 > q0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qi = q0 + ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int kj = k0 + tx + 16 * jj;
          float ds = 0.f;
          if (!(masked_tile && qi < kj)) {
            const float p = expf(s[i][jj] * P.sm_scale - lr[i]);
            ds = p * (dp[i][jj] - dlt[i]);
          }
          sS[(ty + 16 * i) * (BM + 1) + tx + 16 * jj] = round_to<T>(ds);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BM; ++c) {
        float kv[CD];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) kv[cd] = sK[c * (DP + 1) + tx + 16 * cd];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float g = sS[(ty + 16 * i) * (BM + 1) + c];
#pragma unroll
          for (int cd = 0; cd < CD; ++cd) acc[i][cd] += g * kv[cd];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) dq[base + static_cast<long long>(qi) * D + d] = from_f<T>(acc[i][cd] * P.sm_scale);
    }
  }
}

// ---------------------------------------------------------------- dk, dv
// Transposed roles: a CTA owns BM keys (rows ty + 16 i) and walks the active
// q-blocks of its layout column (columns tx + 16 j), so each score it forms
// is s^T[k][q].
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
bs_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              Params P) {
  constexpr int R = BM / 16;
  constexpr int CD = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BM * (DP + 1);
  float* sQ = sV + BM * (DP + 1);
  float* sDO = sQ + BM * (DP + 1);
  float* sS = sDO + BM * (DP + 1);
  float* sL = sS + BM * (BM + 1);   // lse of the query sub-tile
  float* sD = sL + BM;              // delta of the query sub-tile

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;
  const int D = P.D;
  const long long base = static_cast<long long>(bh) * P.T * D;
  const int col = (bh % P.H) * P.nb + k0 / P.block;
  const int n_active = P.counts[col];
  const int* qbs = P.lut + static_cast<long long>(col) * P.width;
  const int sub = P.block / BM;

  load_tile<T, DP, BM>(sK, k + base, k0, P.T, D, 1.f, false);
  load_tile<T, DP, BM>(sV, v + base, k0, P.T, D, 1.f, false);
  float dka[R][CD], dva[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int j = 0; j < n_active; ++j) {
    const int qb = qbs[j];
    for (int st = 0; st < sub; ++st) {
      const int q0 = qb * P.block + st * BM;
      if (P.causal && q0 + BM - 1 < k0) continue;  // every query before every key
      __syncthreads();
      load_tile<T, DP, BM>(sQ, q + base, q0, P.T, D, 1.f, false);
      load_tile<T, DP, BM>(sDO, dout + base, q0, P.T, D, 1.f, false);
      for (int c = threadIdx.x; c < BM; c += kThreads) {
        const long long at = static_cast<long long>(bh) * P.T + q0 + c;
        sL[c] = lse[at];
        sD[c] = delta[at];
      }
      __syncthreads();

      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < R; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        float ka[R], va[R], qv[R], dv_[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          ka[i] = sK[(ty + 16 * i) * (DP + 1) + d];
          va[i] = sV[(ty + 16 * i) * (DP + 1) + d];
        }
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          qv[jj] = sQ[(tx + 16 * jj) * (DP + 1) + d];
          dv_[jj] = sDO[(tx + 16 * jj) * (DP + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            s[i][jj] += ka[i] * qv[jj];
            dp[i][jj] += va[i] * dv_[jj];
          }
      }

      const bool masked_tile = P.causal && q0 < k0 + BM - 1;
      float ds[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int qi = q0 + tx + 16 * jj;
          float p = 0.f;
          if (!(masked_tile && qi < kj)) p = expf(s[i][jj] * P.sm_scale - sL[tx + 16 * jj]);
          sS[(ty + 16 * i) * (BM + 1) + tx + 16 * jj] = round_to<T>(p);
          ds[i][jj] = p * (dp[i][jj] - sD[tx + 16 * jj]);
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
        for (int jj = 0; jj < R; ++jj)
          sS[(ty + 16 * i) * (BM + 1) + tx + 16 * jj] = round_to<T>(ds[i][jj]);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BM; ++c) {
        float qv[CD];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) qv[cd] = sQ[c * (DP + 1) + tx + 16 * cd];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float g = sS[(ty + 16 * i) * (BM + 1) + c];
#pragma unroll
          for (int cd = 0; cd < CD; ++cd) dka[i][cd] += g * qv[cd];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
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
                   const void* dout, float* lse, const float* delta, void* o1, void* o2,
                   const Params& P, cudaStream_t st) {
  const dim3 grid(BH, P.T / BM);
  const dim3 block(kThreads);
  const size_t smem = sizeof(float) * (pass == kFwd ? fwd_smem_floats<DP, BM>()
                                                    : bwd_smem_floats<DP, BM>());
  cudaError_t err = cudaSuccess;
  if (pass == kFwd) {
    err = cudaFuncSetAttribute(bs_fwd_kernel<T, DP, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bs_fwd_kernel<T, DP, BM><<<grid, block, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o1), lse, P);
  } else if (pass == kDq) {
    err = cudaFuncSetAttribute(bs_dq_kernel<T, DP, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bs_dq_kernel<T, DP, BM><<<grid, block, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(o1), P);
  } else {
    err = cudaFuncSetAttribute(bs_dkv_kernel<T, DP, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bs_dkv_kernel<T, DP, BM><<<grid, block, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(o1),
        static_cast<T*>(o2), P);
  }
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dispatch_tile(int pass, int BH, const void* q, const void* k, const void* v,
                          const void* dout, float* lse, const float* delta, void* o1,
                          void* o2, const Params& P, cudaStream_t st) {
  // the largest tile that divides the layout block; 32 rows at most when
  // DP = 256, where 64-row float tiles outgrow shared memory
  if constexpr (DP <= 128) {
    if (P.block % 64 == 0)
      return launch<T, DP, 64>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  }
  if (P.block % 32 == 0)
    return launch<T, DP, 32>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  return launch<T, DP, 16>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
}

template <typename T>
cudaError_t dispatch_dim(int pass, int BH, const void* q, const void* k, const void* v,
                         const void* dout, float* lse, const float* delta, void* o1,
                         void* o2, const Params& P, cudaStream_t st) {
  if (P.D <= 64)
    return dispatch_tile<T, 64>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  if (P.D <= 128)
    return dispatch_tile<T, 128>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
  return dispatch_tile<T, 256>(pass, BH, q, k, v, dout, lse, delta, o1, o2, P, st);
}

int run(int pass, const void* q, const void* k, const void* v, const void* dout,
        float* lse, const float* delta, const int* counts, const int* lut, int width,
        void* o1, void* o2, int BH, int H, int T, int D, int block, float sm_scale,
        int causal, int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || D < 1 || D > 256 || block < 16 ||
      block % 16 != 0 || T < block || T % block != 0 || T / 16 > 65535 || width < 1 ||
      dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{H, T, D, block, T / block, sm_scale, causal, counts, lut, width};
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
// 1 bfloat16, 2 float16), D <= 256; lse: float32 [B*H, T]; counts: int32
// [H * nb], cols: int32 [H * nb, width] (nb = T / block, block a multiple of
// 16). Each returns the launch's cudaError.
extern "C" int bs_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                      const int* counts, const int* cols, int width, int BH, int H, int T,
                      int D, int block, float sm_scale, int causal, int dtype,
                      void* stream) {
  return run(kFwd, q, k, v, nullptr, lse, nullptr, counts, cols, width, out, nullptr, BH,
             H, T, D, block, sm_scale, causal, dtype, stream);
}

// dout, dq: as q; lse, delta: float32 [B*H, T]; the forward's LUT.
extern "C" int bs_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* counts,
                     const int* cols, int width, void* dq, int BH, int H, int T, int D,
                     int block, float sm_scale, int causal, int dtype, void* stream) {
  return run(kDq, q, k, v, dout, const_cast<float*>(lse), delta, counts, cols, width, dq,
             nullptr, BH, H, T, D, block, sm_scale, causal, dtype, stream);
}

// dk, dv: as k; counts_t, rows_t: the transposed LUT (active q-blocks of
// each k-column).
extern "C" int bs_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* counts_t,
                      const int* rows_t, int width_t, void* dk, void* dv, int BH, int H,
                      int T, int D, int block, float sm_scale, int causal, int dtype,
                      void* stream) {
  return run(kDkv, q, k, v, dout, const_cast<float*>(lse), delta, counts_t, rows_t,
             width_t, dk, dv, BH, H, T, D, block, sm_scale, causal, dtype, stream);
}
