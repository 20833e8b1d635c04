// Fused attention half of a transformer block for Hopper (sm_90a), bound
// through ctypes:  out = x + proj(attention(qkv(layernorm(x)))).
//
// Replaces the kernel body _fused_block_kernel of
// deepspeed_tpu/ops/pallas/fused_block.py (launched by _fused_block_impl). It
// computes what that body computes, not its blocking. The TPU body keeps both
// weights and whole-row K and V resident in VMEM and primes K/V at the first
// step of a sequential grid axis; a CTA has 227 KB of shared memory and CTAs
// run in no order, so the work is two entries:
//   fused_block_kv  LayerNorm of 32 rows, then the k and v thirds of the qkv
//                   product plus bias into a [2, B, T, E] workspace of x's type;
//   fused_block_q   LayerNorm of a 32-row q tile, the q third of the product,
//                   per head an online softmax over K/V tiles of 64 keys
//                   streamed from the workspace, the [32, E] context tile kept
//                   in shared memory, the output projection against streamed
//                   weight tiles, + b_proj + x, one rounding, one store.
// The normalized activations, q, the scores, the probabilities and the
// pre-residual output never reach device memory.
//
// Rounding points, as the TPU body: LayerNorm in f32 (two-pass variance) and
// cast to x's type; every product accumulates in f32 over operands of x's
// type; the qkv bias is added in f32 before the one cast; scores * sm_scale in
// f32, causal lanes set to -1e9 by a select, softmax in f32 (online here:
// running max and sum, probabilities exp(s - running max) cast to x's type
// before their product with V, the sum taken over the uncast values; the TPU
// body normalizes a whole row first); each head's context cast to x's type;
// x + out + b_proj summed in f32 and cast once. In float32 the kernel and its
// plain version (ops/fused_block.py) agree to summation order.
//
// Bound: operations. At GPT-2 124M's shape (x [8, 1024, 768] bf16, 12 heads,
// causal) the op does 2*B*T*E*4E = 38.7 GFLOP of weight products and 12.9
// GFLOP of attention on 30 MB of inputs and outputs.
//
// Design (the simple one, for the shapes the tensor-core design of
// fused_block_tc.cu does not take: float32 among them): f32 FMA on the CUDA
// cores. A CTA of 256 threads (8 warps) owns BM rows, BM = 32 or 16 (a
// template parameter). The rows' activations sit in shared memory in x's
// type (they are rounded to it anyway): two [BM, E] buffers in the q entry
// (hq, and q_all that the per-head context overwrites column block by column
// block). Weight tiles of 32 x 128 are staged as floats, the next tile
// prefetched into registers while the current one is multiplied; warp w owns
// rows w + 8 i (i < BM / 8), lane l columns l + 32 j (a BM/8 x 4 register
// tile: A reads are broadcasts, B reads hit distinct banks). Attention tiles
// (q BM x DP, k and v 64 x DP, p BM x 64; rows padded to DP + 1 floats) reuse
// the hq buffer and the weight stage, dead by then, or take more room where
// they are larger; warp w owns rows w + 8 i, lane l keys l + 32 j, and a row's
// max and sum reduce over the warp. The head dim is padded to DP (16, 32, 64
// or 128). The geometry is a shape rule, cuda_core_plan in
// ops/fused_block.py (and smem_q below, which it mirrors): 32 rows where the
// q entry's shared memory fits 227 KB, else 16, else the shape is refused
// (float32 at E 2048, for example). Causal tiles above the diagonal are
// skipped, heaviest q tiles first. T need not be a multiple of a tile: rows
// and keys past T are masked or dropped.

#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kNC = 128;   // output columns per product chunk
constexpr int kKC = 32;    // depth of a staged weight tile
constexpr int kBN = 64;    // keys per attention tile
constexpr int kPre = kKC * kNC / kThreads;  // staged weights per thread (16)
constexpr float kMasked = -1e9f;            // _MASK_VALUE of the TPU kernel

static_assert(kThreads == 256 && kNC == 128, "thread maps assume these");
constexpr size_t kSmemMax = 232448;         // dynamic shared memory a CTA may use

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// LayerNorm of rows [row0, row0 + n_valid) of x [*, E] into sH [BM, E] of
// type T; rows past n_valid are zero. Warp w owns rows w + 8 i; a lane reads
// back only what it wrote, so no barrier is needed inside.
template <typename T, int BM>
__device__ __forceinline__ void layer_norm_tile(T* sH, const T* __restrict__ x,
                                                long long row0, int n_valid, int E,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias,
                                                float eps) {
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < BM / 8; ++i) {
    const int r = w + 8 * i;
    T* row = sH + r * E;
    if (r >= n_valid) {
      for (int e = lane; e < E; e += 32) row[e] = from_f<T>(0.f);
      continue;
    }
    const T* src = x + (row0 + r) * E;
    float s = 0.f;
    for (int e = lane; e < E; e += 32) {
      const T v = src[e];
      row[e] = v;
      s += to_f(v);
    }
    const float mean = warp_sum(s) / static_cast<float>(E);
    float q = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = to_f(row[e]) - mean;
      q += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) / static_cast<float>(E) + eps);
    for (int e = lane; e < E; e += 32) {
      row[e] = from_f<T>((to_f(row[e]) - mean) * rstd * scale[e] + bias[e]);
    }
  }
}

// The staged element t of this thread sits at depth kk = tid / 128 + 2 t,
// column tid % 128 of the weight tile.
template <typename T>
__device__ __forceinline__ void fetch_weights(float (&pre)[kPre], const T* __restrict__ W,
                                              int ldw, int k0, int K, int col0,
                                              int n_cols) {
  const int c = col0 + threadIdx.x % kNC;
  const int kk0 = k0 + threadIdx.x / kNC;
#pragma unroll
  for (int t = 0; t < kPre; ++t) {
    const int k = kk0 + 2 * t;
    pre[t] = (k < K && c < n_cols) ? to_f(W[static_cast<long long>(k) * ldw + c]) : 0.f;
  }
}

// acc[i][j] = sum over k < K of sA[(w + 8 i) * lda + k] * W[k * ldw + col0 + lane + 32 j]
// for the columns below n_cols (others give 0), i < R = BM / 8. sW: kKC * kNC
// floats of staging. Starts with a barrier, so what sA holds may have just
// been written and sW may have just been read; ends without one.
template <typename T, int R>
__device__ __forceinline__ void product_chunk(float (&acc)[R][4], const T* sA, int lda,
                                              int K, const T* __restrict__ W, int ldw,
                                              int col0, int n_cols, float* sW) {
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float pre[kPre];
  fetch_weights<T>(pre, W, ldw, 0, K, col0, n_cols);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      sW[(threadIdx.x / kNC + 2 * t) * kNC + threadIdx.x % kNC] = pre[t];
    }
    __syncthreads();
    if (k0 + kKC < K) fetch_weights<T>(pre, W, ldw, k0 + kKC, K, col0, n_cols);
    const int kn = min(kKC, K - k0);
#pragma unroll 8
    for (int kk = 0; kk < kn; ++kk) {
      float a[R], b[4];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = to_f(sA[(w + 8 * i) * lda + k0 + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[kk * kNC + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
}

constexpr size_t kStageBytes = sizeof(float) * kKC * kNC;

template <int DP, int BM>
constexpr size_t tile_bytes() {
  return sizeof(float) * ((BM + 2 * kBN) * (DP + 1) + BM * (kBN + 1));
}

// Shared memory of each entry: the K/V entry's row buffer and weight stage;
// the q entry's two row buffers, the second shared with the weight stage or
// the attention tiles, whichever is larger.
inline size_t smem_kv(size_t itemsize, int BM, int E) {
  return itemsize * BM * E + kStageBytes;
}
inline size_t smem_q(size_t itemsize, int BM, int E, size_t tiles) {
  const size_t rows = itemsize * BM * E;
  return rows + (rows + kStageBytes > tiles ? rows + kStageBytes : tiles);
}

// ---------------------------------------------------------------- K/V pass
// ws[0] = K, ws[1] = V, each [M, E] with M = B * T rows.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
fused_block_kv_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, const T* __restrict__ w_qkv,
                      const float* __restrict__ b_qkv, T* __restrict__ ws, long long M,
                      int E, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sH = reinterpret_cast<T*>(smem_raw);
  constexpr int R = BM / 8;
  float* sW = reinterpret_cast<float*>(sH + BM * E);
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int n_valid = static_cast<int>(min(static_cast<long long>(BM), M - row0));

  layer_norm_tile<T, BM>(sH, x, row0, n_valid, E, ln_scale, ln_bias, eps);
  for (int col0 = 0; col0 < 2 * E; col0 += kNC) {
    float acc[R][4];
    product_chunk<T, R>(acc, sH, E, E, w_qkv + E, 3 * E, col0, 2 * E, sW);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = w + 8 * i;
      if (r >= n_valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + lane + 32 * j;
        if (c >= 2 * E) continue;
        const int which = c >= E ? 1 : 0;
        ws[(which * M + row0 + r) * E + (c - which * E)] =
            from_f<T>(acc[i][j] + b_qkv[E + c]);
      }
    }
  }
}

// ---------------------------------------------------------------- q pass
template <typename T, int DP, int BM>
__global__ void __launch_bounds__(kThreads)
fused_block_q_kernel(const T* __restrict__ x, const T* __restrict__ ws,
                     const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                     const T* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                     const T* __restrict__ w_proj, const float* __restrict__ b_proj,
                     T* __restrict__ out, int B, int Tn, int E, int H, float sm_scale,
                     float eps, int causal) {
  constexpr int CD = DP >= 32 ? DP / 32 : 1;  // head-dim columns per lane
  constexpr int R = BM / 8;                   // rows per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sY = reinterpret_cast<T*>(smem_raw);   // q of every head, then the context
  T* sH = sY + BM * E;                      // normalized rows
  float* sW = reinterpret_cast<float*>(sH + BM * E);
  float* sQ = reinterpret_cast<float*>(sH);  // attention tiles: over sH and sW
  float* sK = sQ + BM * (DP + 1);
  float* sV = sK + kBN * (DP + 1);
  float* sP = sV + kBN * (DP + 1);

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = qt * BM;
  const int n_valid = min(BM, Tn - q0);
  const int D = E / H;
  const long long row0 = static_cast<long long>(b) * Tn + q0;

  layer_norm_tile<T, BM>(sH, x, row0, n_valid, E, ln_scale, ln_bias, eps);
  for (int col0 = 0; col0 < E; col0 += kNC) {
    float acc[R][4];
    product_chunk<T, R>(acc, sH, E, E, w_qkv, 3 * E, col0, E, sW);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + lane + 32 * j;
        if (c < E) sY[(w + 8 * i) * E + c] = from_f<T>(acc[i][j] + b_qkv[c]);
      }
  }

  const T* kws = ws + static_cast<long long>(b) * Tn * E;
  const T* vws = ws + (static_cast<long long>(B) + b) * Tn * E;
  const int n_kt = (Tn + kBN - 1) / kBN;
  const int last = causal ? min(n_kt, (q0 + BM - 1) / kBN + 1) : n_kt;
  for (int h = 0; h < H; ++h) {
    const int hc = h * D;
    __syncthreads();  // q of every head is written; the last head's tiles are consumed
    for (int idx = threadIdx.x; idx < BM * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx % DP;
      sQ[r * (DP + 1) + c] = c < D ? to_f(sY[r * E + hc + c]) : 0.f;
    }
    float m[R], l[R], acc[R][CD];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
    }

    for (int kt = 0; kt < last; ++kt) {
      const int k0 = kt * kBN;
      __syncthreads();  // the previous tile's k, v and p are consumed
      for (int idx = threadIdx.x; idx < kBN * DP; idx += kThreads) {
        const int r = idx / DP;
        const int c = idx % DP;
        float kx = 0.f, vx = 0.f;
        if (k0 + r < Tn && c < D) {
          const long long g = static_cast<long long>(k0 + r) * E + hc + c;
          kx = to_f(kws[g]);
          vx = to_f(vws[g]);
        }
        sK[r * (DP + 1) + c] = kx;
        sV[r * (DP + 1) + c] = vx;
      }
      __syncthreads();

      float s[R][2];
#pragma unroll
      for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        float qa[R], kb[2];
#pragma unroll
        for (int i = 0; i < R; ++i) qa[i] = sQ[(w + 8 * i) * (DP + 1) + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) kb[j] = sK[(lane + 32 * j) * (DP + 1) + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) s[i][j] += qa[i] * kb[j];
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qi = q0 + w + 8 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kj = k0 + lane + 32 * j;
          float v = s[i][j] * sm_scale;
          if (kj >= Tn) {
            v = -INFINITY;
          } else if (causal && kj > qi) {
            v = kMasked;
          }
          s[i][j] = v;
          mx = fmaxf(mx, v);
        }
        // a tile holds a key below T, so the row max is finite
        const float m_new = fmaxf(m[i], warp_max(mx));
        const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[i][j] - m_new);
          rs += p;
          sP[(w + 8 * i) * (kBN + 1) + lane + 32 * j] = round_to<T>(p);
        }
        l[i] = l[i] * alpha + warp_sum(rs);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kBN; ++c) {
        float vb[CD];
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) {
          const int col = lane + 32 * cd;
          vb[cd] = col < DP ? sV[c * (DP + 1) + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = sP[(w + 8 * i) * (kBN + 1) + c];
#pragma unroll
          for (int cd = 0; cd < CD; ++cd) acc[i][cd] += p * vb[cd];
        }
      }
    }

    // this head's context over its q columns of sY (staged into sQ above)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) {
        const int col = lane + 32 * cd;
        if (col < D) sY[(w + 8 * i) * E + hc + col] = from_f<T>(acc[i][cd] / l[i]);
      }
  }

  // out = x + y @ w_proj + b_proj; product_chunk's first barrier orders the
  // context writes and the last tile reads before sW is staged
  for (int col0 = 0; col0 < E; col0 += kNC) {
    float acc[R][4];
    product_chunk<T, R>(acc, sY, E, E, w_proj, E, col0, E, sW);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = w + 8 * i;
      if (r >= n_valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + lane + 32 * j;
        if (c >= E) continue;
        const long long g = (row0 + r) * E + c;
        out[g] = from_f<T>(to_f(x[g]) + acc[i][j] + b_proj[c]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch
struct Args {
  const void *x, *ws_in, *ln_scale, *ln_bias, *w_qkv, *b_qkv, *w_proj, *b_proj;
  void *ws_out, *out;
  int B, T, E, H;
  float sm_scale, eps;
  int causal, rows;   // rows: the tile BM, 32 or 16
};

template <typename T, int BM>
cudaError_t launch_kv(const Args& a, cudaStream_t st) {
  const size_t smem = smem_kv(sizeof(T), BM, a.E);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kv_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(a.B) * a.T;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM));
  fused_block_kv_kernel<T, BM><<<grid, dim3(kThreads), smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ln_scale),
      static_cast<const float*>(a.ln_bias), static_cast<const T*>(a.w_qkv),
      static_cast<const float*>(a.b_qkv), static_cast<T*>(a.ws_out), M, a.E, a.eps);
  return cudaGetLastError();
}

template <typename T, int DP, int BM>
cudaError_t launch_q(const Args& a, cudaStream_t st) {
  const size_t smem = smem_q(sizeof(T), BM, a.E, tile_bytes<DP, BM>());
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_q_kernel<T, DP, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + BM - 1) / BM, a.B);
  fused_block_q_kernel<T, DP, BM><<<grid, dim3(kThreads), smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.ws_in),
      static_cast<const float*>(a.ln_scale), static_cast<const float*>(a.ln_bias),
      static_cast<const T*>(a.w_qkv), static_cast<const float*>(a.b_qkv),
      static_cast<const T*>(a.w_proj), static_cast<const float*>(a.b_proj),
      static_cast<T*>(a.out), a.B, a.T, a.E, a.H, a.sm_scale, a.eps, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_kv(const Args& a, cudaStream_t st) {
  return a.rows == 32 ? launch_kv<T, 32>(a, st) : launch_kv<T, 16>(a, st);
}

template <typename T, int BM>
cudaError_t dispatch_q_dim(const Args& a, cudaStream_t st) {
  const int D = a.E / a.H;
  if (D <= 16) return launch_q<T, 16, BM>(a, st);
  if (D <= 32) return launch_q<T, 32, BM>(a, st);
  if (D <= 64) return launch_q<T, 64, BM>(a, st);
  return launch_q<T, 128, BM>(a, st);
}

template <typename T>
cudaError_t dispatch_q(const Args& a, cudaStream_t st) {
  return a.rows == 32 ? dispatch_q_dim<T, 32>(a, st) : dispatch_q_dim<T, 16>(a, st);
}

// What the entries take; the shared memory of the tile is checked at launch.
bool supported(const Args& a, int dtype, bool q_pass) {
  if (a.B < 1 || a.T < 1 || a.E < 1 || dtype < 0 || dtype > 2) return false;
  if (a.rows != 32 && a.rows != 16) return false;
  if (static_cast<long long>(a.B) * a.T > 2147483647LL - a.rows) return false;
  if (q_pass && (a.H < 1 || a.E % a.H != 0 || a.E / a.H > 128 || a.B > 65535)) return false;
  return true;
}

}  // namespace

// x: [B, T, E] contiguous of one type (dtype 0 float32, 1 bfloat16,
// 2 float16); w_qkv: [E, 3E] of that type; ln_scale, ln_bias: float32 [E];
// b_qkv: float32 [3E]; ws: [2, B, T, E] of x's type, written; rows: the row
// tile, 32 or 16 (cuda_core_plan). Returns the launch's cudaError
// (cudaErrorInvalidValue where the tile's shared memory exceeds 227 KB).
extern "C" int fused_block_kv(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* w_qkv, const void* b_qkv, void* ws, int B,
                              int T, int E, float eps, int rows, int dtype, void* stream) {
  Args a{x, nullptr, ln_scale, ln_bias, w_qkv, b_qkv, nullptr, nullptr, ws, nullptr,
         B, T, E, 1, 0.f, eps, 0, rows};
  if (!supported(a, dtype, false)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_kv<float>(a, st);
  } else if (dtype == 1) {
    err = dispatch_kv<__nv_bfloat16>(a, st);
  } else {
    err = dispatch_kv<__half>(a, st);
  }
  return static_cast<int>(err);
}

// ws: what fused_block_kv wrote for the same x; w_proj: [E, E] of x's type;
// b_proj: float32 [E]; out: as x, written. H heads of E / H <= 128; rows as
// fused_block_kv's.
extern "C" int fused_block_q(const void* x, const void* ws, const void* ln_scale,
                             const void* ln_bias, const void* w_qkv, const void* b_qkv,
                             const void* w_proj, const void* b_proj, void* out, int B,
                             int T, int E, int H, float sm_scale, float eps, int causal,
                             int rows, int dtype, void* stream) {
  Args a{x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, nullptr, out,
         B, T, E, H, sm_scale, eps, causal, rows};
  if (!supported(a, dtype, true)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_q<float>(a, st);
  } else if (dtype == 1) {
    err = dispatch_q<__nv_bfloat16>(a, st);
  } else {
    err = dispatch_q<__half>(a, st);
  }
  return static_cast<int>(err);
}
