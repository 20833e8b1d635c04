// Tile helpers shared by the attention kernels of flash_attention.cu and
// block_sparse_attention.cu: a CTA of 256 threads (a 16 x 16 grid) stages
// float tiles in shared memory and reduces a score row over a half warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// x rounded to T and back: the TPU kernels' .astype(operand dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// Stage rows [r0, r0 + BM) of a [T, D] slab into a float tile of row stride
// DP + 1 (column walks hit distinct banks), zero past n_rows and past D;
// optionally scaled and rounded to T.
template <typename T, int DP, int BM>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int n_rows, int D, float scale,
                                          bool scaled) {
  for (int idx = threadIdx.x; idx < BM * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    float x = 0.f;
    if (r0 + r < n_rows && c < D) {
      x = to_f(src[static_cast<long long>(r0 + r) * D + c]);
      if (scaled) x = round_to<T>(x * scale);
    }
    dst[r * (DP + 1) + c] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace
