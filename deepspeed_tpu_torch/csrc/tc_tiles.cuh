// Tensor-core helpers for Hopper (sm_90a), as raw PTX: TMA tensor maps and
// loads, mbarriers, 128-byte-swizzled wgmma descriptors and the wgmma shapes
// the attention kernels use. No CuTe: its templates add minutes to a build.
//
// Shared-memory tiles are [rows, 64] atoms of 16-bit elements, 128 bytes a
// row, as TMA writes them under CU_TENSOR_MAP_SWIZZLE_128B; a row of DP
// elements is DP / 64 such atoms side by side, each atom at a 1024-byte
// aligned address (the swizzle is a function of the address bits, so TMA and
// wgmma agree only on aligned atoms).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled looked up at run time (cudaGetDriverEntryPoint), so
// that nothing links libcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A contiguous [BH, T, D] tensor of 16-bit elements (half: float16, else
// bfloat16) as a 3-D map with a box of 64 columns x `rows` rows x one head:
// a box never crosses into the next head, and rows past T and columns past D
// arrive as zeros. D * 2 bytes must be a multiple of 16 and ptr 16-aligned.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, bool half, int BH, int T,
                            int D, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                        static_cast<cuuint64_t>(BH)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                           static_cast<cuuint64_t>(T) * D * 2};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem_strides[3] = {1, 1, 1};
  CUresult r = encode(map, half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous layer-major page pool [L, NB, BS, NH, D] (dtype 0 float32,
// 1 bfloat16, 2 float16) as a 5-D map whose box is `rows` tokens of one page
// for `heads` heads: it lands in shared memory as row-major
// [rows][heads][D] without swizzle. The layer and the page are coordinates,
// so one map serves every layer and page; rows past BS arrive as zeros.
// D * element size must be a multiple of 16 bytes and ptr 16-aligned.
inline cudaError_t make_pool_map(CUtensorMap* map, const void* ptr, int dtype, long long L,
                                 long long NB, int BS, int NH, int D, int heads, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = dtype == 0 ? 4 : 2;
  cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(NH),
                        static_cast<cuuint64_t>(BS), static_cast<cuuint64_t>(NB),
                        static_cast<cuuint64_t>(L)};
  cuuint64_t strides[4] = {dims[0] * es, dims[0] * dims[1] * es,
                           dims[0] * dims[1] * dims[2] * es,
                           dims[0] * dims[1] * dims[2] * dims[3] * es};
  cuuint32_t box[5] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(heads),
                       static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUtensorMapDataType type = dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUresult r = encode(map, type, 5, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One test of the barrier's phase of the given parity (0 for its first
// phase, then alternating): 1 when it has completed. kCluster: acquire at
// cluster scope, so that what another CTA of the cluster released with its
// arrivals is visible after it.
template <bool kCluster>
__device__ __forceinline__ uint32_t mbar_test(uint32_t addr, uint32_t parity) {
  uint32_t done;
  if constexpr (kCluster) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
  return done;
}

// Wait for the completion of the barrier's phase of the given parity
// (kCluster: as mbar_test). A wait of more than about ten seconds can only be
// a fault in the pipeline: it traps, so that the launch fails with an error
// instead of hanging the card. The clock is read only once a first test has
// failed, so a wait whose phase has already completed reads none.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_test<kCluster>(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_test<kCluster>(addr, parity))
    if (clock64() - start > 20000000000ll) __trap();
}

// One TMA box at (column c0, row c1, head c2) into shared memory; completion
// is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// One arrival on the barrier at bar's offset in the shared memory of the
// cluster's CTA `rank` (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}"
      ::"r"(smem_u32(bar)), "r"(rank) : "memory");
}

// 16 bytes at p's offset in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint4 ld_cluster_v4(const void* p, uint32_t rank) {
  uint4 v;
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %4, %5;\n"
      "ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [ra];\n}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(smem_u32(p)), "r"(rank) : "memory");
  return v;
}

// Every thread of the cluster that has not exited arrives, then waits for
// the others: a CTA's shared memory stays until its peers are done with it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// One box of a 5-D map (make_pool_map) at coordinates c0 (innermost) .. c4.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// The first 1024-byte aligned address at or after p (a swizzled atom's base).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of 16-bit element (row, col) in a [64, n * 64] tile of
// 128-byte-swizzled atoms (atom col / 64, 16-byte chunk XOR row % 8): where
// TMA puts it, and where a thread writes an operand that wgmma reads.
__host__ __device__ __forceinline__ uint32_t sw128(int row, int col) {
  return (col >> 6) * (64 * 128) + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

// Thread-written shared memory made visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier over `count` threads (a warpgroup) on hardware barrier `id` > 0.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand. SBO = 1024
// bytes (the next 8 rows); lbo: for an MN-major operand the stride between
// its 64-element column atoms, ignored for a K-major one.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The k16 step `kk` of a K-major [rows, DP] tile: atom kk / 4, 32 bytes a step
// inside the atom. atom_bytes: the size of one [rows, 64] atom.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk, int atom_bytes) {
  return desc_sw128(tile + (kk / 4) * atom_bytes + (kk % 4) * 32, 16);
}

// The k16 step `kk` of an MN-major [K rows, N] tile (K = rows): 16 rows of 128
// bytes a step; its N atoms atom_bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk, int atom_bytes) {
  return desc_sw128(tile + kk * 2048, atom_bytes);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most one committed group is in flight: the group before the
// last one has finished reading its operands.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// between a wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats rounded to one packed 16-bit pair, the first in the low half:
// a register A fragment of wgmma.
template <bool kHalf>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// 2^x by the SFU alone (ex2.approx: relative error about 2^-22, far below
// the 16-bit operands' rounding; 2^-inf = 0); exp2f's exact path costs
// several times as many instructions, and the softmax, not the tensor cores,
// bounds the attention kernels.
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to T (float16 or bfloat16) and stored as a pair.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
}

// A row of a 64 x N accumulator lives in the 4 threads of a quad.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sixteen 32-bit words a quad, four a lane, w[k] being lane t's word of
// "combo" k, exchanged so that lane t ends with combo t's four words, lane
// s's in w[s]. An accumulator fragment's pairs rounded to 16 bits, combos
// being (row r, column group j) of 8 columns: each lane then holds one row's
// 8 consecutive values, 16 bytes to store at once.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // round k: lane t reads lane (t + k) & 3's word of combo t, and so
    // sends its own word of combo (t - k) & 3
    const int give = (t - k) & 3, from = (t + k) & 3;
    const uint32_t send = give == 0 ? w[0] : give == 1 ? w[1] : give == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_sync(0xffffffffu, send, from, 4);
#pragma unroll
    for (int s = 0; s < 4; ++s) out[s] = from == s ? got : out[s];
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) w[s] = out[s];
}

// Element e of a thread's 64 x 64 accumulator: row offset 8 * row8(e) from
// the thread's first row, column col(e, t).
__device__ __forceinline__ int row8(int e) { return (e % 4) / 2; }
__device__ __forceinline__ int col(int e, int t) { return 8 * (e / 4) + 2 * t + (e % 2); }

// ------------------------------------------------------------------ wgmma
// D[64, N] (+)= A[64, 16] * B[16, N], f32 accumulators. The accumulator
// fragment: thread (warp w, lane 4g + t) holds d[4j + c] at row 16w + g +
// 8 (c / 2), column 8j + 2t + c % 2. ss: A and B K-major in shared memory;
// rs: A in registers (the same layout as a 64 x 16 slice of the
// accumulator, packed in pairs), B MN-major in shared memory (transposed).
// ss_t: A K-major and B MN-major (a row-major [K, N] weight tile), both in
// shared memory. acc = 0 overwrites D.
#define TC_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_D32 TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
#define TC_D64 TC_D32, TC_D8(32), TC_D8(40), TC_D8(48), TC_D8(56)
#define TC_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TC_R64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define TC_SS_N64(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TC_R32 \
               ", %32, %33, p, 1, 1, 0, 0;\n}"                                     \
               : TC_D32 : "l"(da), "l"(db), "r"(acc))
#define TC_SS_T_N64(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TC_R32 \
               ", %32, %33, p, 1, 1, 0, 1;\n}"                                     \
               : TC_D32 : "l"(da), "l"(db), "r"(acc))
#define TC_SS_T_N128(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " TC_R64 \
               ", %64, %65, p, 1, 1, 0, 1;\n}"                                      \
               : TC_D64 : "l"(da), "l"(db), "r"(acc))
#define TC_RS_N64(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TC_R32 \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"                       \
               : TC_D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))
#define TC_RS_N128(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " TC_R64 \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"                        \
               : TC_D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

template <bool kHalf>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (kHalf) TC_SS_N64("f16");
  else TC_SS_N64("bf16");
}

// N = 64 or 128 by the accumulator's size
template <bool kHalf>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (kHalf) TC_SS_T_N64("f16");
  else TC_SS_T_N64("bf16");
}
template <bool kHalf>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  if constexpr (kHalf) TC_SS_T_N128("f16");
  else TC_SS_T_N128("bf16");
}

// N = 64 or 128 (the padded head dim) by the accumulator's size
template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  if constexpr (kHalf) TC_RS_N64("f16");
  else TC_RS_N64("bf16");
}
template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  if constexpr (kHalf) TC_RS_N128("f16");
  else TC_RS_N128("bf16");
}

#undef TC_SS_N64
#undef TC_SS_T_N64
#undef TC_SS_T_N128
#undef TC_RS_N64
#undef TC_RS_N128
#undef TC_R64
#undef TC_R32
#undef TC_D64
#undef TC_D32
#undef TC_D8

// The A fragments of k16 step kk from a 64 x 64 f32 accumulator (32 values a
// thread): columns 16kk .. 16kk + 15 rounded to 16 bits in pairs.
template <bool kHalf>
__device__ __forceinline__ void acc_to_a(const float (&s)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack2<kHalf>(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack2<kHalf>(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack2<kHalf>(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack2<kHalf>(s[8 * kk + 6], s[8 * kk + 7]);
}

}  // namespace tc
