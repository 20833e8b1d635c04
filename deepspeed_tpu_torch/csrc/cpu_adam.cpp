// Host-side SIMD Adam for ZeRO-Offload (PyTorch port).
//
// The port's own copy of deepspeed_tpu/csrc/cpu_adam.cpp, the counterpart of the
// reference's csrc/adam/cpu_adam.cpp (AVX512/AVX256 + OpenMP Adam over fp32 host
// arrays, cpu_adam.cpp:21,151,336) and its fused ds_adam_step_plus_copy
// (cpu_adam.cpp:592). On the GPU machine the offloaded master and moments live in
// the host's memory; the updated parameters go back to the card in the compute dtype,
// so the fused entries write the bf16 (round-to-nearest-even) or fp16 copy in the
// same pass.
//
// ds_adam_step and ds_adam_step_copy are the JAX package's two entries, with the same
// arithmetic in the same order: built with the same flags they give the same bits.
// The port adds entries for what the JAX copy leaves to numpy: grads read directly in
// bf16 or fp16 (the compute dtype the card keeps them in, converted exactly to fp32
// before use) and an fp16 output. Every entry computes the values ds_adam_step would
// on the fp32-converted grads.
//
// What bounds it: memory. Each element reads p, m, v and the grad and writes p, m, v
// and the copy, about 30 bytes for a few tens of operations. The loops are written to
// be auto-vectorizable (restrict pointers, no branches in the hot path) and built with
// -O3 -march=native -fopenmp -fno-math-errno, so gcc emits the AVX2/AVX-512 code the
// reference's intrinsics spell out (without -fno-math-errno the errno branch of sqrtf
// keeps the loop scalar; the vector square root gives the same bits) and OpenMP
// spreads the range over the host's cores.

#include <omp.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float bf16_to_fp32(uint16_t h) {
  const uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
}

inline uint16_t fp32_to_bf16_rne(float x) {
  union {
    float f;
    uint32_t u;
  } bits;
  bits.f = x;
  const uint32_t rounding = 0x7FFFu + ((bits.u >> 16) & 1u);
  return (uint16_t)((bits.u + rounding) >> 16);
}

// IEEE half conversions in integer arithmetic (no _Float16, which older
// compilers lack on x86): exact widening, and narrowing with round to nearest
// even, overflow to inf, subnormal halves and a quiet NaN
inline float fp16_to_fp32(uint16_t h) {
  const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t e = (h >> 10) & 0x1Fu;
  uint32_t m = h & 0x3FFu;
  uint32_t bits;
  if (e == 31) {
    bits = sign | 0x7F800000u | (m << 13);
  } else if (e != 0) {
    bits = sign | ((e + 112) << 23) | (m << 13);
  } else if (m == 0) {
    bits = sign;
  } else {  // subnormal: move the leading one to bit 10
    const int shift = __builtin_clz(m) - 21;
    m = (m << shift) & 0x3FFu;
    bits = sign | ((uint32_t)(113 - shift) << 23) | (m << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

inline uint16_t fp32_to_fp16_rne(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof(u));
  const uint16_t sign = (uint16_t)((u >> 16) & 0x8000u);
  const uint32_t ax = u & 0x7FFFFFFFu;
  if (ax > 0x7F800000u) return sign | 0x7E00u;           // NaN
  if (ax >= 0x477FF000u) return sign | 0x7C00u;          // >= 65520 rounds to inf
  if (ax >= 0x38800000u) {                               // a normal half
    const uint32_t r = ax - 0x38000000u;                 // exponent bias 127 -> 15
    return sign | (uint16_t)((r + 0xFFFu + ((r >> 13) & 1u)) >> 13);
  }
  if (ax < 0x33000000u) return sign;                     // under 2^-25: zero
  const uint32_t shift = 126 - (ax >> 23);               // a subnormal half
  const uint32_t m = (ax & 0x7FFFFFu) | 0x800000u;
  uint32_t q = m >> shift;
  const uint32_t rem = m & ((1u << shift) - 1u);
  const uint32_t half = 1u << (shift - 1);
  if (rem > half || (rem == half && (q & 1u))) ++q;
  return sign | (uint16_t)q;
}

// grad readers: G is the stored type, load() its exact fp32 value
struct GradF32 {
  using T = float;
  static inline float load(T g) { return g; }
};
struct GradBF16 {
  using T = uint16_t;
  static inline float load(T g) { return bf16_to_fp32(g); }
};
struct GradF16 {
  using T = uint16_t;
  static inline float load(T g) { return fp16_to_fp32(g); }
};

// output writers: the compute-dtype copy of the updated parameter
struct OutNone {
  using T = uint16_t;
  static constexpr bool kWrite = false;
  static inline T store(float) { return 0; }
};
struct OutBF16 {
  using T = uint16_t;
  static constexpr bool kWrite = true;
  static inline T store(float p) { return fp32_to_bf16_rne(p); }
};
struct OutF16 {
  using T = uint16_t;
  static constexpr bool kWrite = true;
  static inline T store(float p) { return fp32_to_fp16_rne(p); }
};

constexpr int64_t kSerialBelow = 1 << 16;

// One Adam/AdamW step over a flat fp32 buffer, state updated in place.
//   adamw != 0    -> decoupled weight decay: p -= lr * (m_hat/denom + wd * p)
//   adamw == 0    -> classic L2 Adam (torch.optim.Adam): wd*p is folded into the
//                    gradient BEFORE the moment updates, no separate decay term
//   bias_correction != 0 -> m_hat = m/(1-b1^t), v_hat = v/(1-b2^t)
//   grad_scale    -> g[i] is multiplied by this before use (fuses loss-scale
//                    unscaling + gradient clipping into the update pass)
template <class G, class O>
void adam_step(float* __restrict__ p, const typename G::T* __restrict__ g,
               float* __restrict__ m, float* __restrict__ v,
               typename O::T* __restrict__ out, int64_t n, int32_t step, float lr,
               float beta1, float beta2, float eps, float weight_decay, float grad_scale,
               int32_t adamw, int32_t bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - powf(beta1, (float)step);
    bc2 = 1.0f - powf(beta2, (float)step);
  }
  const float inv_bc1 = 1.0f / bc1;
  const float inv_sqrt_bc2 = 1.0f / sqrtf(bc2);
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  // branchless mode select keeps the loop auto-vectorizable
  const float l2_factor = adamw ? 0.0f : weight_decay;        // into the gradient
  const float wd_factor = adamw ? lr * weight_decay : 0.0f;   // decoupled decay

  // a region under kSerialBelow elements runs on the calling thread alone: a
  // thread team's start and barrier cost more than such a region's work, and
  // the engine's small leaves (biases, LayerNorm) are many
#pragma omp parallel for simd schedule(static) if (n >= kSerialBelow)
  for (int64_t i = 0; i < n; ++i) {
    const float grad = grad_scale * G::load(g[i]) + l2_factor * p[i];
    const float mi = beta1 * m[i] + omb1 * grad;
    const float vi = beta2 * v[i] + omb2 * grad * grad;
    m[i] = mi;
    v[i] = vi;
    const float denom = sqrtf(vi) * inv_sqrt_bc2 + eps;
    const float update = (mi * inv_bc1) / denom;
    const float pi = p[i] - lr * update - wd_factor * p[i];
    p[i] = pi;
    if (O::kWrite) out[i] = O::store(pi);
  }
}

}  // namespace

extern "C" {

#define DS_ADAM_ARGS                                                                 \
  int64_t n, int32_t step, float lr, float beta1, float beta2, float eps,            \
      float weight_decay, float grad_scale, int32_t adamw, int32_t bias_correction
#define DS_ADAM_PASS \
  n, step, lr, beta1, beta2, eps, weight_decay, grad_scale, adamw, bias_correction

// the JAX package's entries: fp32 grads; the fused one writes the bf16 copy
void ds_adam_step(float* p, const float* g, float* m, float* v, DS_ADAM_ARGS) {
  adam_step<GradF32, OutNone>(p, g, m, v, nullptr, DS_ADAM_PASS);
}

void ds_adam_step_copy(float* p, const float* g, float* m, float* v, uint16_t* out_bf16,
                       DS_ADAM_ARGS) {
  adam_step<GradF32, OutBF16>(p, g, m, v, out_bf16, DS_ADAM_PASS);
}

// the port's entries, ds_adam_step_<grad dtype>_copy_<output dtype>: grads as the
// card keeps them (fp32 when accumulated over micro-batches), output in the compute
// dtype (ds_adam_step_f32_copy_bf16 is ds_adam_step_copy)
#define DS_ADAM_COPY(NAME, G, O, GT)                                                 \
  void NAME(float* p, const GT* g, float* m, float* v, uint16_t* out, DS_ADAM_ARGS) { \
    adam_step<G, O>(p, g, m, v, out, DS_ADAM_PASS);                                  \
  }
DS_ADAM_COPY(ds_adam_step_f32_copy_bf16, GradF32, OutBF16, float)
DS_ADAM_COPY(ds_adam_step_bf16_copy_bf16, GradBF16, OutBF16, uint16_t)
DS_ADAM_COPY(ds_adam_step_f16_copy_bf16, GradF16, OutBF16, uint16_t)
DS_ADAM_COPY(ds_adam_step_f32_copy_f16, GradF32, OutF16, float)
DS_ADAM_COPY(ds_adam_step_bf16_copy_f16, GradBF16, OutF16, uint16_t)
DS_ADAM_COPY(ds_adam_step_f16_copy_f16, GradF16, OutF16, uint16_t)

// the number of threads an OpenMP region of the calling thread gets, and a way to
// set it (the host step's scaling is measured against it)
int32_t ds_adam_threads(void) {
  int32_t n = 1;
#pragma omp parallel
  {
#pragma omp single
    n = (int32_t)omp_get_num_threads();
  }
  return n;
}

void ds_adam_set_threads(int32_t n) { omp_set_num_threads(n); }

}  // extern "C"
