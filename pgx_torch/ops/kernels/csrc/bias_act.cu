// Kernel E: clamp(gain * act(x + b), -clamp, clamp) over the last (channel)
// axis of an NHWC tensor, for the nine activations of the registry.
//
// Replaces pgx/ops/pallas/kernels.py:bias_act_pallas (body _bias_act_kernel).
//
// Bound: bytes (x read once, out written once; a handful of operations per
// element, one exp or tanh at most).  One elementwise pass: a thread loads
// 16 bytes (4 f32 or 8 bf16), adds the bias of each element's channel
// (index i % C, the bias vector stays in L1), applies the activation chosen
// at compile time from an integer code, scales, clamps, and stores 16 bytes.
// All arithmetic is f32 and the result is rounded once.  Elements past the
// last full vector are handled one by one by the first threads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// activation codes (ActivationSpec.code in pgx_torch/ops/kernels/bias_act.py)
enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu,
           kSoftplus, kSwish };

template <int kAct>
__device__ __forceinline__ float activate(float v, float alpha) {
  if constexpr (kAct == kLinear) return v;
  if constexpr (kAct == kRelu) return fmaxf(v, 0.f);
  if constexpr (kAct == kLrelu) return v >= 0.f ? v : alpha * v;
  if constexpr (kAct == kTanh) return tanhf(v);
  if constexpr (kAct == kSigmoid) return 1.f / (1.f + expf(-v));
  if constexpr (kAct == kElu) return v >= 0.f ? v : expf(v) - 1.f;
  if constexpr (kAct == kSelu)
    return 1.0507009873554805f *
           (v >= 0.f ? v : 1.6732632423543772f * (expf(v) - 1.f));
  if constexpr (kAct == kSoftplus)
    return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  if constexpr (kAct == kSwish) return v / (1.f + expf(-v));
  return v;
}

template <int kAct>
__device__ __forceinline__ float apply(float v, float alpha, float gain,
                                       float clamp) {
  float y = activate<kAct>(v, alpha) * gain;
  if (clamp >= 0.f) y = fminf(fmaxf(y, -clamp), clamp);
  return y;
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                T* __restrict__ out, int64_t n, int c, float alpha,
                float gain, float clamp) {
  constexpr int V = 16 / sizeof(T);
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nvec = n / V;
  if (gid < nvec) {
    uint4 raw = reinterpret_cast<const uint4*>(x)[gid];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
    int ch = (int)((gid * V) % c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = pgx::to_f(e[k]);
      if (bias != nullptr) v += pgx::to_f(bias[ch]);
      r[k] = pgx::from_f<T>(apply<kAct>(v, alpha, gain, clamp));
      if (++ch == c) ch = 0;
    }
    reinterpret_cast<uint4*>(out)[gid] = res;
  }
  const int64_t tail = nvec * V + gid;   // the n % V elements left over
  if (gid < V && tail < n) {
    float v = pgx::to_f(x[tail]);
    if (bias != nullptr) v += pgx::to_f(bias[tail % c]);
    out[tail] = pgx::from_f<T>(apply<kAct>(v, alpha, gain, clamp));
  }
}

template <typename T, int kAct>
int launch(const void* x, const void* b, void* out, int64_t n, int c,
           float alpha, float gain, float clamp, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t threads = n / V > V ? n / V : V;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bias_act_kernel<T, kAct><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)x, (const T*)b, (T*)out, n, c, alpha, gain, clamp);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int act, const void* x, const void* b, void* out, int64_t n,
             int c, float alpha, float gain, float clamp, void* stream) {
  switch (act) {
#define PGX_ACT_CASE(A) \
  case A: return launch<T, A>(x, b, out, n, c, alpha, gain, clamp, stream);
    PGX_ACT_CASE(kLinear)
    PGX_ACT_CASE(kRelu)
    PGX_ACT_CASE(kLrelu)
    PGX_ACT_CASE(kTanh)
    PGX_ACT_CASE(kSigmoid)
    PGX_ACT_CASE(kElu)
    PGX_ACT_CASE(kSelu)
    PGX_ACT_CASE(kSoftplus)
    PGX_ACT_CASE(kSwish)
#undef PGX_ACT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: n elements, channel-last with c channels, contiguous, 16-byte
// aligned; b: c elements of x's type, or null; clamp < 0 means no clamp.
extern "C" int pgx_bias_act(const void* x, const void* b, void* out,
                            int64_t n, int c, int act, float alpha,
                            float gain, float clamp, int dtype,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (c < 1) return (int)cudaErrorInvalidValue;
  if (dtype == pgx::kFloat32)
    return dispatch<float>(act, x, b, out, n, c, alpha, gain, clamp, stream);
  if (dtype == pgx::kBFloat16)
    return dispatch<__nv_bfloat16>(act, x, b, out, n, c, alpha, gain, clamp,
                                   stream);
  return (int)cudaErrorInvalidValue;
}
