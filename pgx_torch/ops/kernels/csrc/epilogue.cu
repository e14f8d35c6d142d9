// Kernels A and B: the conv-block epilogue over NHWC rows.
//
// A, bias_pixelnorm_lrelu, replaces pgx/ops/pallas/epilogue.py:_forward
// (body _fwd_kernel):   a = y + b;  out = lrelu(a * rsqrt(mean_c(a^2) + eps))
// B, pixel_norm_lrelu, replaces pgx/ops/pallas/kernels.py:pixel_norm_lrelu_pallas
// (body _pn_lrelu_kernel): the same with no bias.
//
// Bound: bytes.  Each row of C <= 512 channels is read once and written once;
// the arithmetic is a few operations per element.  Design: one warp owns one
// row, each lane reads 16-byte vectors (8 bf16 or 4 f32) into registers, the
// sum of squares is taken in f32 by warp shuffle, and the row is scaled and
// stored from the same registers, so device memory sees exactly one read and
// one write per element.
#include "common.cuh"

namespace {

constexpr int kMaxC = 512;
constexpr int kRowsPerBlock = 8;  // 8 warps of 32 threads

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rownorm_kernel(const T* __restrict__ y, const T* __restrict__ bias,
               T* __restrict__ out, int64_t rows, int c, float slope,
               float eps) {
  constexpr int V = VecWidth<T>::N;
  constexpr int kMaxVec = kMaxC / (32 * V);  // vectors one lane holds
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int nvec = c / V;
  const uint4* src = reinterpret_cast<const uint4*>(y + row * c);
  const uint4* bsrc = reinterpret_cast<const uint4*>(bias);

  float a[kMaxVec][V];
  float ssq = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
      uint4 raw = src[v];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 braw = make_uint4(0, 0, 0, 0);
      if (bias != nullptr) braw = bsrc[v];
      const T* be = reinterpret_cast<const T*>(&braw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float t = pgx::to_f(e[k]);
        // y + b is taken in the input type, as the reference does
        if (bias != nullptr) t = pgx::to_f(pgx::from_f<T>(t + pgx::to_f(be[k])));
        a[j][k] = t;
        ssq += t * t;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) a[j][k] = 0.f;
    }
  }
  ssq = pgx::warp_sum(ssq);
  const float r = rsqrtf(ssq * (1.f / c) + eps);

  uint4* dst = reinterpret_cast<uint4*>(out + row * c);
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = pgx::from_f<T>(pgx::lrelu(a[j][k] * r, slope));
      dst[v] = raw;
    }
  }
}

template <typename T>
int launch(const void* y, const void* b, void* out, int64_t rows, int c,
           float slope, float eps, void* stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0) {
    rownorm_kernel<T><<<(unsigned)blocks, 32 * kRowsPerBlock, 0,
                        (cudaStream_t)stream>>>(
        (const T*)y, (const T*)b, (T*)out, rows, c, slope, eps);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* y, const void* b, void* out, int64_t rows, int c,
             int dtype, float slope, float eps, void* stream) {
  if (c <= 0 || c > kMaxC || c % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == pgx::kFloat32)
    return launch<float>(y, b, out, rows, c, slope, eps, stream);
  if (dtype == pgx::kBFloat16)
    return launch<__nv_bfloat16>(y, b, out, rows, c, slope, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pgx_bias_pixelnorm_lrelu(const void* y, const void* b,
                                        void* out, int64_t rows, int c,
                                        int dtype, float slope, float eps,
                                        void* stream) {
  if (b == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(y, b, out, rows, c, dtype, slope, eps, stream);
}

extern "C" const char* pgx_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

extern "C" int pgx_pixel_norm_lrelu(const void* x, void* out, int64_t rows,
                                    int c, int dtype, float slope, float eps,
                                    void* stream) {
  return dispatch(x, nullptr, out, rows, c, dtype, slope, eps, stream);
}
