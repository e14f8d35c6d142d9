// Kernel F: per-line fractional shift of img[B, C, R, N] (the shear passes of
// the gather-free ADA warp).
//
// Replaces pgx/ops/pallas/shear.py:shift_1d_pallas (bodies _kernel_axis3 and
// _kernel_axis2 over _ladder).  With L the extent of the shifted axis,
//   s = clip(shift, -(L+2), L+2),  k = floor(s),  f = s - k
//   out[x] = (1-f) * in[x+k]   * [0 <= x+k < L]
//          +   f   * in[x+k+1] * [-1 <= x+k < L-1]
// with one shift per (b, r) line along N (axis 3) or per (b, n) column along
// R (axis 2); the blend is taken in f32 and rounded once.
//
// Bound: bytes (the tensor is read once and written once; three operations
// per element).  The TPU kernel moves the line by a ladder of rotations and
// selects because its vector unit has no indexed read; here the integer part
// of the shift is an index.  One kernel with strides serves both axes: a
// thread owns kVec neighbouring positions along N of one row r for every
// channel (threads laid over rows and positions flattened), so reads and
// writes run along N for either axis and no transpose is needed at any
// extent.  For axis 3 the two taps are x+k and x+k+1 of the
// same row; for axis 2 they are rows r+k and r+k+1 at the same column, where
// neighbouring columns have neighbouring k.  Each output vector is stored
// with one 16-byte (f32) or 8-byte (bf16) store; the second tap of a thread
// is the first tap of its neighbour and comes from L1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
shift_kernel(const T* __restrict__ img, const float* __restrict__ shift,
             T* __restrict__ out, int c, int r_ext, int n_ext, int axis) {
  // threads run over (r, n / kVec) flattened, so a narrow N still fills
  // its blocks
  const unsigned nvec = (unsigned)(n_ext + kVec - 1) / kVec;
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= nvec * (unsigned)r_ext) return;
  const int r = (int)(idx / nvec);
  const int n0 = (int)(idx - (unsigned)r * nvec) * kVec;
  const int b = blockIdx.y;
  const int len = axis == 3 ? n_ext : r_ext;
  const float lim = (float)len + 2.f;

  int k[kVec];
  float f[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float s = axis == 3 ? shift[(int64_t)b * r_ext + r]
                        : shift[(int64_t)b * n_ext + n0 + j];
    s = fminf(fmaxf(s, -lim), lim);
    const float fl = floorf(s);
    k[j] = (int)fl;
    f[j] = s - fl;
  }

  const int64_t plane = (int64_t)r_ext * n_ext;
  const int64_t tap_stride = axis == 3 ? 1 : n_ext;
  for (int ch = 0; ch < c; ++ch) {
    const T* src = img + ((int64_t)b * c + ch) * plane;
    __align__(16) T vals[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // p: position of the first tap along the shifted axis
      const int p = (axis == 3 ? n0 + j : r) + k[j];
      const int64_t at = axis == 3 ? (int64_t)r * n_ext + p
                                   : (int64_t)p * n_ext + n0 + j;
      float a0 = 0.f, a1 = 0.f;
      if (p >= 0 && p < len) a0 = pgx::to_f(src[at]);
      if (p >= -1 && p < len - 1) a1 = pgx::to_f(src[at + tap_stride]);
      vals[j] = pgx::from_f<T>((1.f - f[j]) * a0 + f[j] * a1);
    }
    T* dst = out + ((int64_t)b * c + ch) * plane + (int64_t)r * n_ext + n0;
    if constexpr (kVec == 1) {
      dst[0] = vals[0];
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    } else {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(vals);
    }
  }
}

template <typename T>
int launch(const void* img, const void* shift, void* out, int b, int c, int r,
           int n, int axis, void* stream) {
  if ((int64_t)b * c * r * n == 0) return (int)cudaSuccess;
  if (b > 65535 || (int64_t)r * n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // vector stores need every row to start on a vector boundary
  const bool vec = n % 4 == 0;
  const int64_t per_image = (int64_t)r * (vec ? n / 4 : n);
  dim3 grid((unsigned)((per_image + kThreads - 1) / kThreads), b);
  if (vec) {
    shift_kernel<T, 4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)shift, (T*)out, c, r, n, axis);
  } else {
    shift_kernel<T, 1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const float*)shift, (T*)out, c, r, n, axis);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// img, out: [b, c, r, n] contiguous; shift: f32 [b, r] (axis 3) or [b, n]
// (axis 2).
extern "C" int pgx_shift_1d(const void* img, const void* shift, void* out,
                            int b, int c, int r, int n, int axis, int dtype,
                            void* stream) {
  if (axis != 2 && axis != 3) return (int)cudaErrorInvalidValue;
  if (dtype == pgx::kFloat32)
    return launch<float>(img, shift, out, b, c, r, n, axis, stream);
  if (dtype == pgx::kBFloat16)
    return launch<__nv_bfloat16>(img, shift, out, b, c, r, n, axis, stream);
  return (int)cudaErrorInvalidValue;
}
