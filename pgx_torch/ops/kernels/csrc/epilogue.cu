// Kernels A and B: the conv-block epilogue over NHWC rows.
//
// A, bias_pixelnorm_lrelu, replaces pgx/ops/pallas/epilogue.py:_forward
// (body _fwd_kernel):   a = y + b;  out = lrelu(a * rsqrt(mean_c(a^2) + eps))
// B, pixel_norm_lrelu, replaces pgx/ops/pallas/kernels.py:pixel_norm_lrelu_pallas
// (body _pn_lrelu_kernel): the same with no bias.
// A's backward (rownorm_bwd_kernel) is further down.
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

// ---------------------------------------------------------------------------
// Kernel A's backward: the transposed tangent rule, one pass over y and g.
//
// Replaces the plain torch ops of rownorm_lrelu_backward + the db sum (pgx
// differentiates A through the transpose of epilogue.py:_jvp_rule, plain jnp
// that XLA fuses).  Per row, with a = y + b (in y's dtype, then f32),
// s = lrelu's slope at a, r = rsqrt(mean(a^2) + eps), m = mean(s g a):
//     dy = r s g - r^3 m a,        db = sum over rows of dy (f32)
// Bound: bytes (read y and g, write dy: 1.5x the forward's traffic).  Design
// as the forward: one warp owns one row in registers, both row sums by warp
// shuffle.  A block's warps walk rows with a stride and each lane keeps the
// f32 column sums of its channels in registers; the block writes them to
// its row of a [blocks][C] scratch, which a second kernel sums in a fixed
// order (no atomics: db is the same from run to run).
// ---------------------------------------------------------------------------

constexpr int kBwdMaxBlocks = 1024;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rownorm_bwd_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                   const T* __restrict__ g, T* __restrict__ dy,
                   float* __restrict__ db_partial, int64_t rows, int c,
                   float slope, float eps) {
  constexpr int V = VecWidth<T>::N;
  constexpr int kMaxVec = kMaxC / (32 * V);
  __shared__ float colsum[kRowsPerBlock][kMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = c / V;
  const float inv_c = 1.f / c;

  float bv[kMaxVec][V], dbs[kMaxVec][V];
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = lane + 32 * j;
    uint4 braw = make_uint4(0, 0, 0, 0);
    if (v < nvec) braw = reinterpret_cast<const uint4*>(bias)[v];
    const T* be = reinterpret_cast<const T*>(&braw);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      bv[j][k] = pgx::to_f(be[k]);
      dbs[j][k] = 0.f;
    }
  }

  for (int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + warp; row < rows;
       row += (int64_t)gridDim.x * kRowsPerBlock) {
    const uint4* ysrc = reinterpret_cast<const uint4*>(y + row * c);
    const uint4* gsrc = reinterpret_cast<const uint4*>(g + row * c);
    float a[kMaxVec][V], dpn[kMaxVec][V];
    float ssq = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int v = lane + 32 * j;
      uint4 yraw = make_uint4(0, 0, 0, 0), graw = make_uint4(0, 0, 0, 0);
      if (v < nvec) {
        yraw = ysrc[v];
        graw = gsrc[v];
      }
      const T* ye = reinterpret_cast<const T*>(&yraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        // y + b in the input type, as the forward takes it
        const float t = pgx::to_f(pgx::from_f<T>(pgx::to_f(ye[k]) + bv[j][k]));
        const float d = (t < 0.f ? slope : 1.f) * pgx::to_f(ge[k]);
        a[j][k] = t;
        dpn[j][k] = d;
        ssq += t * t;
        dot += d * t;
      }
    }
    ssq = pgx::warp_sum(ssq);
    dot = pgx::warp_sum(dot);
    const float r = rsqrtf(ssq * inv_c + eps);
    const float r3m = r * r * r * (dot * inv_c);
    uint4* dst = reinterpret_cast<uint4*>(dy + row * c);
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float da = r * dpn[j][k] - r3m * a[j][k];
          dbs[j][k] += da;
          e[k] = pgx::from_f<T>(da);
        }
        dst[v] = raw;
      }
    }
  }

  // the block's column sums: warps in a fixed order
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) colsum[warp][v * V + k] = dbs[j][k];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) s += colsum[w][col];
    db_partial[(int64_t)blockIdx.x * c + col] = s;
  }
}

// db[col] = sum over blocks of db_partial[block][col], written to row 0 of
// the scratch.  A block of 32 x 32 threads owns 32 columns: thread (x, y)
// sums blocks y, y + 32, ... of column x, then column x's 32 partial sums are
// added in order of y.
__global__ void __launch_bounds__(1024)
rownorm_bwd_colsum_kernel(float* __restrict__ db_partial, int nblocks, int c) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < c)
    for (int b = threadIdx.y; b < nblocks; b += 32)
      s += db_partial[(int64_t)b * c + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 32; ++y) t += part[y][threadIdx.x];
    db_partial[col] = t;
  }
}

int bwd_blocks(int64_t rows) {
  const int64_t want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return (int)(want < kBwdMaxBlocks ? want : kBwdMaxBlocks);
}

template <typename T>
int launch_bwd(const void* y, const void* b, const void* g, void* dy,
               float* db_partial, int64_t rows, int c, float slope, float eps,
               cudaStream_t stream) {
  const int blocks = bwd_blocks(rows);
  if (blocks == 0) return (int)cudaSuccess;
  rownorm_bwd_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      (const T*)y, (const T*)b, (const T*)g, (T*)dy, db_partial, rows, c,
      slope, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rownorm_bwd_colsum_kernel<<<(c + 31) / 32, dim3(32, 32), 0, stream>>>(
      db_partial, blocks, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the [blocks][C] f32 scratch that pgx_bias_pixelnorm_lrelu_bwd
// takes for `rows` rows.
extern "C" int pgx_bias_pixelnorm_lrelu_bwd_blocks(int64_t rows) {
  return bwd_blocks(rows);
}

// Kernel A's backward for the cotangent g of its output: dy (y's dtype, y's
// shape) and db (f32, C values), left in row 0 of db_partial.  y, b, g share
// one dtype.
extern "C" int pgx_bias_pixelnorm_lrelu_bwd(const void* y, const void* b,
                                            const void* g, void* dy_out,
                                            void* db_partial, int64_t rows,
                                            int c, int dtype, float slope,
                                            float eps, void* stream) {
  if (c <= 0 || c > kMaxC || c % 8 != 0 || b == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return launch_bwd<float>(y, b, g, dy_out, (float*)db_partial, rows, c,
                             slope, eps, s);
  if (dtype == pgx::kBFloat16)
    return launch_bwd<__nv_bfloat16>(y, b, g, dy_out, (float*)db_partial,
                                     rows, c, slope, eps, s);
  return (int)cudaErrorInvalidValue;
}

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
