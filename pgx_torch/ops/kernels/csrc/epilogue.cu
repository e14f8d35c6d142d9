// Kernels A and B: the conv-block epilogue over NHWC rows.
//
// A, bias_pixelnorm_lrelu, replaces pgx/ops/pallas/epilogue.py:_forward
// (body _fwd_kernel):   a = y + b;  out = lrelu(a * rsqrt(mean_c(a^2) + eps))
// B, pixel_norm_lrelu, replaces pgx/ops/pallas/kernels.py:pixel_norm_lrelu_pallas
// (body _pn_lrelu_kernel): the same with no bias.
// A's backward (rownorm_bwd_kernel), its second derivative
// (rownorm_bwd2_kernel) and its tangent (rownorm_jvp_kernel) are further down.
//
// Bound: bytes.  Each row of C <= 512 channels is read once and written once;
// the arithmetic is a few operations per element, so the floor is twice the
// row bytes over the memory rate.  Design: a group of LANES lanes owns one
// row, LANES the power of two that covers the row's 16-byte vectors (8 bf16
// or 4 f32), at most a warp, whose lanes then hold as many vectors each as
// the row needs (VECS; registers sized to the row).  So the narrow rows of
// the high resolutions (32-128 channels at 128-512px: 4-16 vectors in bf16)
// keep every lane busy, and a block of kThreads moves kThreads / LANES rows.
// Each lane reads its vectors into registers, the sum of squares is taken in
// f32 by shuffles inside the group, and the row is scaled and stored from
// the same registers, so device memory sees exactly one read and one write
// per element.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxC = 512;
constexpr int kThreads = 256;  // a block of A, B, A's backward and its
                               // second derivative

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// How a row's 16-byte vectors are spread: over a group of LANES lanes,
// VECS vectors a lane (LANES * VECS covers the row)
template <int L, int N> struct Groups {
  static constexpr int LANES = L, VECS = N;
};

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f(Groups<LANES, VECS>()) for a row of c channels: LANES the power of two
// that covers its vectors, a warp above 16, whose lanes then hold as many
// vectors each as the row needs (registers sized to the row, not to kMaxC)
template <typename T, typename F>
int with_groups(int c, F&& f) {
  const int nvec = c / VecWidth<T>::N;
  if (nvec <= 1) return f(Groups<1, 1>());
  if (nvec <= 2) return f(Groups<2, 1>());
  if (nvec <= 4) return f(Groups<4, 1>());
  if (nvec <= 8) return f(Groups<8, 1>());
  if (nvec <= 16) return f(Groups<16, 1>());
  if (nvec <= 32) return f(Groups<32, 1>());
  if constexpr (kMaxC / (32 * VecWidth<T>::N) > 2) {  // f32: up to 4
    if (nvec > 96) return f(Groups<32, 4>());
    if (nvec > 64) return f(Groups<32, 3>());
  }
  return f(Groups<32, 2>());
}

template <typename T, int LANES, int VECS>
__global__ void __launch_bounds__(kThreads)
rownorm_kernel(const T* __restrict__ y, const T* __restrict__ bias,
               T* __restrict__ out, int64_t rows, int c, float slope,
               float eps) {
  constexpr int V = VecWidth<T>::N;
  constexpr int kRows = kThreads / LANES;
  const int lane = threadIdx.x % LANES;
  const int64_t row = (int64_t)blockIdx.x * kRows + threadIdx.x / LANES;
  // rows past the end still take part in the shuffles: no early return
  const bool live = row < rows;
  const int nvec = c / V;
  const uint4* src = reinterpret_cast<const uint4*>(y + row * c);
  const uint4* bsrc = reinterpret_cast<const uint4*>(bias);

  float a[VECS][V];
  float ssq = 0.f;
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int v = lane + LANES * j;
    if (live && v < nvec) {
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
  ssq = group_sum<LANES>(ssq);
  if (!live) return;
  const float r = rsqrtf(ssq * (1.f / c) + eps);

  uint4* dst = reinterpret_cast<uint4*>(out + row * c);
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int v = lane + LANES * j;
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
           float slope, float eps, cudaStream_t stream) {
  return with_groups<T>(c, [&](auto grp) {
    using G = decltype(grp);
    constexpr int kRows = kThreads / G::LANES;
    const int64_t blocks = (rows + kRows - 1) / kRows;
    if (blocks > 0) {
      rownorm_kernel<T, G::LANES, G::VECS>
          <<<(unsigned)blocks, kThreads, 0, stream>>>(
              (const T*)y, (const T*)b, (T*)out, rows, c, slope, eps);
    }
    return (int)cudaGetLastError();
  });
}

int dispatch(const void* y, const void* b, void* out, int64_t rows, int c,
             int dtype, float slope, float eps, void* stream) {
  if (c <= 0 || c > kMaxC || c % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return launch<float>(y, b, out, rows, c, slope, eps, s);
  if (dtype == pgx::kBFloat16)
    return launch<__nv_bfloat16>(y, b, out, rows, c, slope, eps, s);
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
// Bound: bytes (read y and g, write dy: 1.5x the forward's traffic; the
// bias and db are C-wide).  Design: the forward's lane groups, on a grid
// sized to what the card holds at once (blocks a multiprocessor keeps
// resident x the multiprocessors), each group walking rows with the grid's
// stride.  A group loads its next row before the current row's shuffles, so
// two rows' bytes are in flight per group.  Each lane keeps the f32 column
// sums of its vectors in registers.  At the end they are added in a fixed
// order: over a warp's groups by shuffles on the group-index bits, over the
// block's warps in shared memory into the block's row of a [blocks][C]
// scratch, and over the blocks by rownorm_bwd_colsum_kernel (no atomics: db
// is the same from run to run).
// ---------------------------------------------------------------------------

// a group's vectors of one row into registers; zeros past its end and for
// a row that is not live
template <int LANES, typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int64_t row,
                                         int c, bool live, int lane, int nvec,
                                         uint4 (&raw)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int v = lane + LANES * j;
    raw[j] = make_uint4(0, 0, 0, 0);
    if (live && v < nvec) raw[j] = reinterpret_cast<const uint4*>(p + row * c)[v];
  }
}

// The block's row of the [blocks][C] column-sum scratch, from each lane's
// f32 column sums `dbs` of the rows its group walked, in a fixed order: the
// warp's groups by a butterfly on the group-index bits (every lane ends with
// the same sum), then the block's warps in order of their index.  Called by
// every thread of the block.
template <int LANES, int VECS, int V>
__device__ __forceinline__ void block_colsums(float (&dbs)[VECS][V],
                                              float* __restrict__ db_partial,
                                              int c, int nvec) {
  __shared__ float colsum[kThreads / 32][kMaxC];
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        dbs[j][k] += __shfl_xor_sync(0xffffffffu, dbs[j][k], o);
    }
  }
  if (threadIdx.x % 32 < LANES) {
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      const int v = lane + LANES * j;
      if (v < nvec) {
#pragma unroll
        for (int k = 0; k < V; ++k) colsum[warp][v * V + k] = dbs[j][k];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < c; col += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += colsum[w][col];
    db_partial[(int64_t)blockIdx.x * c + col] = s;
  }
}

template <typename T, int LANES, int VECS>
__global__ void __launch_bounds__(kThreads)
rownorm_bwd_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                   const T* __restrict__ g, T* __restrict__ dy,
                   float* __restrict__ db_partial, int64_t rows, int c,
                   float slope, float eps) {
  constexpr int V = VecWidth<T>::N;
  constexpr int kGroups = kThreads / LANES;
  const int lane = threadIdx.x % LANES;
  const int nvec = c / V;
  const float inv_c = 1.f / c;

  float bv[VECS][V], dbs[VECS][V];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int v = lane + LANES * j;
    uint4 braw = make_uint4(0, 0, 0, 0);
    if (v < nvec) braw = reinterpret_cast<const uint4*>(bias)[v];
    const T* be = reinterpret_cast<const T*>(&braw);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      bv[j][k] = pgx::to_f(be[k]);
      dbs[j][k] = 0.f;
    }
  }

  const int64_t stride = (int64_t)gridDim.x * kGroups;
  int64_t row = (int64_t)blockIdx.x * kGroups + threadIdx.x / LANES;
  // the row of the warp's first group: the warp walks while it is live, so
  // every lane takes part in every shuffle (the rows of later groups may
  // already be past the end)
  int64_t lead = row - (threadIdx.x % 32) / LANES;
  uint4 yraw[VECS], graw[VECS];
  load_row<LANES>(y, row, c, row < rows, lane, nvec, yraw);
  load_row<LANES>(g, row, c, row < rows, lane, nvec, graw);
  for (; lead < rows; row += stride, lead += stride) {
    float a[VECS][V], dpn[VECS][V];
    float ssq = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      const T* ye = reinterpret_cast<const T*>(&yraw[j]);
      const T* ge = reinterpret_cast<const T*>(&graw[j]);
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
    // the next row's loads go out before this row's shuffles
    const int64_t next = row + stride;
    load_row<LANES>(y, next, c, next < rows, lane, nvec, yraw);
    load_row<LANES>(g, next, c, next < rows, lane, nvec, graw);
    ssq = group_sum<LANES>(ssq);
    dot = group_sum<LANES>(dot);
    if (row >= rows) continue;  // no shuffle below
    const float r = rsqrtf(ssq * inv_c + eps);
    const float r3m = r * r * r * (dot * inv_c);
    uint4* dst = reinterpret_cast<uint4*>(dy + row * c);
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      const int v = lane + LANES * j;
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

  block_colsums<LANES>(dbs, db_partial, c, nvec);
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

// ---------------------------------------------------------------------------
// Kernel A's second derivative: the backward of A's backward, one pass.
//
// Replaces the plain torch ops of rownorm_lrelu_backward_vjp + the d_b sum
// (pgx differentiates A twice through its custom_jvp's tangent rule,
// pgx/ops/pallas/epilogue.py:80-86, plain jnp that XLA fuses).  For the
// cotangent u = ddy + ddb of A's backward output da (dy = da, db = sum of
// da over the rows), per row with a = y + b (in y's dtype, then f32),
// s = lrelu's slope at a, dpn = s g, r = rsqrt(mean(a^2) + eps) and the
// row means m = mean(dpn a), p = mean(u dpn), q = mean(u a):
//     d_g = s (r u - r^3 q a)
//     d_a = (3 r^5 m q - r^3 p) a - r^3 q dpn - r^3 m u
//     d_y = d_a,  d_b = sum over rows of d_a (f32)
// Bound: bytes (read y, g and ddy, write d_y and d_g: five tensors of the
// row shape; the bias and ddb are C-wide).  Design: A's backward's, with a
// third input and four row sums.  A row goes to a group of LANES lanes
// sized to its 16-byte vectors (VECS a lane, registers sized to the row), so
// the 32-64 channel rows of the 512px stages keep every lane loading.  The
// grid is the blocks the card keeps resident; each group walks rows with
// the grid's stride and issues its next row's y, g and ddy loads before the
// current row's four shuffle chains, so two rows are in flight per group.
// The current row waits as f32 a, s g and u beside the next row's raw
// vectors: no bf16 width spills (ptxas -v; f32 at 64 channels spills 8
// bytes), the widest (512 bf16 channels, two vectors a lane) at one
// resident block an SM.  Every output is rounded once.  d_b as A's
// backward's db: per-lane f32 column sums added in a fixed order
// (block_colsums, then rownorm_bwd_colsum_kernel over the blocks), the same
// bits on every launch.  ddy, ddb, d_y, d_g and the d_b scratch may each be
// null: what is absent is neither read nor written.
// ---------------------------------------------------------------------------

template <typename T, int LANES, int VECS>
__global__ void __launch_bounds__(kThreads)
rownorm_bwd2_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                    const T* __restrict__ g, const T* __restrict__ ddy,
                    const float* __restrict__ ddb, T* __restrict__ d_y,
                    T* __restrict__ d_g, float* __restrict__ db_partial,
                    int64_t rows, int c, float slope, float eps) {
  constexpr int V = VecWidth<T>::N;
  constexpr int kGroups = kThreads / LANES;
  const int lane = threadIdx.x % LANES;
  const int nvec = c / V;
  const float inv_c = 1.f / c;

  // the bias and ddb are the same for every row: kept in registers
  float bv[VECS][V], uv[VECS][V], dbs[VECS][V];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int v = lane + LANES * j;
    uint4 braw = make_uint4(0, 0, 0, 0);
    if (v < nvec) braw = reinterpret_cast<const uint4*>(bias)[v];
    const T* be = reinterpret_cast<const T*>(&braw);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      bv[j][k] = pgx::to_f(be[k]);
      uv[j][k] = (ddb != nullptr && v < nvec) ? ddb[v * V + k] : 0.f;
      dbs[j][k] = 0.f;
    }
  }

  const int64_t stride = (int64_t)gridDim.x * kGroups;
  int64_t row = (int64_t)blockIdx.x * kGroups + threadIdx.x / LANES;
  // the warp walks while its first group's row is live, as A's backward's
  int64_t lead = row - (threadIdx.x % 32) / LANES;
  const bool has_ddy = ddy != nullptr;
  uint4 yraw[VECS], graw[VECS], uraw[VECS];
  load_row<LANES>(y, row, c, row < rows, lane, nvec, yraw);
  load_row<LANES>(g, row, c, row < rows, lane, nvec, graw);
  load_row<LANES>(ddy, row, c, has_ddy && row < rows, lane, nvec, uraw);
  for (; lead < rows; row += stride, lead += stride) {
    float a[VECS][V], dpn[VECS][V], u[VECS][V];
    float ssq = 0.f, msum = 0.f, psum = 0.f, qsum = 0.f;
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      const T* ye = reinterpret_cast<const T*>(&yraw[j]);
      const T* ge = reinterpret_cast<const T*>(&graw[j]);
      const T* ue = reinterpret_cast<const T*>(&uraw[j]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        // y + b in the input type, as the forward takes it
        const float t = pgx::to_f(pgx::from_f<T>(pgx::to_f(ye[k]) + bv[j][k]));
        // ddy + ddb: zero past the row's end, ddy's part zero when absent
        const float uk = pgx::to_f(ue[k]) + uv[j][k];
        const float d = (t < 0.f ? slope : 1.f) * pgx::to_f(ge[k]);
        a[j][k] = t;
        dpn[j][k] = d;
        u[j][k] = uk;
        ssq += t * t;
        msum += d * t;
        psum += uk * d;
        qsum += uk * t;
      }
    }
    // the next row's loads go out before this row's shuffles
    const int64_t next = row + stride;
    load_row<LANES>(y, next, c, next < rows, lane, nvec, yraw);
    load_row<LANES>(g, next, c, next < rows, lane, nvec, graw);
    load_row<LANES>(ddy, next, c, has_ddy && next < rows, lane, nvec, uraw);
    ssq = group_sum<LANES>(ssq);
    msum = group_sum<LANES>(msum);
    psum = group_sum<LANES>(psum);
    qsum = group_sum<LANES>(qsum);
    if (row >= rows) continue;  // no shuffle below
    const float r = rsqrtf(ssq * inv_c + eps);
    const float m = msum * inv_c, p = psum * inv_c, q = qsum * inv_c;
    const float r3 = r * r * r;
    const float r3q = r3 * q, r3m = r3 * m;
    const float coef_a = 3.f * r3 * r * r * m * q - r3 * p;
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      const int v = lane + LANES * j;
      if (v < nvec) {
        uint4 yout, gout;
        T* ye = reinterpret_cast<T*>(&yout);
        T* ge = reinterpret_cast<T*>(&gout);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float s = a[j][k] < 0.f ? slope : 1.f;
          const float da = coef_a * a[j][k] - r3q * dpn[j][k]
                           - r3m * u[j][k];
          dbs[j][k] += da;
          ye[k] = pgx::from_f<T>(da);
          ge[k] = pgx::from_f<T>(s * (r * u[j][k] - r3q * a[j][k]));
        }
        if (d_y != nullptr) reinterpret_cast<uint4*>(d_y + row * c)[v] = yout;
        if (d_g != nullptr) reinterpret_cast<uint4*>(d_g + row * c)[v] = gout;
      }
    }
  }

  if (db_partial == nullptr) return;  // uniform across the block
  block_colsums<LANES>(dbs, db_partial, c, nvec);
}

// The grid of A's backward (kSecond false) or its second derivative (true)
// for `rows` rows in groups of LANES lanes: as many blocks as the card keeps
// resident at once, fewer if the rows fill fewer.  The same on every call
// for one card, width and dtype, which keeps the column sums' order fixed.
template <bool kSecond, typename T, int LANES, int VECS>
int bwd_grid(int64_t rows) {
  static const int per_sm = [] {
    int n = 0;
    if constexpr (kSecond)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rownorm_bwd2_kernel<T, LANES, VECS>, kThreads, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rownorm_bwd_kernel<T, LANES, VECS>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t groups = kThreads / LANES;
  const int64_t want = (rows + groups - 1) / groups;
  const int64_t cap = (int64_t)per_sm * (sms > 0 ? sms : 1);
  return (int)(want < cap ? want : cap);
}

template <bool kSecond, typename T>
int bwd_grid_for(int64_t rows, int c) {
  return with_groups<T>(c, [&](auto grp) {
    using G = decltype(grp);
    return bwd_grid<kSecond, T, G::LANES, G::VECS>(rows);
  });
}

// Rows of the [blocks][C] f32 scratch that A's backward (kSecond false) or
// its second derivative (true) takes for `rows` rows of C channels in
// `dtype` (its grid), or -1 for a width or dtype it does not take.
template <bool kSecond>
int bwd_partials(int64_t rows, int c, int dtype) {
  if (c <= 0 || c > kMaxC || c % 8 != 0) return -1;
  if (dtype == pgx::kFloat32) return bwd_grid_for<kSecond, float>(rows, c);
  if (dtype == pgx::kBFloat16)
    return bwd_grid_for<kSecond, __nv_bfloat16>(rows, c);
  return -1;
}

template <typename T>
int launch_bwd(const void* y, const void* b, const void* g, void* dy,
               float* db_partial, int64_t rows, int c, float slope, float eps,
               cudaStream_t stream) {
  return with_groups<T>(c, [&](auto grp) {
    using G = decltype(grp);
    const int blocks = bwd_grid<false, T, G::LANES, G::VECS>(rows);
    if (blocks == 0) return (int)cudaSuccess;
    rownorm_bwd_kernel<T, G::LANES, G::VECS><<<blocks, kThreads, 0, stream>>>(
        (const T*)y, (const T*)b, (const T*)g, (T*)dy, db_partial, rows, c,
        slope, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    rownorm_bwd_colsum_kernel<<<(c + 31) / 32, dim3(32, 32), 0, stream>>>(
        db_partial, blocks, c);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_bwd2(const void* y, const void* b, const void* g, const void* ddy,
                const float* ddb, void* d_y, void* d_g, float* db_partial,
                int64_t rows, int c, float slope, float eps,
                cudaStream_t stream) {
  return with_groups<T>(c, [&](auto grp) {
    using G = decltype(grp);
    const int blocks = bwd_grid<true, T, G::LANES, G::VECS>(rows);
    if (blocks == 0) return (int)cudaSuccess;
    rownorm_bwd2_kernel<T, G::LANES, G::VECS><<<blocks, kThreads, 0, stream>>>(
        (const T*)y, (const T*)b, (const T*)g, (const T*)ddy, ddb, (T*)d_y,
        (T*)d_g, db_partial, rows, c, slope, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || db_partial == nullptr) return (int)e;
    rownorm_bwd_colsum_kernel<<<(c + 31) / 32, dim3(32, 32), 0, stream>>>(
        db_partial, blocks, c);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// Kernel A's tangent: forward-mode derivative of A in (dy, db), one pass.
//
// Replaces the plain jnp of pgx/ops/pallas/epilogue.py:_jvp_rule, which
// pgx evaluates under jax.jvp (the JVP form of the gradient penalty).  Per
// row, with a = y + b and da = dy + db (each sum in y's dtype, then f32),
// r = rsqrt(mean(a^2) + eps) and m = mean(a da):
//     dpn  = da r - a r^3 m
//     dout = a >= 0 ? dpn : slope dpn            (stored in y's dtype)
// Bound: bytes (read y and dy, write dout; b and db are C-wide).  Design: a
// group of LANES lanes owns one row (LANES the power of two that covers the
// row's 16-byte vectors, at most a warp), so the narrow rows of the high
// resolutions (64 channels at 512px: 8 vectors in bf16) keep every lane of
// a warp busy; 16-byte loads and stores, both row sums by shuffles inside
// the group, the row kept in registers between the sums and the store.
// db may be null (no bias tangent).
// ---------------------------------------------------------------------------

template <typename T, int LANES>
__global__ void __launch_bounds__(256)
rownorm_jvp_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                   const T* __restrict__ dy, const T* __restrict__ dbias,
                   T* __restrict__ dout, int64_t rows, int c, float slope,
                   float eps) {
  constexpr int V = VecWidth<T>::N;
  // a full warp may hold up to kMaxC channels; a narrower group one vector
  // a lane (its LANES covers the row)
  constexpr int kMaxVec = LANES == 32 ? kMaxC / (32 * V) : 1;
  constexpr int kRows = 256 / LANES;
  const int lane = threadIdx.x % LANES;
  const int64_t row = (int64_t)blockIdx.x * kRows + threadIdx.x / LANES;
  // rows past the end still take part in the shuffles: no early return
  const bool live = row < rows;
  const int nvec = c / V;
  const uint4* ysrc = reinterpret_cast<const uint4*>(y + row * c);
  const uint4* dsrc = reinterpret_cast<const uint4*>(dy + row * c);

  float a[kMaxVec][V], da[kMaxVec][V];
  float ssq = 0.f, dot = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = lane + LANES * j;
    uint4 yraw = make_uint4(0, 0, 0, 0), draw = make_uint4(0, 0, 0, 0);
    uint4 braw = make_uint4(0, 0, 0, 0), dbraw = make_uint4(0, 0, 0, 0);
    if (live && v < nvec) {
      yraw = ysrc[v];
      draw = dsrc[v];
      braw = reinterpret_cast<const uint4*>(bias)[v];
      if (dbias != nullptr) dbraw = reinterpret_cast<const uint4*>(dbias)[v];
    }
    const T* ye = reinterpret_cast<const T*>(&yraw);
    const T* de = reinterpret_cast<const T*>(&draw);
    const T* be = reinterpret_cast<const T*>(&braw);
    const T* dbe = reinterpret_cast<const T*>(&dbraw);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      // both sums in the input type, as the reference's rule takes them
      const float t = pgx::to_f(pgx::from_f<T>(pgx::to_f(ye[k]) + pgx::to_f(be[k])));
      float d = pgx::to_f(de[k]);
      if (dbias != nullptr) d = pgx::to_f(pgx::from_f<T>(d + pgx::to_f(dbe[k])));
      a[j][k] = t;
      da[j][k] = d;
      ssq += t * t;
      dot += t * d;
    }
  }
  ssq = group_sum<LANES>(ssq);
  dot = group_sum<LANES>(dot);
  if (!live) return;
  const float inv_c = 1.f / c;
  const float r = rsqrtf(ssq * inv_c + eps);
  const float r3m = r * r * r * (dot * inv_c);

  uint4* dst = reinterpret_cast<uint4*>(dout + row * c);
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = lane + LANES * j;
    if (v < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float dpn = da[j][k] * r - a[j][k] * r3m;
        e[k] = pgx::from_f<T>(a[j][k] >= 0.f ? dpn : slope * dpn);
      }
      dst[v] = raw;
    }
  }
}

// the group width of a row: the power of two that covers its vectors
template <typename T>
int launch_jvp(const void* y, const void* b, const void* dy, const void* db,
               void* dout, int64_t rows, int c, float slope, float eps,
               cudaStream_t stream) {
  return with_groups<T>(c, [&](auto grp) {
    constexpr int L = decltype(grp)::LANES;
    constexpr int kRows = 256 / L;
    const int64_t blocks = (rows + kRows - 1) / kRows;
    if (blocks == 0) return (int)cudaSuccess;
    rownorm_jvp_kernel<T, L><<<(unsigned)blocks, 256, 0, stream>>>(
        (const T*)y, (const T*)b, (const T*)dy, (const T*)db, (T*)dout, rows,
        c, slope, eps);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// Kernel A's tangent for the tangents dy (y's shape) and db (C values, or
// null) of its inputs: dout (y's dtype and shape).  y, b, dy, db and dout
// share one dtype.
extern "C" int pgx_bias_pixelnorm_lrelu_jvp(const void* y, const void* b,
                                            const void* dy, const void* db,
                                            void* dout, int64_t rows, int c,
                                            int dtype, float slope, float eps,
                                            void* stream) {
  if (c <= 0 || c > kMaxC || c % 8 != 0 || b == nullptr || dy == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return launch_jvp<float>(y, b, dy, db, dout, rows, c, slope, eps, s);
  if (dtype == pgx::kBFloat16)
    return launch_jvp<__nv_bfloat16>(y, b, dy, db, dout, rows, c, slope, eps,
                                     s);
  return (int)cudaErrorInvalidValue;
}

// Kernel A's second derivative for the cotangents ddy (y's dtype, y's
// shape) and ddb (f32, C values) of its backward's outputs: d_y and d_g (y's
// dtype and shape) and d_b (f32, C values, left in row 0 of db_partial, a
// [pgx_bias_pixelnorm_lrelu_bwd2_partials(rows, c, dtype)][C] f32 scratch).  y, b, g,
// ddy share one dtype.  ddy or ddb may be null (not both); any of d_y, d_g
// and db_partial may be null, and is then not computed.
extern "C" int pgx_bias_pixelnorm_lrelu_bwd2(
    const void* y, const void* b, const void* g, const void* ddy,
    const void* ddb, void* d_y, void* d_g, void* db_partial, int64_t rows,
    int c, int dtype, float slope, float eps, void* stream) {
  if (c <= 0 || c > kMaxC || c % 8 != 0 || b == nullptr ||
      (ddy == nullptr && ddb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return launch_bwd2<float>(y, b, g, ddy, (const float*)ddb, d_y, d_g,
                              (float*)db_partial, rows, c, slope, eps, s);
  if (dtype == pgx::kBFloat16)
    return launch_bwd2<__nv_bfloat16>(y, b, g, ddy, (const float*)ddb, d_y,
                                      d_g, (float*)db_partial, rows, c, slope,
                                      eps, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the [blocks][C] f32 scratch that pgx_bias_pixelnorm_lrelu_bwd2
// takes for `rows` rows of C channels in `dtype` (its grid), or -1 for a
// width or dtype it does not take.
extern "C" int pgx_bias_pixelnorm_lrelu_bwd2_partials(int64_t rows, int c,
                                                      int dtype) {
  return bwd_partials<true>(rows, c, dtype);
}

// Rows of the [blocks][C] f32 scratch that pgx_bias_pixelnorm_lrelu_bwd
// takes for `rows` rows of C channels in `dtype` (its grid), or -1 for a
// width or dtype it does not take.
extern "C" int pgx_bias_pixelnorm_lrelu_bwd_partials(int64_t rows, int c,
                                                     int dtype) {
  return bwd_partials<false>(rows, c, dtype);
}

// Kernel A's backward for the cotangent g of its output: dy (y's dtype, y's
// shape) and db (f32, C values), left in row 0 of db_partial, a
// [pgx_bias_pixelnorm_lrelu_bwd_partials(rows, c, dtype)][C] f32 scratch.
// y, b, g share one dtype.
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

// An empty kernel: one launch of nothing, the floor under kernel B's time.
__global__ void noop_kernel() {}

extern "C" int pgx_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* pgx_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

extern "C" int pgx_pixel_norm_lrelu(const void* x, void* out, int64_t rows,
                                    int c, int dtype, float slope, float eps,
                                    void* stream) {
  return dispatch(x, nullptr, out, rows, c, dtype, slope, eps, stream);
}
