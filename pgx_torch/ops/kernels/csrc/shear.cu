// Kernel F: per-line fractional shift of img[B, C, R, N] (the shear passes of
// the gather-free ADA warp).
//
// Replaces pgx/ops/pallas/shear.py:shift_1d_pallas (bodies _kernel_axis3 and
// _kernel_axis2 over _ladder).  With L the extent of the shifted axis,
//   s = clip(shift, -(L+2), L+2),  k = floor(s),  f = s - k
//   out[x] = (1-f) * in[x+k]   * [0 <= x+k < L]
//          +   f   * in[x+k+1] * [-1 <= x+k < L-1]
// with one shift per (b, r) line along N (axis 3) or per (b, n) column along
// R (axis 2); the blend is taken in f32 and rounded once.  The TPU kernel
// moves the line by a ladder of rotations and selects because its vector
// unit has no indexed read; here the integer part of the shift is an index.
//
// Bound: bytes (the tensor is read once and written once; three operations
// per element).  The input may be a view whose rows are `sr` elements apart
// (the warp's column crop), planes `sb` and `sc`; the output is contiguous.
// The widest unit (16, 8, 4 or 2 bytes) that divides the input's pointer,
// strides and row length is chosen by the wrapper (shear.py:_unit) and
// passed as unit_in.
//
// Axis 3 (shear_cols_kernel): the shift is constant along a line, so a
// thread makes one 16-byte vector of outputs x0 .. x0+V-1 from the two
// aligned 16-byte vectors that hold in[x0+k .. x0+k+V]: the window is cut out
// of them in registers by selects and a funnel shift, no scalar load.  A row
// is either inside [0, N) or outside as a whole vector, so zero fill is per
// vector.  Inputs without 16-byte units take shear_cols_scalar_kernel.
//
// Axis 2 (shear_rows_kernel): each column has its own k, so the taps of
// neighbouring outputs lie in different rows.  A block owns a tile of
// kTileRows output rows x kStrip columns of one image, for every channel in
// turn.  From the strip's shifts it takes kmin and kmax, stages input rows
// [r0 + kmin, r0 + rows + kmax] of the strip in shared memory in unit_in
// copies (cp.async, zeros outside [0, R); the next channel's band is in
// flight while this one is computed), and every output reads its two taps
// there and leaves in unit_out stores, the widest unit the output's row
// length allows.  The band holds kBandRows rows: any |shift slope| <= 2 per
// column fits.  A block whose strip spreads its shifts wider (shifts that
// are no shear) reads its taps from device memory instead.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 32;                         // columns of an axis-2 tile
constexpr int kTileRows = 64;                      // output rows of a tile
constexpr int kBandRows = kTileRows + 2 * kStrip + 2;

__device__ __forceinline__ void clip_floor(float s, float lim, int& k,
                                           float& f) {
  s = fminf(fmaxf(s, -lim), lim);
  const float fl = floorf(s);
  k = (int)fl;
  f = s - fl;
}

// ---- axis 3 -----------------------------------------------------------------

__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// Elements o .. o+V of the 2V elements in w[0..7] (two 16-byte vectors), as
// floats; o in [0, V).
__device__ __forceinline__ void window(const uint32_t (&w)[8], int o,
                                       float (&e)[5]) {  // f32: V = 4
#pragma unroll
  for (int i = 0; i < 5; ++i)
    e[i] = __uint_as_float(pick4(w[i], w[i + 1], w[i + 2], w[i + 3], o));
}

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ void window(const uint32_t (&w)[8], int o,
                                       float (&e)[9]) {  // bf16: V = 8
  const int wo = o >> 1, sh = (o & 1) * 16;
  uint32_t W[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) W[i] = pick4(w[i], w[i + 1], w[i + 2], w[i + 3], wo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t pair = __funnelshift_r(W[i], W[i + 1], sh);
    e[2 * i] = bf16_bits(pair & 0xffffu);
    e[2 * i + 1] = bf16_bits(pair >> 16);
  }
  e[8] = bf16_bits((W[4] >> sh) & 0xffffu);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shear_cols_kernel(const T* __restrict__ img, const float* __restrict__ shift,
                  T* __restrict__ out, int c, int r_ext, int n_ext,
                  int64_t sb, int64_t sc, int64_t sr, int64_t total) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLog = V == 8 ? 3 : 2;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int nvec = n_ext / V;
  const int64_t line = idx / nvec;          // (b, ch, r), r fastest
  const int j = (int)(idx - line * nvec);
  const int r = (int)(line % r_ext);
  const int64_t bc = line / r_ext;
  const int ch = (int)(bc % c), b = (int)(bc / c);
  int k;
  float f;
  clip_floor(shift[(int64_t)b * r_ext + r], (float)n_ext + 2.f, k, f);
  const int p = j * V + k;                  // first tap of the first output
  const int q = p >> kLog, o = p & (V - 1); // floor division, also for p < 0
  const uint4* row = reinterpret_cast<const uint4*>(
      img + (int64_t)b * sb + (int64_t)ch * sc + (int64_t)r * sr);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uint4 v0 = (q >= 0 && q < nvec) ? row[q] : zero;
  const uint4 v1 = (q + 1 >= 0 && q + 1 < nvec) ? row[q + 1] : zero;
  const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  float e[V + 1];
  window(w, o, e);
  uint4 res;
  T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int i = 0; i < V; ++i)
    rv[i] = pgx::from_f<T>((1.f - f) * e[i] + f * e[i + 1]);
  reinterpret_cast<uint4*>(out + line * n_ext)[j] = res;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shear_cols_scalar_kernel(const T* __restrict__ img,
                         const float* __restrict__ shift, T* __restrict__ out,
                         int c, int r_ext, int n_ext, int64_t sb, int64_t sc,
                         int64_t sr, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t line = idx / n_ext;
  const int x = (int)(idx - line * n_ext);
  const int r = (int)(line % r_ext);
  const int64_t bc = line / r_ext;
  const int ch = (int)(bc % c), b = (int)(bc / c);
  int k;
  float f;
  clip_floor(shift[(int64_t)b * r_ext + r], (float)n_ext + 2.f, k, f);
  const T* src = img + (int64_t)b * sb + (int64_t)ch * sc + (int64_t)r * sr;
  const int p = x + k;
  const float a0 = (p >= 0 && p < n_ext) ? pgx::to_f(src[p]) : 0.f;
  const float a1 = (p >= -1 && p < n_ext - 1) ? pgx::to_f(src[p + 1]) : 0.f;
  out[idx] = pgx::from_f<T>((1.f - f) * a0 + f * a1);
}

// ---- axis 2 -----------------------------------------------------------------

// One U-byte unit from device memory into shared memory: cp.async for 4, 8
// and 16 bytes (src_bytes 0 fills zeros and reads nothing), a plain load and
// store for 2.
template <int U>
__device__ __forceinline__ void stage_unit(void* dst, const void* src,
                                           bool inside) {
  if constexpr (U >= 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(U), "r"(inside ? U : 0));
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        inside ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row_lo, row_lo + need) of the strip's `cols` columns into band[][],
// in U-byte units; zeros for rows outside [0, r_ext).
template <typename T, int U>
__device__ __forceinline__ void stage(T (*band)[kStrip], const T* src,
                                      int64_t sr, int row_lo, int need,
                                      int cols, int r_ext) {
  constexpr int EU = U / sizeof(T);
  const int upr = cols / EU;                 // units per staged row
  for (int i = threadIdx.x; i < need * upr; i += kThreads) {
    const int rr = i / upr, uu = i - rr * upr;
    const int row = row_lo + rr;
    const bool inside = row >= 0 && row < r_ext;
    stage_unit<U>(&band[rr][uu * EU],
                  src + (inside ? (int64_t)row * sr + uu * EU : 0), inside);
  }
}

template <typename T>
__device__ __forceinline__ void stage_any(int unit, T (*band)[kStrip],
                                          const T* src, int64_t sr,
                                          int row_lo, int need, int cols,
                                          int r_ext) {
  switch (unit) {
    case 16: stage<T, 16>(band, src, sr, row_lo, need, cols, r_ext); break;
    case 8: stage<T, 8>(band, src, sr, row_lo, need, cols, r_ext); break;
    case 4: stage<T, 4>(band, src, sr, row_lo, need, cols, r_ext); break;
    default: stage<T, (int)sizeof(T)>(band, src, sr, row_lo, need, cols,
                                      r_ext);
  }
}

// A block: one strip of kStrip columns x kTileRows output rows of image b,
// every channel in turn.  The shifts are the same for all channels; channel
// ch + 1's band is staged (cp.async) while channel ch is computed.
template <typename T, int VO>
__global__ void __launch_bounds__(kThreads)
shear_rows_kernel(const T* __restrict__ img, const float* __restrict__ shift,
                  T* __restrict__ out, int c, int r_ext, int n_ext,
                  int64_t sb, int64_t sc, int64_t sr, int unit_in, int strips,
                  int tiles) {
  __shared__ __align__(16) T band[2][kBandRows][kStrip];
  __shared__ int ks[kStrip];
  __shared__ float fs[kStrip];
  __shared__ int krange[2];
  int blk = blockIdx.x;
  const int strip = blk % strips;
  blk /= strips;
  const int tile = blk % tiles;
  const int b = blk / tiles;
  const int n0 = strip * kStrip, r0 = tile * kTileRows;
  const int rows = min(kTileRows, r_ext - r0);
  const int cols = min(kStrip, n_ext - n0);

  if (threadIdx.x < kStrip) {                // one warp: kStrip == 32
    const int jj = threadIdx.x;
    int k = 0;
    float f = 0.f;
    if (jj < cols)
      clip_floor(shift[(int64_t)b * n_ext + n0 + jj], (float)r_ext + 2.f, k,
                 f);
    ks[jj] = k;
    fs[jj] = f;
    const int lo = __reduce_min_sync(0xffffffffu, jj < cols ? k : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, jj < cols ? k : INT_MIN);
    if (jj == 0) {
      krange[0] = lo;
      krange[1] = hi;
    }
  }
  __syncthreads();
  const int kmin = krange[0];
  const int need = rows + (krange[1] - kmin) + 1;  // staged rows
  const bool staged = need <= kBandRows;     // uniform across the block
  const int row_lo = r0 + kmin;
  const T* src0 = img + (int64_t)b * sb + n0;
  T* dst0 = out + ((int64_t)b * c * r_ext + r0) * n_ext + n0;

  // a thread's columns are the same for every row it makes
  constexpr int kGroups = kStrip / VO;       // output vectors per tile row
  const int j0 = (threadIdx.x % kGroups) * VO;
  const bool active = j0 < cols;
  int kk[VO];
  float ff[VO];
#pragma unroll
  for (int e = 0; e < VO; ++e) {
    kk[e] = ks[j0 + e];
    ff[e] = fs[j0 + e];
  }

  if (staged)
    stage_any<T>(unit_in, band[0], src0, sr, row_lo, need, cols, r_ext);
  stage_commit();
  for (int ch = 0; ch < c; ++ch) {
    const T* src = src0 + (int64_t)ch * sc;
    if (staged && ch + 1 < c) {
      stage_any<T>(unit_in, band[(ch + 1) & 1], src + sc, sr, row_lo, need,
                   cols, r_ext);
      stage_commit();
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncthreads();                         // band[ch & 1] is in place
    T(*bd)[kStrip] = band[ch & 1];
    T* dst = dst0 + (int64_t)ch * r_ext * n_ext;
    for (int rr = threadIdx.x / kGroups; active && rr < rows;
         rr += kThreads / kGroups) {
      __align__(16) T vals[VO];
#pragma unroll
      for (int e = 0; e < VO; ++e) {
        const int jj = j0 + e;
        float a0, a1;
        if (staged) {
          const int br = rr + kk[e] - kmin;
          a0 = pgx::to_f(bd[br][jj]);
          a1 = pgx::to_f(bd[br + 1][jj]);
        } else {
          const int p = r0 + rr + kk[e];
          a0 = (p >= 0 && p < r_ext) ? pgx::to_f(src[(int64_t)p * sr + jj])
                                     : 0.f;
          a1 = (p >= -1 && p < r_ext - 1)
                   ? pgx::to_f(src[(int64_t)(p + 1) * sr + jj])
                   : 0.f;
        }
        vals[e] = pgx::from_f<T>((1.f - ff[e]) * a0 + ff[e] * a1);
      }
      T* d = dst + (int64_t)rr * n_ext + j0;
      if constexpr (VO * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(vals);
      } else if constexpr (VO * sizeof(T) == 8) {
        *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(vals);
      } else if constexpr (VO * sizeof(T) == 4) {
        *reinterpret_cast<uint32_t*>(d) =
            *reinterpret_cast<const uint32_t*>(vals);
      } else {
        d[0] = vals[0];
      }
    }
    __syncthreads();                         // before the band is restaged
  }
}

template <typename T, int VO>
int launch_rows(const T* img, const float* shift, T* out, int b, int c,
                int r, int n, int64_t sb, int64_t sc, int64_t sr, int unit_in,
                cudaStream_t stream) {
  const int strips = (n + kStrip - 1) / kStrip;
  const int tiles = (r + kTileRows - 1) / kTileRows;
  const int64_t blocks = (int64_t)strips * tiles * b;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  shear_rows_kernel<T, VO><<<(unsigned)blocks, kThreads, 0, stream>>>(
      img, shift, out, c, r, n, sb, sc, sr, unit_in, strips, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* img_, const void* shift_, void* out_, int b, int c,
           int r, int n, int64_t sb, int64_t sc, int64_t sr, int axis,
           int unit_in, int unit_out, cudaStream_t stream) {
  const T* img = (const T*)img_;
  const float* shift = (const float*)shift_;
  T* out = (T*)out_;
  const int64_t numel = (int64_t)b * c * r * n;
  if (numel == 0) return (int)cudaSuccess;
  const int es = (int)sizeof(T);
  if (unit_in < es || unit_in > 16 || unit_in % es || unit_out < es ||
      unit_out > 16 || unit_out % es)
    return (int)cudaErrorInvalidValue;
  if (axis == 3) {
    const bool vec = unit_in == 16 && n % (16 / es) == 0;
    const int64_t total = vec ? numel / (16 / es) : numel;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    if (vec)
      shear_cols_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
          img, shift, out, c, r, n, sb, sc, sr, total);
    else
      shear_cols_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
          img, shift, out, c, r, n, sb, sc, sr, total);
    return (int)cudaGetLastError();
  }
  switch (unit_out / es) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_rows<T, 8>(img, shift, out, b, c, r, n, sb, sc, sr,
                                 unit_in, stream);
      break;
    case 4:
      return launch_rows<T, 4>(img, shift, out, b, c, r, n, sb, sc, sr,
                               unit_in, stream);
    case 2:
      return launch_rows<T, 2>(img, shift, out, b, c, r, n, sb, sc, sr,
                               unit_in, stream);
    case 1:
      return launch_rows<T, 1>(img, shift, out, b, c, r, n, sb, sc, sr,
                               unit_in, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// img: [b, c, r, n] with element strides (sb, sc, sr, 1); out: [b, c, r, n]
// contiguous; shift: f32 [b, r] (axis 3) or [b, n] (axis 2).  unit_in
// divides img's pointer, sb, sc, sr and n in bytes; unit_out divides n in
// bytes (shear.py:_unit).
extern "C" int pgx_shift_1d(const void* img, const void* shift, void* out,
                            int b, int c, int r, int n, int64_t sb,
                            int64_t sc, int64_t sr, int axis, int dtype,
                            int unit_in, int unit_out, void* stream) {
  if (axis != 2 && axis != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return launch<float>(img, shift, out, b, c, r, n, sb, sc, sr, axis,
                         unit_in, unit_out, s);
  if (dtype == pgx::kBFloat16)
    return launch<__nv_bfloat16>(img, shift, out, b, c, r, n, sb, sc, sr,
                                 axis, unit_in, unit_out, s);
  return (int)cudaErrorInvalidValue;
}

// The axis-2 tile, for shear.py to check its copy: 0 columns (kStrip),
// 1 output rows (kTileRows), 2 staged rows (kBandRows).
extern "C" int pgx_shift_1d_tile(int which) {
  return which == 0 ? kStrip : which == 1 ? kTileRows : kBandRows;
}
