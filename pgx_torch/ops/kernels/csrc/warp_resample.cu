// Kernel W: the resampling passes of the gather-free ADA shear warp
// (pgx_torch/ops/warp.py, passes 0 + 1 and pass 4) as bands.
//
// Replaces no TPU kernel: pgx/ops/warp.py applies these passes as dense
// matrix products over matrices built at every call (tent x up-filter) and
// leaves them to XLA.  Each output reads at most 7 input pixels per axis, so
// here they run as bands.
//
// W1 (resample_kernel), passes 0 and 1 with the reflect pad folded in.  The
// image b is square (H x H, C channels, NHWC).  The pipe pads it by H - 1 on
// every side (numpy's "reflect"; n_pad = 3H - 2 pixels an axis), transposes
// the padded image P where the sample's swap is set, and resamples it on a
// grid of vy x vx points at twice the padded rate:
//   out[b, c, n, m] = sum_{h,w} Y[n, h] X[m, w] P[h, w, c]
//   X[m, w] = sum_k tent(u_x(m) - kc(k)) U[k, w]
// u_x(m) = sx (m - (vx/2 - 1/2)) + t_x is the output's position on the 2x
// grid of the padded axis (2 n_pad points at kc(k) = k - (n_pad - 1/2), zero
// outside); U is the sym6 up-by-2 filter with gain 2 (tap ks, weight
// 2 hz[11 - ks], reads padded pixel (k + ks - 6) / 2 where that is whole and
// inside the axis).  Two tent taps and six filter taps of matching parity
// touch at most 7 consecutive padded pixels (band()).  Y likewise with sy,
// t_y and vy.  The tent's weights are the f32 differences the plain version
// takes, so kernel and plain version weigh alike to the bit.
//
// Bound: bytes, the output written once (B C vy vx elements); the image
// (B H H C) is read from L2 about (1 + 7/16)^2 times.
//
// Design: a block makes a tile of kTileN x kTileM outputs of one image, every
// channel.  Warp 0 computes the tile's column bands, warp 1 its row bands;
// from their extremes the block stages the padded patch the tile reads
// (reflection and swap resolved at the load) in shared memory as f32,
// resamples the patch's rows along x into shared memory (patch rows x kTileM
// x C), and each output sums its 7 rows of those.  f32 throughout and one
// rounding at the store.  A tile whose patch exceeds kMaxRows x kMaxCols (a
// scale beyond about 2.3) sums its 7 x 7 taps from device memory instead.
//
// W1's transpose (resample_t_kernel), gather form.  A block owns a tile of
// kImg x kImg image pixels.  A pixel's gradient sums the padded plane's
// gradient at its at most 3 x 3 mirrored positions, so the block walks the
// 3 x 3 regions (per axis the centre and the two mirrors): for each, the
// padded rectangle its pixels map to, and that rectangle's gradient from the
// outputs whose bands reach it, staged kChunk x kChunk at a time in shared
// memory, summed along x and then along y with the forward's band weights.
// No atomics, and the order of every sum is fixed.  Bound: bytes, the
// output gradient read once.
//
// W2 (down2_kernel), pass 4: the static sym6 down-by-2 on both axes,
//   out[b, y, x, c] = sum_{i,j} hz[i] hz[j] v[b, c, 2y+1+i, 2x+1+j],
// reading the y-shear's row crop in place through its strides and writing
// NHWC.  A block stages the input window of a kDnY x kDnX tile per channel
// and filters along x, then y, in shared memory.  Its transpose
// (down2_t_kernel) stages the gradient window of a kUpR x kUpS tile once and
// gathers the 6 x 6 outputs each input position feeds.  Bound: bytes (the
// larger side read or written once, the other a quarter of it).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 12;        // sym6
constexpr int kBand = 7;         // padded pixels an output reads per axis
constexpr int kMaxC = 3;

// W1: output tile, largest staged patch
constexpr int kTileN = 32, kTileM = 32;
constexpr int kMaxRows = 44, kMaxCols = 44;
// W1's transpose: image tile, outputs staged per axis at once
constexpr int kImg = 16, kChunk = 64;
// W2: output tile and its input window
constexpr int kDnY = 16, kDnX = 32;
constexpr int kDnRows = 2 * kDnY + kTaps - 2, kDnCols = 2 * kDnX + kTaps - 2;
// W2's transpose: gradient tile and its input window
constexpr int kUpR = 32, kUpS = 64;
constexpr int kUpY = kUpR / 2 + kTaps / 2, kUpX = kUpS / 2 + kTaps / 2;

struct Filter {
  float h[kTaps];
};

// numpy's "reflect" of padded index j (pad on each side of n pixels, pad < n)
__device__ __forceinline__ int reflect(int j, int pad, int n) {
  int x = j - pad;
  x = x < 0 ? -x : x;
  return x >= n ? 2 * (n - 1) - x : x;
}

// the output's position on the padded axis's 2x grid, centred: the plain
// version's s * centred(i) + t, multiplied and added apart as torch does
__device__ __forceinline__ float position(float s, float t, int i, int n_out) {
  return __fadd_rn(__fmul_rn(s, (float)i - (0.5f * n_out - 0.5f)), t);
}

// The band of an output at position u: the 7 padded pixels base .. base + 6
// and their weights (zero outside [0, n_pad)).  up.h[ks] = 2 hz[11 - ks].
__device__ __forceinline__ void band(float u, int n_pad, const Filter& up,
                                     int& base, float (&w)[kBand]) {
  const float off = (float)n_pad - 0.5f;           // kc(k) = k - off
  // beyond the grid by more than a tap every weight is zero
  u = fminf(fmaxf(u, -off - 8.f), off + 8.f);
  int k0 = (int)floorf(u + off);
  // kc(k0) <= u < kc(k0) + 1 in the f32 differences the weights use
  if (u - ((float)k0 - off) < 0.f) --k0;
  else if (u - ((float)k0 - off) >= 1.f) ++k0;
  const float a = (k0 >= 0 && k0 < 2 * n_pad)
                      ? fmaxf(1.f - fabsf(u - ((float)k0 - off)), 0.f) : 0.f;
  const float c = (k0 + 1 >= 0 && k0 + 1 < 2 * n_pad)
                      ? fmaxf(1.f - fabsf(u - ((float)(k0 + 1) - off)), 0.f)
                      : 0.f;
  const int q = k0 >> 1;                           // floor(k0 / 2)
  if ((k0 & 1) == 0) {   // k0 = 2q reads q-3+j (tap 2j), k0+1 q-2+j (2j+1)
    base = q - 3;
#pragma unroll
    for (int i = 0; i < kBand; ++i)
      w[i] = (i < 6 ? a * up.h[2 * i] : 0.f) +
             (i > 0 ? c * up.h[2 * i - 1] : 0.f);
  } else {               // k0 = 2q+1 reads q-2+j (tap 2j+1), k0+1 too (2j)
    base = q - 2;
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] = a * up.h[2 * i + 1] + c * up.h[2 * i];
    w[6] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kBand; ++i)
    if (base + i < 0 || base + i >= n_pad) w[i] = 0.f;
}

// Outputs [lo, hi] (hi < lo: none) of an axis of n_out whose bands can reach
// padded pixels [p_lo, p_hi]: k0 in [2 p_lo - 6, 2 p_hi + 6], i.e. u + off in
// [2 p_lo - 6, 2 p_hi + 7); two outputs of margin each side for rounding.
__device__ __forceinline__ void touching(float s, float t, int p_lo, int p_hi,
                                         int n_out, int n_pad, int& lo,
                                         int& hi) {
  const float off = (float)n_pad - 0.5f, cm = 0.5f * n_out - 0.5f;
  const float e0 = (2.f * p_lo - 6.f - off - t) / s + cm;
  const float e1 = (2.f * p_hi + 7.f - off - t) / s + cm;
  const float l = fminf(fmaxf(fminf(e0, e1) - 2.f, 0.f), (float)n_out);
  const float r = fmaxf(fminf(fmaxf(e0, e1) + 2.f, (float)(n_out - 1)), -1.f);
  lo = (int)floorf(l);
  hi = (int)ceilf(r);
}

// The padded positions of pixels [a0, a0 + na) in region r (0: the image,
// 1: the mirror before it, 2: the one after), as an interval; false if none.
__device__ __forceinline__ bool region(int r, int a0, int na, int pad, int n,
                                       int& lo, int& hi) {
  const int a1 = a0 + na - 1;
  if (r == 0) {
    lo = pad + a0;
    hi = pad + a1;
    return true;
  }
  if (r == 1) {                                    // pad - a, for a >= 1
    lo = pad - a1;
    hi = pad - max(a0, 1);
    return a1 >= 1;
  }
  lo = 3 * pad - min(a1, n - 2);                   // 3 pad - a, a <= n - 2
  hi = 3 * pad - a0;
  return a0 <= n - 2;
}

// pixel a's padded position in region r, or -1
__device__ __forceinline__ int mirrored(int r, int a, int pad, int n) {
  if (r == 0) return pad + a;
  if (r == 1) return a >= 1 ? pad - a : -1;
  return a <= n - 2 ? 3 * pad - a : -1;
}

// ---- W1 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const T* __restrict__ img, const float* __restrict__ params,
                T* __restrict__ out, int n, int c, int vy, int vx,
                int tiles_m, int tiles_n, Filter up) {
  __shared__ float patch[kMaxRows * kMaxCols * kMaxC];
  __shared__ float xs[kMaxRows * kTileM * kMaxC];
  __shared__ float wx[kTileM][kBand], wy[kTileN][kBand];
  __shared__ int bx[kTileM], by[kTileN];
  __shared__ int ext[4];             // first, last padded column; row
  int blk = blockIdx.x;
  const int tm = blk % tiles_m;
  blk /= tiles_m;
  const int tn = blk % tiles_n;
  const int b = blk / tiles_n;
  const int m0 = tm * kTileM, n0 = tn * kTileN;
  const int pad = n - 1, n_pad = 3 * n - 2;
  const float* p = params + 5 * b;
  const bool swap = p[0] != 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 2) {                    // kTileM == kTileN == 32: a lane each
    const bool along_x = warp == 0;
    const int n_out = along_x ? vx : vy;
    const int i = (along_x ? m0 : n0) + lane;
    const bool inside = i < n_out;
    int base = 0;
    float w[kBand];
    band(position(along_x ? p[1] : p[2], along_x ? p[3] : p[4], i, n_out),
         n_pad, up, base, w);
#pragma unroll
    for (int k = 0; k < kBand; ++k) {
      if (!inside) w[k] = 0.f;
      (along_x ? wx : wy)[lane][k] = w[k];
    }
    (along_x ? bx : by)[lane] = base;
    const int lo = __reduce_min_sync(0xffffffffu, inside ? base : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu,
                                     inside ? base + kBand - 1 : INT_MIN);
    if (lane == 0) {
      ext[along_x ? 0 : 2] = lo;
      ext[along_x ? 1 : 3] = hi;
    }
  }
  __syncthreads();
  const int c0 = max(ext[0], 0), r0 = max(ext[2], 0);
  const int ncol = max(min(ext[1], n_pad - 1) - c0 + 1, 0);
  const int nrow = max(min(ext[3], n_pad - 1) - r0 + 1, 0);
  const T* src = img + (int64_t)b * n * n * c;
  T* dst = out + (int64_t)b * c * vy * vx;

  if (ncol > kMaxCols || nrow > kMaxRows) {       // uniform: no staging
    for (int idx = threadIdx.x; idx < kTileN * kTileM; idx += kThreads) {
      const int mm = idx % kTileM, nn = idx / kTileM;
      const int m = m0 + mm, r = n0 + nn;
      if (m >= vx || r >= vy) continue;
      float acc[kMaxC] = {0.f, 0.f, 0.f};
      for (int i = 0; i < kBand; ++i) {
        const int ph = by[nn] + i;
        if (wy[nn][i] == 0.f) continue;            // also every ph outside
        for (int j = 0; j < kBand; ++j) {
          const int pw = bx[mm] + j;
          if (wx[mm][j] == 0.f) continue;
          const int iy = reflect(swap ? pw : ph, pad, n);
          const int ix = reflect(swap ? ph : pw, pad, n);
          const float wgt = wy[nn][i] * wx[mm][j];
          const T* px = src + ((int64_t)iy * n + ix) * c;
#pragma unroll
          for (int ch = 0; ch < kMaxC; ++ch)
            if (ch < c) acc[ch] += wgt * pgx::to_f(px[ch]);
        }
      }
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch)
        if (ch < c)
          dst[((int64_t)ch * vy + r) * vx + m] = pgx::from_f<T>(acc[ch]);
    }
    return;
  }

  // the patch: padded rows r0 .. r0 + nrow - 1, columns c0 .. c0 + ncol - 1;
  // consecutive threads take consecutive image columns (rows when swapped)
  const int total = nrow * ncol * c;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int ch = idx % c, rest = idx / c;
    int rr, cc;
    if (swap) {
      rr = rest % nrow;
      cc = rest / nrow;
    } else {
      cc = rest % ncol;
      rr = rest / ncol;
    }
    const int ph = r0 + rr, pw = c0 + cc;
    const int iy = reflect(swap ? pw : ph, pad, n);
    const int ix = reflect(swap ? ph : pw, pad, n);
    patch[(rr * ncol + cc) * c + ch] =
        pgx::to_f(src[((int64_t)iy * n + ix) * c + ch]);
  }
  __syncthreads();
  // along x: every patch row at the tile's columns
  for (int idx = threadIdx.x; idx < nrow * kTileM; idx += kThreads) {
    const int mm = idx % kTileM, rr = idx / kTileM;
    float acc[kMaxC] = {0.f, 0.f, 0.f};
    const int cb = bx[mm] - c0;
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
      const int cc = cb + i;
      if (cc < 0 || cc >= ncol) continue;
      const float wgt = wx[mm][i];
      const float* px = &patch[(rr * ncol + cc) * c];
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch)
        if (ch < c) acc[ch] += wgt * px[ch];
    }
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
      if (ch < c) xs[(rr * kTileM + mm) * c + ch] = acc[ch];
  }
  __syncthreads();
  // along y: each output its 7 rows
  for (int idx = threadIdx.x; idx < kTileN * kTileM; idx += kThreads) {
    const int mm = idx % kTileM, nn = idx / kTileM;
    const int m = m0 + mm, r = n0 + nn;
    if (m >= vx || r >= vy) continue;
    float acc[kMaxC] = {0.f, 0.f, 0.f};
    const int rb = by[nn] - r0;
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
      const int rr = rb + i;
      if (rr < 0 || rr >= nrow) continue;
      const float wgt = wy[nn][i];
      const float* px = &xs[(rr * kTileM + mm) * c];
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch)
        if (ch < c) acc[ch] += wgt * px[ch];
    }
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
      if (ch < c)
        dst[((int64_t)ch * vy + r) * vx + m] = pgx::from_f<T>(acc[ch]);
  }
}

// ---- W1's transpose ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
resample_t_kernel(const T* __restrict__ grad, const float* __restrict__ params,
                  T* __restrict__ out, int n, int c, int vy, int vx, int tiles,
                  Filter up) {
  __shared__ float sg[kChunk][kChunk + 1];
  __shared__ float z[kChunk][kImg + 1];
  __shared__ float wx[kChunk][kBand], wy[kChunk][kBand];
  __shared__ int bx[kChunk], by[kChunk];
  __shared__ int reach[kImg][2];     // outputs reaching a rectangle column
  __shared__ float gp[kMaxC][kImg][kImg + 1];
  int blk = blockIdx.x;
  const int tile_x = blk % tiles;
  blk /= tiles;
  const int tile_y = blk % tiles;
  const int b = blk / tiles;
  const int pad = n - 1, n_pad = 3 * n - 2;
  const float* p = params + 5 * b;
  const bool swap = p[0] != 0.f;
  const float sx = p[1], sy = p[2], t_x = p[3], t_y = p[4];
  const int ty = threadIdx.x / kImg, tx = threadIdx.x % kImg;
  const int y0 = tile_y * kImg, x0 = tile_x * kImg;
  const int y = y0 + ty, x = x0 + tx;
  // the padded plane's rows come from image axis a, its columns from e
  const int a0 = swap ? x0 : y0, e0 = swap ? y0 : x0;
  const int a = swap ? x : y, e = swap ? y : x;
  const int na = min(kImg, n - a0), ne = min(kImg, n - e0);
  const T* src0 = grad + (int64_t)b * c * vy * vx;
  float acc[kMaxC] = {0.f, 0.f, 0.f};

  for (int ra = 0; ra < 3; ++ra) {
    int h_lo, h_hi;
    if (!region(ra, a0, na, pad, n, h_lo, h_hi)) continue;
    for (int re = 0; re < 3; ++re) {
      int w_lo, w_hi;
      if (!region(re, e0, ne, pad, n, w_lo, w_hi)) continue;
      int n_lo, n_hi, m_lo, m_hi;
      touching(sy, t_y, h_lo, h_hi, vy, n_pad, n_lo, n_hi);
      touching(sx, t_x, w_lo, w_hi, vx, n_pad, m_lo, m_hi);
      // this thread's point of the rectangle (its gradient summed in
      // gp[][ty][tx]), the outputs reaching its row and (threads 0 ..
      // kImg - 1) those reaching each column
      const int h = h_lo + ty, w = w_lo + tx;
      const bool mine = h <= h_hi && w <= w_hi;
      int row_lo = 0, row_hi = -1;
      if (mine) touching(sy, t_y, h, h, vy, n_pad, row_lo, row_hi);
      __syncthreads();               // gp's previous readers are done
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch) gp[ch][ty][tx] = 0.f;
      if (threadIdx.x < kImg) {
        const int col = w_lo + (int)threadIdx.x;
        int lo = 0, hi = -1;
        if (col <= w_hi) touching(sx, t_x, col, col, vx, n_pad, lo, hi);
        reach[threadIdx.x][0] = lo;
        reach[threadIdx.x][1] = hi;
      }
      for (int nc = n_lo; nc <= n_hi; nc += kChunk) {
        const int nlen = min(kChunk, n_hi - nc + 1);
        for (int mc = m_lo; mc <= m_hi; mc += kChunk) {
          const int mlen = min(kChunk, m_hi - mc + 1);
          __syncthreads();           // the previous chunk's readers are done
          if (threadIdx.x < kChunk) {
            const int i = threadIdx.x;
            if (i < mlen) {
              float wt[kBand];
              band(position(sx, t_x, mc + i, vx), n_pad, up, bx[i], wt);
#pragma unroll
              for (int k = 0; k < kBand; ++k) wx[i][k] = wt[k];
            }
          } else if (threadIdx.x < 2 * kChunk) {
            const int i = threadIdx.x - kChunk;
            if (i < nlen) {
              float wt[kBand];
              band(position(sy, t_y, nc + i, vy), n_pad, up, by[i], wt);
#pragma unroll
              for (int k = 0; k < kBand; ++k) wy[i][k] = wt[k];
            }
          }
#pragma unroll 1
          for (int ch = 0; ch < c; ++ch) {
            const T* src = src0 + ((int64_t)ch * vy + nc) * vx + mc;
            for (int idx = threadIdx.x; idx < nlen * kChunk; idx += kThreads) {
              const int nn = idx / kChunk, mm = idx % kChunk;
              if (mm < mlen)
                sg[nn][mm] = pgx::to_f(src[(int64_t)nn * vx + mm]);
            }
            __syncthreads();
            // along x: z[nn][wi] = sum_m X[m, w] g[n, m]
            for (int idx = threadIdx.x; idx < nlen * kImg; idx += kThreads) {
              const int nn = idx / kImg, wi = idx % kImg;
              const int ww = w_lo + wi;
              const int lo = max(reach[wi][0], mc) - mc;
              const int hi = min(reach[wi][1], mc + mlen - 1) - mc;
              float s = 0.f;
              for (int mm = lo; mm <= hi; ++mm) {
                const int k = ww - bx[mm];
                if (k >= 0 && k < kBand) s += wx[mm][k] * sg[nn][mm];
              }
              z[nn][wi] = s;
            }
            __syncthreads();
            // along y: the rectangle's point (h, w)
            if (mine) {
              const int lo = max(row_lo, nc) - nc;
              const int hi = min(row_hi, nc + nlen - 1) - nc;
              float s = 0.f;
              for (int nn = lo; nn <= hi; ++nn) {
                const int k = h - by[nn];
                if (k >= 0 && k < kBand) s += wy[nn][k] * z[nn][tx];
              }
              gp[ch][ty][tx] += s;
            }
          }
        }
      }
      __syncthreads();
      const int ph = mirrored(ra, a, pad, n), pw = mirrored(re, e, pad, n);
      if (y < n && x < n && ph >= 0 && pw >= 0) {
#pragma unroll
        for (int ch = 0; ch < kMaxC; ++ch)
          acc[ch] += gp[ch][ph - h_lo][pw - w_lo];
      }
    }
  }
  if (y < n && x < n) {
    T* dst = out + (((int64_t)b * n + y) * n + x) * c;
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
      if (ch < c) dst[ch] = pgx::from_f<T>(acc[ch]);
  }
}

// ---- W2 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
down2_kernel(const T* __restrict__ v, T* __restrict__ out, int c, int h,
             int w, int64_t sb, int64_t sc, int64_t sr, int tiles_x,
             int tiles_y, Filter dn) {
  __shared__ float win[kDnRows][kDnCols + 1];
  __shared__ float xs[kDnRows][kDnX + 1];
  int blk = blockIdx.x;
  const int tile_x = blk % tiles_x;
  blk /= tiles_x;
  const int tile_y = blk % tiles_y;
  const int b = blk / tiles_y;
  const int y0 = tile_y * kDnY, x0 = tile_x * kDnX;
  const int rows = 2 * h + kTaps, cols = 2 * w + kTaps;
  const int ox = threadIdx.x % kDnX, oy = threadIdx.x / kDnX;
  constexpr int kPasses = kDnY * kDnX / kThreads;
  float acc[kPasses][kMaxC];
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) {
    if (ch >= c) break;              // uniform; acc[] keeps static indices
    const T* src = v + (int64_t)b * sb + (int64_t)ch * sc;
    for (int idx = threadIdx.x; idx < kDnRows * kDnCols; idx += kThreads) {
      const int rr = idx / kDnCols, cc = idx % kDnCols;
      const int gr = 2 * y0 + 1 + rr, gc = 2 * x0 + 1 + cc;
      win[rr][cc] = (gr < rows && gc < cols)
                        ? pgx::to_f(src[(int64_t)gr * sr + gc]) : 0.f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kDnRows * kDnX; idx += kThreads) {
      const int rr = idx / kDnX, xx = idx % kDnX;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) s += dn.h[j] * win[rr][2 * xx + j];
      xs[rr][xx] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int yy = oy + k * (kThreads / kDnX);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kTaps; ++i) s += dn.h[i] * xs[2 * yy + i][ox];
      acc[k][ch] = s;
    }
    __syncthreads();                 // before the next channel's window
  }
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int yo = y0 + oy + k * (kThreads / kDnX), xo = x0 + ox;
    if (yo >= h || xo >= w) continue;
    T* dst = out + (((int64_t)b * h + yo) * w + xo) * c;
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
      if (ch < c) dst[ch] = pgx::from_f<T>(acc[k][ch]);
  }
}

// ---- W2's transpose ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
down2_t_kernel(const T* __restrict__ g, T* __restrict__ out, int c, int h,
               int w, int tiles_s, int tiles_r, Filter dn) {
  __shared__ float win[kUpY][kUpX][kMaxC];
  __shared__ float zs[kUpY][kUpS + 1];
  int blk = blockIdx.x;
  const int tile_s = blk % tiles_s;
  blk /= tiles_s;
  const int tile_r = blk % tiles_r;
  const int b = blk / tiles_r;
  const int r0 = tile_r * kUpR, s0 = tile_s * kUpS;
  const int rows = 2 * h + kTaps, cols = 2 * w + kTaps;
  // first gradient row / column any of the tile's positions reads:
  // ceil((r0 - 12) / 2) = floor((r0 - 11) / 2)
  const int y_lo = (r0 - (kTaps - 1)) >> 1, x_lo = (s0 - (kTaps - 1)) >> 1;
  const T* src = g + (int64_t)b * h * w * c;
  for (int idx = threadIdx.x; idx < kUpY * kUpX * c; idx += kThreads) {
    const int ch = idx % c, rest = idx / c;
    const int xx = rest % kUpX, yy = rest / kUpX;
    const int yi = y_lo + yy, xi = x_lo + xx;
    win[yy][xx][ch] = (yi >= 0 && yi < h && xi >= 0 && xi < w)
                          ? pgx::to_f(src[((int64_t)yi * w + xi) * c + ch])
                          : 0.f;
  }
  __syncthreads();
  for (int ch = 0; ch < c; ++ch) {
    // along x: position s takes gradient columns x0(s) .. x0(s) + 5
    for (int idx = threadIdx.x; idx < kUpY * kUpS; idx += kThreads) {
      const int yy = idx / kUpS, ss = idx % kUpS;
      const int s = s0 + ss, xs0 = (s - (kTaps - 1)) >> 1;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kTaps / 2; ++j) {
        const int xi = xs0 + j;
        acc += dn.h[s - 2 * xi - 1] * win[yy][xi - x_lo][ch];
      }
      zs[yy][ss] = acc;
    }
    __syncthreads();
    T* dst = out + ((int64_t)b * c + ch) * rows * cols;
    for (int idx = threadIdx.x; idx < kUpR * kUpS; idx += kThreads) {
      const int rr = idx / kUpS, ss = idx % kUpS;
      const int r = r0 + rr, s = s0 + ss;
      if (r >= rows || s >= cols) continue;
      const int ys0 = (r - (kTaps - 1)) >> 1;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kTaps / 2; ++j) {
        const int yi = ys0 + j;
        acc += dn.h[r - 2 * yi - 1] * zs[yi - y_lo][ss];
      }
      dst[(int64_t)r * cols + s] = pgx::from_f<T>(acc);
    }
    __syncthreads();                 // before zs is rewritten
  }
}

// ---- launches ---------------------------------------------------------------

Filter up_filter(const float* hz) {  // g[ks] = 2 hz[11 - ks]
  Filter f;
  for (int k = 0; k < kTaps; ++k) f.h[k] = 2.f * hz[kTaps - 1 - k];
  return f;
}

Filter down_filter(const float* hz) {
  Filter f;
  for (int k = 0; k < kTaps; ++k) f.h[k] = hz[k];
  return f;
}

int grid(int64_t blocks, unsigned& out) {
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  out = (unsigned)blocks;
  return (int)cudaSuccess;
}

template <typename T>
int resample(const void* img, const void* params, void* out, int b, int n,
             int c, int vy, int vx, const float* hz, bool transpose,
             cudaStream_t s) {
  unsigned blocks;
  if (transpose) {
    const int tiles = (n + kImg - 1) / kImg;
    if (int e = grid((int64_t)tiles * tiles * b, blocks)) return e;
    resample_t_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)img, (const float*)params, (T*)out, n, c, vy, vx, tiles,
        up_filter(hz));
  } else {
    const int tiles_m = (vx + kTileM - 1) / kTileM;
    const int tiles_n = (vy + kTileN - 1) / kTileN;
    if (int e = grid((int64_t)tiles_m * tiles_n * b, blocks)) return e;
    resample_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)img, (const float*)params, (T*)out, n, c, vy, vx, tiles_m,
        tiles_n, up_filter(hz));
  }
  return (int)cudaGetLastError();
}

int resample_any(const void* in, const void* params, void* out, int b, int n,
                 int c, int vy, int vx, const float* hz, int dtype,
                 bool transpose, void* stream) {
  if (b < 1 || n < 1 || c < 1 || c > kMaxC || vy < 1 || vx < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return resample<float>(in, params, out, b, n, c, vy, vx, hz, transpose, s);
  if (dtype == pgx::kBFloat16)
    return resample<__nv_bfloat16>(in, params, out, b, n, c, vy, vx, hz,
                                   transpose, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int down2(const void* v, void* out, int b, int c, int h, int w, int64_t sb,
          int64_t sc, int64_t sr, const float* hz, cudaStream_t s) {
  const int tiles_x = (w + kDnX - 1) / kDnX, tiles_y = (h + kDnY - 1) / kDnY;
  unsigned blocks;
  if (int e = grid((int64_t)tiles_x * tiles_y * b, blocks)) return e;
  down2_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)v, (T*)out, c, h, w,
                                             sb, sc, sr, tiles_x, tiles_y,
                                             down_filter(hz));
  return (int)cudaGetLastError();
}

template <typename T>
int down2_t(const void* g, void* out, int b, int c, int h, int w,
            const float* hz, cudaStream_t s) {
  const int tiles_s = (2 * w + kTaps + kUpS - 1) / kUpS;
  const int tiles_r = (2 * h + kTaps + kUpR - 1) / kUpR;
  unsigned blocks;
  if (int e = grid((int64_t)tiles_s * tiles_r * b, blocks)) return e;
  down2_t_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)g, (T*)out, c, h,
                                               w, tiles_s, tiles_r,
                                               down_filter(hz));
  return (int)cudaGetLastError();
}

}  // namespace

// img: [b, n, n, c] contiguous (NHWC); params: f32 [b, 5] (swap, sx, sy,
// t_x, t_y); out: [b, c, vy, vx] contiguous; hz: the 12 taps of the sym6
// low-pass on the host.
extern "C" int pgx_warp_resample(const void* img, const void* params,
                                 void* out, int b, int n, int c, int vy,
                                 int vx, const float* hz, int dtype,
                                 void* stream) {
  return resample_any(img, params, out, b, n, c, vy, vx, hz, dtype, false,
                      stream);
}

// The transpose: grad [b, c, vy, vx] contiguous -> out [b, n, n, c].
extern "C" int pgx_warp_resample_t(const void* grad, const void* params,
                                   void* out, int b, int n, int c, int vy,
                                   int vx, const float* hz, int dtype,
                                   void* stream) {
  return resample_any(grad, params, out, b, n, c, vy, vx, hz, dtype, true,
                      stream);
}

// v: [b, c, 2h + 12, 2w + 12] with element strides (sb, sc, sr, 1); out:
// [b, h, w, c] contiguous.
extern "C" int pgx_warp_down2(const void* v, void* out, int b, int c, int h,
                              int w, int64_t sb, int64_t sc, int64_t sr,
                              const float* hz, int dtype, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return down2<float>(v, out, b, c, h, w, sb, sc, sr, hz, s);
  if (dtype == pgx::kBFloat16)
    return down2<__nv_bfloat16>(v, out, b, c, h, w, sb, sc, sr, hz, s);
  return (int)cudaErrorInvalidValue;
}

// The transpose: g [b, h, w, c] contiguous -> out [b, c, 2h + 12, 2w + 12].
extern "C" int pgx_warp_down2_t(const void* g, void* out, int b, int c, int h,
                                int w, const float* hz, int dtype,
                                void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32) return down2_t<float>(g, out, b, c, h, w, hz, s);
  if (dtype == pgx::kBFloat16)
    return down2_t<__nv_bfloat16>(g, out, b, c, h, w, hz, s);
  return (int)cudaErrorInvalidValue;
}

// The number of filter taps and the most channels the kernels take, for
// warp_resample.py to check its copy: 0 taps, 1 channels.
extern "C" int pgx_warp_resample_limits(int which) {
  return which == 0 ? kTaps : kMaxC;
}
