// Kernel D: upfirdn2d (pad or crop, zero-stuff by up, 1-D FIR along H and
// then along W, decimate by down) of an NHWC tensor, one launch per call.
//
// Replaces pgx/ops/pallas/kernels.py:upfirdn2d_pallas (_fir_rows_s1 with body
// _fir_kernel, driven by _fir_pass and _upfir_rows).  Per axis, with taps
// already flipped for a true convolution and scaled by sqrt(gain):
//   out[j] = sum_t taps[t] * d[j*down + t - pad0]
//   d[p] = x[p/up]  where p >= 0, p % up == 0 and p/up < L,  else 0
//   n_out = (L*up + pad0 + pad1 - ntaps) / down + 1
// Negative padding crops.  The H pass is rounded to x's type before the W
// pass, as pgx's two passes are; sums are taken in f32.
//
// Bound: bytes (input read once, output written once; about 2*ntaps/up
// operations per output element and pass).  The design keeps everything
// between the two reads and writes on chip:
// - A block owns one output tile (tile_h x tile_w pixels x tile_c channels).
//   upfirdn2d.py:_plan picks the tile and derives the input window it reads;
//   the kernel takes those numbers as they are (struct Plan).
// - The window is staged into shared memory once, with coalesced loads along
//   the contiguous (column, channel) axis, in the widest units (16, 8, 4 or
//   2 bytes) that x's row stride keeps aligned, and stored at the same
//   alignment so that the copies are free of bank conflicts; rows and
//   columns outside the input become zeros, so neither the padding nor the
//   zero-stuffing is ever materialised.  (TMA cannot read these tensors:
//   with C = 3 a pixel is 6 bytes and the row strides are not multiples of
//   16 bytes.)
// - H pass from shared memory into a second shared buffer, W pass from that
//   into a third laid out as the tile's rows are in device memory, each
//   thread computing kRun neighbouring outputs from a window of samples it
//   keeps in registers.  Only the taps that meet a sample are walked, so the
//   stuffed zeros cost nothing.
// - The tile leaves in 16-byte stores: each staged row (or, when C is split
//   into chunks, each pixel's chunk) sits at the same offset modulo 16 bytes
//   as its place in device memory, so whatever a row's alignment, all but
//   its two end vectors are whole 16-byte stores.
// - No per-element integer division: block and item indices are decoded
//   with multiply-shift dividers made on the host.  up, down and the tap
//   count are template parameters for the filters on the port's paths (12
//   taps: the ADA gather warp's sym6; 4 taps: the ops layer's [1,3,3,1]);
//   one instantiation per (up, down) takes any other count up to 64 at run
//   time, reading its taps from shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;        // outputs per thread and item, in both passes
constexpr int kStage = 4;      // loads in flight per thread while staging
constexpr int kMaxTaps = 64;
constexpr int kMaxSmem = 232448;

// One launch's plan, filled by upfirdn2d.py:_plan into the same layout
// (_PlanC there, field for field).  Tile (ty, tx) of image b, channel chunk
// ch, covers output rows ty*tile_h + org_y + [0, tile_h) and columns
// tx*tile_w + org_x + [0, tile_w); it reads input rows
// floor((j0*down - pad_y) / up) + [0, win_h) and the columns likewise.
struct Plan {
  int batch, h, w, c;          // input, NHWC
  int oh, ow;                  // output
  int up, down, ntaps;
  int pad_y, pad_x;            // leading pads (negative: crop)
  int org_y, org_x;            // first output row / column of tile 0: 0 or -1
  int tile_h, tile_w, tile_c;  // output tile; multiples of kRun (h, w)
  int win_h, win_w;            // input rows and columns a tile reads
  int in_pitch;                // elements between staged window rows
  int stage_vec;               // elements per staging unit (whole C)
  int tiles_y, tiles_x, chunks;
  int seg_n, seg_pitch;        // output staging: segments per tile row and
                               // their pitch in elements
  int vec;                     // elements per 16-byte store
  int off_mid, off_out, off_taps, smem_bytes;
  float taps[kMaxTaps];        // correlation order, scaled by sqrt(gain)
};

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s
struct FastDiv {
  uint32_t m, s;
};

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t one = 1;
  return {(uint32_t)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ int fdiv(const FastDiv& f, int n) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.s);
}

struct Params {
  Plan p;
  FastDiv tiles_x, tiles_y, chunks, wq, tile_c, runs_w, nvec, seg_n,
      stage_units;
};

template <int kUp>
__device__ __forceinline__ int floor_div(int v) {
  return kUp == 1 ? v : (v >> 1);  // kUp is 1 or 2
}

// kRun outputs of one 1-D pass.  src is the window sample at the run's
// first output's base; the run's tap 0 meets the zero-stuffed signal at
// `phase` (0 <= phase < kUp) past src's sample, and samples lie istride
// apart.  Output r sums taps[t] * d[phase + r*kDown + t] over the t whose
// position is a sample.
template <typename T, int kUp, int kDown, int kTaps>
__device__ __forceinline__ void fir_run(const T* src, int istride,
                                        const float* taps, int ntaps,
                                        int phase, float (&acc)[kRun]) {
  if constexpr (kTaps > 0) {
    // launched only where every run's phase is 0 (see launch())
    constexpr int kNv = ((kRun - 1) * kDown + kTaps - 1) / kUp + 1;
    float v[kNv];
#pragma unroll
    for (int k = 0; k < kNv; ++k) v[k] = pgx::to_f(src[k * istride]);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      float a = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
        if ((r * kDown + t) % kUp == 0)
          a = fmaf(taps[t], v[(r * kDown + t) / kUp], a);
      acc[r] = a;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int pos = phase + r * kDown;
      int t = (kUp - pos % kUp) % kUp;
      const T* s = src + (pos + t) / kUp * istride;
      float a = 0.f;
      for (; t < ntaps; t += kUp, s += istride)
        a = fmaf(taps[t], pgx::to_f(*s), a);
      acc[r] = a;
    }
  }
}

// Stage the window rows of a whole-C tile: row r of the window at s_in + r *
// in_pitch + po, in units U of stage_vec elements aligned in x (kStage in
// flight per thread).  A unit that lies whole inside x's row is one load
// and one store; one that runs past the row's ends, or lies in a row
// outside x, is written element by element, zeros outside x.
template <typename T, typename U>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, T* s_in,
                                           const Plan& p, const Params& prm,
                                           int b, int ry0, int rx0, int po) {
  constexpr int kN = sizeof(U) / sizeof(T);   // elements per unit
  const int nu = p.in_pitch / kN;              // units per staged row
  const int items = p.win_h * nu;
  const int64_t wc = (int64_t)p.w * p.c;
  for (int i0 = 0; i0 < items; i0 += kThreads * kStage) {
    U v[kStage];
    bool whole[kStage];
    int64_t g[kStage], row[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int it = i0 + j * kThreads + threadIdx.x;
      const int r = fdiv(prm.stage_units, it);
      const int gy = ry0 + r;
      row[j] = gy >= 0 && gy < p.h ? ((int64_t)b * p.h + gy) * wc : -1;
      g[j] = ((int64_t)b * p.h + gy) * wc + (int64_t)rx0 * p.c - po +
             (int64_t)(it - r * nu) * kN;
      whole[j] = it < items && row[j] >= 0 && g[j] >= row[j] &&
                 g[j] + kN <= row[j] + wc;
      if (whole[j]) v[j] = *reinterpret_cast<const U*>(x + g[j]);
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int it = i0 + j * kThreads + threadIdx.x;
      if (it >= items) continue;
      T* dst = s_in + (int64_t)it * kN;   // rows are in_pitch = nu * kN apart
      if (whole[j]) {
        *reinterpret_cast<U*>(dst) = v[j];
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const bool in = row[j] >= 0 && g[j] + e >= row[j] &&
                          g[j] + e < row[j] + wc;
          dst[e] = in ? x[g[j] + e] : pgx::from_f<T>(0.f);
        }
      }
    }
  }
}

template <typename T, int kUp, int kDown, int kTaps>
__global__ void __launch_bounds__(kThreads, 4)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = prm.p;
  T* s_in = reinterpret_cast<T*>(smem);
  T* s_mid = reinterpret_cast<T*>(smem + p.off_mid);
  T* s_out = reinterpret_cast<T*>(smem + p.off_out);
  float* s_taps = reinterpret_cast<float*>(smem + p.off_taps);
  const float* taps = kTaps > 0 ? p.taps : s_taps;
  if constexpr (kTaps == 0)
    for (int t = threadIdx.x; t < p.ntaps; t += kThreads) s_taps[t] = p.taps[t];

  // the block's tile: tile column fastest, then tile row, chunk, image
  const int q1 = fdiv(prm.tiles_x, blockIdx.x);
  const int tx = blockIdx.x - q1 * p.tiles_x;
  const int q2 = fdiv(prm.tiles_y, q1);
  const int ty = q1 - q2 * p.tiles_y;
  const int b = fdiv(prm.chunks, q2);
  const int c0 = (q2 - b * p.chunks) * p.tile_c;
  const int j0 = ty * p.tile_h + p.org_y, i0 = tx * p.tile_w + p.org_x;
  // the window's first input row and column, and where the tile's first
  // output's tap 0 meets the zero-stuffed signal past them
  const int vy = j0 * kDown - p.pad_y, vx = i0 * kDown - p.pad_x;
  const int ry0 = floor_div<kUp>(vy), rx0 = floor_div<kUp>(vx);
  const int phy = vy - ry0 * kUp, phx = vx - rx0 * kUp;
  const int ct = p.tile_c, wq = p.win_w * ct;
  const bool whole_c = ct == p.c;   // else the tile takes a chunk of C
  const T zero = pgx::from_f<T>(0.f);

  // 1. stage the input window: row r at s_in + r * in_pitch + po, zeros
  // outside x
  int po = 0;
  if (whole_c) {
    // A window row is one contiguous run of x's row, copied in units of
    // stage_vec elements aligned in x; x's rows are whole units apart, so
    // the window starts po elements into its first unit in every row.
    po = (rx0 * p.c) & (p.stage_vec - 1);
    switch (p.stage_vec * (int)sizeof(T)) {
      case 16: stage_rows<T, uint4>(x, s_in, p, prm, b, ry0, rx0, po); break;
      case 8: stage_rows<T, uint2>(x, s_in, p, prm, b, ry0, rx0, po); break;
      case 4: stage_rows<T, uint32_t>(x, s_in, p, prm, b, ry0, rx0, po); break;
      default: stage_rows<T, T>(x, s_in, p, prm, b, ry0, rx0, po); break;
    }
  } else {
    // a chunk of C: element by element, kStage loads in flight per thread
    const int n_in = p.win_h * wq;
    for (int e0 = 0; e0 < n_in; e0 += kThreads * kStage) {
      T v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = e0 + u * kThreads + threadIdx.x;
        const int r = fdiv(prm.wq, e), q = e - r * wq;
        const int s = fdiv(prm.tile_c, q);
        const int gy = ry0 + r, gx = rx0 + s, gc = c0 + q - s * ct;
        v[u] = zero;
        if (e < n_in && gy >= 0 && gy < p.h && gx >= 0 && gx < p.w &&
            gc < p.c)
          v[u] = x[(((int64_t)b * p.h + gy) * p.w + gx) * p.c + gc];
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = e0 + u * kThreads + threadIdx.x;
        const int r = fdiv(prm.wq, e);
        if (e < n_in) s_in[r * p.in_pitch + e - r * wq] = v[u];
      }
    }
  }
  __syncthreads();

  // 2. H pass: window rows -> tile rows [tile_h][win_w * ct], rounded to T.
  // An item is one (column, channel) of the window and kRun tile rows.
  const int items_h = (p.tile_h / kRun) * wq;
  for (int it = threadIdx.x; it < items_h; it += kThreads) {
    const int g = fdiv(prm.wq, it), q = it - g * wq;
    float acc[kRun];
    fir_run<T, kUp, kDown, kTaps>(
        s_in + (g * kRun * kDown / kUp) * p.in_pitch + po + q, p.in_pitch,
        taps, p.ntaps, phy, acc);
    T* dst = s_mid + g * kRun * wq + q;
#pragma unroll
    for (int r = 0; r < kRun; ++r) dst[r * wq] = pgx::from_f<T>(acc[r]);
  }
  __syncthreads();

  // 3. W pass: tile rows -> output pixels, into the staging layout of step
  // 4.  An item is one (tile row, channel) and kRun tile columns.  Only the
  // low bits of an element's index in `out` matter here: 32-bit wrapping
  // arithmetic keeps them.
  const int runs_w = p.tile_w / kRun, vmask = p.vec - 1;
  const int items_w = p.tile_h * runs_w * ct;
  for (int it = threadIdx.x; it < items_w; it += kThreads) {
    const int rw = fdiv(prm.tile_c, it), c = it - rw * ct;
    const int jr = fdiv(prm.runs_w, rw), ir0 = (rw - jr * runs_w) * kRun;
    float acc[kRun];
    fir_run<T, kUp, kDown, kTaps>(
        s_mid + jr * wq + (ir0 * kDown / kUp) * ct + c, ct, taps, p.ntaps,
        phx, acc);
    const uint32_t row0 = ((uint32_t)b * p.oh + (uint32_t)(j0 + jr)) *
                              (uint32_t)p.ow + (uint32_t)i0;
    if (whole_c) {   // one segment per row, from the tile's first pixel
      const uint32_t ge = row0 * (uint32_t)p.c;
      T* dst = s_out + jr * p.seg_pitch + (ge & vmask) + ir0 * p.c + c;
#pragma unroll
      for (int r = 0; r < kRun; ++r) dst[r * p.c] = pgx::from_f<T>(acc[r]);
    } else {         // one segment per pixel: its chunk of channels
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const uint32_t ge = (row0 + ir0 + r) * (uint32_t)p.c + c0;
        s_out[(jr * p.tile_w + ir0 + r) * p.seg_pitch + (ge & vmask) + c] =
            pgx::from_f<T>(acc[r]);
      }
    }
  }
  __syncthreads();

  // 4. the tile's rows to `out`: a 16-byte store for each vector that lies
  // whole inside its segment's outputs, element stores at the ends.
  const int nvec = p.seg_pitch / p.vec;
  const int items_o = p.tile_h * p.seg_n * nvec;
  for (int it = threadIdx.x; it < items_o; it += kThreads) {
    const int seg = fdiv(prm.nvec, it), k = it - seg * nvec;
    const int jr = fdiv(prm.seg_n, seg), sg = seg - jr * p.seg_n;
    const int j = j0 + jr;
    if (j < 0 || j >= p.oh) continue;
    int lo, hi;      // the segment's elements that are outputs
    int64_t ge0;     // index in `out` of the segment's element 0
    if (whole_c) {
      lo = max(0, -i0) * p.c;
      hi = min(p.tile_w, p.ow - i0) * p.c;
      ge0 = ((int64_t)b * p.oh + j) * p.ow * p.c + (int64_t)i0 * p.c;
    } else {
      const int i = i0 + sg;
      if (i < 0 || i >= p.ow) continue;
      lo = 0;
      hi = min(ct, p.c - c0);
      ge0 = (((int64_t)b * p.oh + j) * p.ow + i) * p.c + c0;
    }
    const int e0 = k * p.vec - (int)(ge0 & vmask);
    const T* src = s_out + seg * p.seg_pitch + k * p.vec;
    if (e0 >= lo && e0 + p.vec <= hi) {
      *reinterpret_cast<uint4*>(out + ge0 + e0) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      const int e_end = min(e0 + p.vec, hi);
      for (int e = max(e0, lo); e < e_end; ++e) out[ge0 + e] = src[e - e0];
    }
  }
}

template <typename T, int kUp, int kDown, int kTaps>
int launch_one(const void* x, void* out, const Params& prm, unsigned blocks,
               cudaStream_t stream) {
  auto kernel = upfirdn2d_kernel<T, kUp, kDown, kTaps>;
  // set on every launch, as the other kernels of the library do: a value
  // kept per instantiation could be lowered by a launch on another thread
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kThreads, prm.p.smem_bytes, stream>>>(
      (const T*)x, (T*)out, prm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, const Params& prm, unsigned blocks,
           cudaStream_t stream) {
  const Plan& p = prm.p;
  // the fixed-count instantiations assume every run's tap 0 meets a sample
  const bool phase0 = ((p.org_y * p.down - p.pad_y) & (p.up - 1)) == 0 &&
                      ((p.org_x * p.down - p.pad_x) & (p.up - 1)) == 0;
  if (p.up == 2 && p.down == 1) {
    if (phase0 && p.ntaps == 12)
      return launch_one<T, 2, 1, 12>(x, out, prm, blocks, stream);
    if (phase0 && p.ntaps == 4)
      return launch_one<T, 2, 1, 4>(x, out, prm, blocks, stream);
    return launch_one<T, 2, 1, 0>(x, out, prm, blocks, stream);
  }
  if (p.up == 1 && p.down == 2) {
    if (p.ntaps == 12)
      return launch_one<T, 1, 2, 12>(x, out, prm, blocks, stream);
    if (p.ntaps == 4)
      return launch_one<T, 1, 2, 4>(x, out, prm, blocks, stream);
    return launch_one<T, 1, 2, 0>(x, out, prm, blocks, stream);
  }
  if (p.up == 1) return launch_one<T, 1, 1, 0>(x, out, prm, blocks, stream);
  return launch_one<T, 2, 2, 0>(x, out, prm, blocks, stream);
}

bool plan_ok(const Plan& p, int elem_bytes) {
  const bool dims = p.batch >= 1 && p.h >= 0 && p.w >= 0 && p.c >= 1 &&
                    p.oh >= 1 && p.ow >= 1;
  const bool factors = (p.up == 1 || p.up == 2) &&
                       (p.down == 1 || p.down == 2);
  const bool tile = p.tile_h >= kRun && p.tile_h % kRun == 0 &&
                    p.tile_w >= kRun && p.tile_w % kRun == 0 &&
                    p.tile_c >= 1 && p.tile_c <= p.c &&
                    p.win_h >= 1 && p.win_w >= 1;
  const bool grid = p.tiles_y >= 1 && p.tiles_x >= 1 && p.chunks >= 1 &&
                    (int64_t)p.chunks * p.tile_c >= p.c &&
                    (int64_t)p.tiles_y * p.tile_h + p.org_y >= p.oh &&
                    (int64_t)p.tiles_x * p.tile_w + p.org_x >= p.ow;
  if (!(dims && factors && tile && grid && p.ntaps >= 1 &&
        p.ntaps <= kMaxTaps))
    return false;
  // the window holds every sample the tile's taps meet (the phase is the
  // same for every tile: tile_h * down is a multiple of up)
  const int ph_y = (p.org_y * p.down - p.pad_y) & (p.up - 1);
  const int ph_x = (p.org_x * p.down - p.pad_x) & (p.up - 1);
  const bool window =
      p.win_h >= (ph_y + (p.tile_h - 1) * p.down + p.ntaps - 1) / p.up + 1 &&
      p.win_w >= (ph_x + (p.tile_w - 1) * p.down + p.ntaps - 1) / p.up + 1;
  // and the three buffers fit where the offsets put them
  const int64_t wq = (int64_t)p.win_w * p.tile_c * elem_bytes;
  const int64_t seg_cap = p.tile_c == p.c ? (int64_t)p.tile_w * p.c
                                          : p.tile_c;
  const int sv = p.stage_vec;
  const bool stage_in =
      sv >= 1 && (sv & (sv - 1)) == 0 && sv * elem_bytes <= 16 &&
      (p.tile_c < p.c || ((int64_t)p.w * p.c) % sv == 0) &&
      p.in_pitch % p.vec == 0 &&
      p.in_pitch >= p.win_w * p.tile_c + 2 * p.vec - 2;
  const bool staging =
      stage_in && p.vec * elem_bytes == 16 && p.seg_pitch % p.vec == 0 &&
      p.seg_pitch >= seg_cap + p.vec - 1 &&
      p.seg_n == (p.tile_c == p.c ? 1 : p.tile_w) &&
      p.off_mid % 16 == 0 && p.off_out % 16 == 0 && p.off_taps % 16 == 0 &&
      p.off_mid >= (int64_t)p.win_h * p.in_pitch * elem_bytes &&
      p.off_out - p.off_mid >= p.tile_h * wq &&
      p.off_taps - p.off_out >=
          (int64_t)p.tile_h * p.seg_n * p.seg_pitch * elem_bytes &&
      p.smem_bytes >= p.off_taps + 4 * kMaxTaps && p.smem_bytes <= kMaxSmem;
  return window && staging;
}

}  // namespace

// x: [batch, h, w, c] contiguous; out: [batch, oh, ow, c], 16-byte aligned;
// plan: host pointer to a struct Plan (void here: the struct's type has
// internal linkage), copied into the launch's arguments.
extern "C" int pgx_upfirdn2d(const void* x, void* out, const void* plan,
                             int dtype, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const int elem = dtype == pgx::kFloat32 ? 4 : 2;
  if ((dtype != pgx::kFloat32 && dtype != pgx::kBFloat16) ||
      !plan_ok(p, elem) || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)p.tiles_x * p.tiles_y * p.chunks * p.batch;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  Params prm;
  prm.p = p;
  prm.tiles_x = make_div(p.tiles_x);
  prm.tiles_y = make_div(p.tiles_y);
  prm.chunks = make_div(p.chunks);
  prm.wq = make_div(p.win_w * p.tile_c);
  prm.tile_c = make_div(p.tile_c);
  prm.runs_w = make_div(p.tile_w / kRun);
  prm.nvec = make_div(p.seg_pitch / p.vec);
  prm.seg_n = make_div(p.seg_n);
  prm.stage_units = make_div(p.in_pitch / p.stage_vec);
  if (dtype == pgx::kFloat32)
    return launch<float>(x, out, prm, (unsigned)blocks, (cudaStream_t)stream);
  return launch<__nv_bfloat16>(x, out, prm, (unsigned)blocks,
                               (cudaStream_t)stream);
}

// the size of struct Plan, which upfirdn2d.py's _PlanC must have
extern "C" int pgx_upfirdn2d_plan_bytes() { return (int)sizeof(Plan); }
