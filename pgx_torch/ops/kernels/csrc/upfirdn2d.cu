// Kernel D: one separable pass of upfirdn2d (pad or crop, zero-stuff by
// up, 1-D FIR, decimate by down) along H or W of an NHWC tensor.
//
// Replaces pgx/ops/pallas/kernels.py:upfirdn2d_pallas (_fir_rows_s1 with body
// _fir_kernel, driven by _fir_pass and _upfir_rows).  Seen as
// x[outer, L, inner] -> out[outer, n_out, inner], with taps already flipped
// for a true convolution and scaled by sqrt(gain):
//   out[o, j, i] = sum_t taps[t] * d[j*down + t - pad0]
//   d[p] = x[o, p/up, i]  where p >= 0, p % up == 0 and p/up < L,  else 0
//   n_out = (L*up + pad0 + pad1 - ntaps) / down + 1
// Negative padding crops: pad0 < 0 moves the window forward, pad1 < 0
// shortens n_out.
//
// Bound: bytes (input read once, output written once; 2*ntaps/up operations
// per output element, far under the f32 rate for the filters in use).  The
// TPU kernel splits up=2 into polyphase sub-filters and down=2 into parity
// planes because its vector unit cannot take strided slices; here a thread
// computes one output element and walks only the taps that meet a sample
// (every up-th one, reading consecutive samples), so the stuffed zeros cost
// nothing.  Threads are laid along (j, i) flattened, so both the H
// pass (inner = W*C) and the W pass (inner = C, often 3) read and write
// along the contiguous axis; every input element is fetched from device
// memory once and again from L1/L2 by the outputs that share it.  Sums are
// taken in f32 and rounded once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;

struct Taps {
  float v[kMaxTaps];
};

// Idx is 32-bit where the element count allows: the two divisions that
// decode a thread's (o, j, i) are then a fraction of the tap loop's cost.
template <typename T, typename Idx, int kUp>
__global__ void __launch_bounds__(kThreads)
upfirdn_1d_kernel(const T* __restrict__ x, T* __restrict__ out, Taps taps,
                  int ntaps, Idx total, int len, int n_out, int inner,
                  int down, int pad0) {
  const Idx e = (Idx)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const Idx per_outer = (Idx)n_out * (Idx)inner;
  const Idx o = e / per_outer;
  const Idx rem = e - o * per_outer;
  const int j = (int)(rem / (Idx)inner);
  const int i = (int)(rem - (Idx)j * (Idx)inner);
  const int first = j * down - pad0;   // position of tap 0 in the stuffed signal
  // the taps that meet a sample: p = first + t with p >= 0, p % kUp == 0 and
  // p / kUp < len; they are kUp apart and read consecutive samples
  int t = first >= 0 ? 0 : -first;
  if (kUp == 2) t += (first + t) & 1;
  const int t_end = min(ntaps, (len - 1) * kUp - first + 1);
  const T* src = x + ((int64_t)o * len + (first + t) / kUp) * inner + i;
  float acc = 0.f;
  for (; t < t_end; t += kUp, src += inner) acc += taps.v[t] * pgx::to_f(*src);
  out[e] = pgx::from_f<T>(acc);
}

template <typename T, typename Idx>
int launch_idx(const T* x, T* out, const Taps& tp, int ntaps, int64_t total,
               int len, int n_out, int inner, int up, int down, int pad0,
               cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (up == 1) {
    upfirdn_1d_kernel<T, Idx, 1><<<blocks, kThreads, 0, stream>>>(
        x, out, tp, ntaps, (Idx)total, len, n_out, inner, down, pad0);
  } else {
    upfirdn_1d_kernel<T, Idx, 2><<<blocks, kThreads, 0, stream>>>(
        x, out, tp, ntaps, (Idx)total, len, n_out, inner, down, pad0);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, const float* taps, int ntaps,
           int64_t outer, int len, int n_out, int inner, int up, int down,
           int pad0, void* stream) {
  const int64_t total = outer * n_out * inner;
  if (total <= 0) return (int)cudaSuccess;
  if ((total + kThreads - 1) / kThreads > 2147483647LL || up > 2)
    return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int t = 0; t < kMaxTaps; ++t) tp.v[t] = t < ntaps ? taps[t] : 0.f;
  if (total < 2147483647LL)
    return launch_idx<T, uint32_t>((const T*)x, (T*)out, tp, ntaps, total, len,
                                   n_out, inner, up, down, pad0,
                                   (cudaStream_t)stream);
  return launch_idx<T, int64_t>((const T*)x, (T*)out, tp, ntaps, total, len,
                                n_out, inner, up, down, pad0,
                                (cudaStream_t)stream);
}

}  // namespace

// x: [outer, len, inner] contiguous; out: [outer, n_out, inner]; taps: host
// pointer to ntaps floats (copied into the launch's arguments).
extern "C" int pgx_upfirdn_1d(const void* x, void* out, const float* taps,
                              int ntaps, int64_t outer, int len, int n_out,
                              int inner, int up, int down, int pad0,
                              int dtype, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || up < 1 || down < 1 || len < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == pgx::kFloat32)
    return launch<float>(x, out, taps, ntaps, outer, len, n_out, inner, up,
                         down, pad0, stream);
  if (dtype == pgx::kBFloat16)
    return launch<__nv_bfloat16>(x, out, taps, ntaps, outer, len, n_out,
                                 inner, up, down, pad0, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pgx_upfirdn_max_taps() { return kMaxTaps; }
