// Kernel C: 3x3 SAME convolution fused with bias -> pixel-norm -> leaky-ReLU.
//
// Replaces pgx/ops/pallas/conv_epilogue.py:conv3x3_epilogue_fwd (body _kernel):
//   out = lrelu(pixel_norm(conv3x3_same(x, w) + b))   over NHWC, f32 statistics.
//
// Bound: operations at the wide stages (C = 512 at 16-32 px: 2*9*Cin*Cout
// operations per output pixel against ~2*(Cin+Cout) bytes), bytes at the
// 4-8 px stages, where the weights dominate the traffic.
//
// Design.  An implicit GEMM: M = output pixels, N = Cout, K = 9 taps x Cin.
// The pixel norm reduces over all of Cout, so one block owns a tile of output
// pixels and every output channel (Cout <= 512), and the epilogue runs on the
// accumulators before the single store: the pre-activation never reaches
// device memory.  K is walked tap by tap in chunks of input channels staged
// through shared memory; taps that fall outside the image are zero-filled by
// the copy itself, so no padded copy of x is made.
//
// * bf16: tensor cores through mma.sync m16n8k16 (f32 accumulation).  A CTA
//   of 256 threads computes 128 pixels x 128 channels; C_out (padded to 128,
//   256 or 512) is split over a thread-block cluster of 1, 2 or 4 CTAs on the
//   same pixels, which sum the pixel-norm statistic through distributed
//   shared memory.  K steps of 32 input channels run through a 4-deep
//   cp.async ring; fragments come from shared memory by ldmatrix.  Weights
//   come as [9][CP][Cin], so both operands are K-contiguous; rows are padded
//   to 40 elements, which keeps ldmatrix free of bank conflicts.
// * f32: CUDA-core FMA (the tensor cores have no full-f32 path).  Block = 64
//   pixels x C_out padded to 32*CPT, 8 warps of 8 pixels, lane l owns
//   channels l + 32j; K steps of 16 input channels double-buffered with
//   cp.async.  Weights come as [9][Cin][Cout].
//
// Both kernels take an optional `rout`: when it is not null (the
// differentiated forward, conv3x3_epilogue_fwd(..., emit_r=True)) the
// pixel-norm scale r = rsqrt(mean_c(a^2) + eps) of every output pixel is also
// written, as (nb, h, wd, 1) f32.  It is the only residual the backward needs
// beside the output itself.  In the clustered kernel every CTA of a cluster
// holds the summed statistic after the reduction; rank 0 alone writes r.
//
// wgmma/TMA are left for a later change.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// C_out padded for the tensor-core kernel: the next of 128, 256, 512
int mma_cout_pad(int cout) {
  int cp = 128;
  while (cp < cout) cp *= 2;
  return cp;
}

// ---------------------------------------------------------------------------
// cp.async helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// f32 FMA kernel
// ---------------------------------------------------------------------------

constexpr int kFmaBM = 64;   // output pixels per block
constexpr int kFmaKC = 16;   // input channels per K step
constexpr int kFmaPPW = 8;   // pixels per warp
constexpr int kFmaLDA = kFmaKC + 1;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem,
                                              int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

template <int CPT>
constexpr int fma_smem_bytes() {
  return 2 * (kFmaBM * kFmaLDA + kFmaKC * 32 * CPT) * 4;
}

// Block = 64 pixels x all C_out (padded to 32 * CPT); warp w owns pixels
// 8w..8w+7, lane l owns channels l + 32j.  K steps of 16 input channels are
// double-buffered through shared memory with cp.async.
template <int CPT>
__global__ void __launch_bounds__(256, 1)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ rout, int nb, int h, int wd, int cin,
                   int cout, int use_pn, float slope, float eps) {
  constexpr int CP = 32 * CPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);    // [2][BM][LDA]
  float* Bs = As + 2 * kFmaBM * kFmaLDA;             // [2][KC][CP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t M = (int64_t)nb * h * wd;
  const int64_t m0 = (int64_t)blockIdx.x * kFmaBM;

  // A staging: element e = tid + 256 j is pixel e / KC, channel e % KC
  const int ak = tid % kFmaKC;
  int ay[4], ax[4];
  const float* abase[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t m = m0 + (tid + 256 * j) / kFmaKC;
    ay[j] = -(1 << 20);
    ax[j] = 0;
    abase[j] = x;
    if (m < M) {
      ax[j] = (int)(m % wd);
      ay[j] = (int)((m / wd) % h);
      abase[j] = x + m * cin + ak;
    }
  }
  const int kchunks = (cin + kFmaKC - 1) / kFmaKC;
  const int KT = 9 * kchunks;

  auto load_stage = [&](int it) {
    float* as = As + (it & 1) * kFmaBM * kFmaLDA;
    float* bs = Bs + (it & 1) * kFmaKC * CP;
    const int tap = it / kchunks, c0 = (it % kchunks) * kFmaKC;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sy = ay[j] + dy, sx = ax[j] + dx;
      const bool ok = sy >= 0 && sy < h && sx >= 0 && sx < wd &&
                      c0 + ak < cin;
      const float* src =
          ok ? abase[j] + ((int64_t)dy * wd + dx) * cin + c0 : x;
      cp_async4(as + ((tid + 256 * j) / kFmaKC) * kFmaLDA + ak, src,
                ok ? 4 : 0);
    }
#pragma unroll
    for (int j = 0; j < (kFmaKC * CP / 4 + 255) / 256; ++j) {
      const int c = tid + 256 * j;
      if (c < kFmaKC * CP / 4) {
        const int k = c / (CP / 4), n = (c % (CP / 4)) * 4;
        const bool ok = c0 + k < cin && n < cout;
        const float* src =
            ok ? w + ((int64_t)tap * cin + c0 + k) * cout + n : w;
        cp_async16_ca(bs + k * CP + n, src, ok ? 16 : 0);
      }
    }
  };

  float acc[kFmaPPW][CPT];
#pragma unroll
  for (int p = 0; p < kFmaPPW; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  load_stage(0);
  cp_async_commit();
  for (int it = 0; it < KT; ++it) {
    if (it + 1 < KT) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = As + (it & 1) * kFmaBM * kFmaLDA + warp * kFmaPPW *
                                                            kFmaLDA;
    const float* bs = Bs + (it & 1) * kFmaKC * CP + lane;
#pragma unroll
    for (int k = 0; k < kFmaKC; ++k) {
      float av[kFmaPPW], bv[CPT];
#pragma unroll
      for (int p = 0; p < kFmaPPW; ++p) av[p] = as[p * kFmaLDA + k];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bv[j] = bs[k * CP + 32 * j];
#pragma unroll
      for (int p = 0; p < kFmaPPW; ++p)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[p][j] = fmaf(av[p], bv[j], acc[p][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kFmaPPW; ++p) {
    const int64_t m = m0 + warp * kFmaPPW + p;
    float ssq = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = lane + 32 * j;
      const float a = acc[p][j] + (n < cout ? bias[n] : 0.f);
      acc[p][j] = a;
      ssq += a * a;  // padded channels hold exactly 0
    }
    ssq = pgx::warp_sum(ssq);
    const float r = use_pn ? rsqrtf(ssq * (1.f / cout) + eps) : 1.f;
    if (m < M) {
      if (rout != nullptr && lane == 0) rout[m] = r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int n = lane + 32 * j;
        if (n < cout) out[m * cout + n] = pgx::lrelu(acc[p][j] * r, slope);
      }
    }
  }
}

int launch_fma(const void* x, const void* w, const void* b, void* out,
               float* rout, int nb, int h, int wd, int cin, int cout,
               int use_pn, float slope, float eps, cudaStream_t stream) {
  const int64_t M = (int64_t)nb * h * wd;
  const unsigned grid = (unsigned)((M + kFmaBM - 1) / kFmaBM);
  const int cpt = (cout + 31) / 32;
#define PGX_FMA_CASE(N)                                                      \
  if (cpt <= N) {                                                            \
    constexpr int smem = fma_smem_bytes<N>();                                \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        conv3x3_fma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
        smem);                                                               \
    if (e != cudaSuccess) return (int)e;                                     \
    conv3x3_fma_kernel<N><<<grid, 256, smem, stream>>>(                      \
        (const float*)x, (const float*)w, (const float*)b, (float*)out,      \
        rout, nb, h, wd, cin, cout, use_pn, slope, eps);                     \
    return (int)cudaGetLastError();                                          \
  }
  PGX_FMA_CASE(1)
  PGX_FMA_CASE(2)
  PGX_FMA_CASE(4)
  PGX_FMA_CASE(8)
  PGX_FMA_CASE(16)
#undef PGX_FMA_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (mma.sync m16n8k16, ldmatrix, cp.async pipeline)
// ---------------------------------------------------------------------------

constexpr int kMmaKC = 32;             // input channels per K step
constexpr int kMmaLDS = kMmaKC + 8;    // shared row stride (elements, 80 B)
constexpr int kMmaStages = 4;          // cp.async ring depth

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA computes 128 pixels x 128 output channels (8 warps as 4 x 2, each
// a 32 x 64 tile of 2 x 8 mma fragments).  C_out is padded to CP in
// {128, 256, 512} and split over a cluster of NC = CP/128 CTAs that share
// the pixel tile; the pixel-norm statistic is summed across the cluster
// through distributed shared memory, so the pre-activation still never
// leaves the chip.
constexpr int kCtaThreads = 256;
constexpr int kBM = 128;               // pixels per CTA
constexpr int kBN = 128;               // output channels per CTA
constexpr int kStage = (kBM + kBN) * kMmaLDS;        // elements per stage
constexpr int kSmem = kMmaStages * kStage * 2 + 2 * kBM * 4 + kBM * 4;

template <int NC>
__global__ void __cluster_dims__(NC, 1, 1) __launch_bounds__(kCtaThreads, 2)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                   const bf16* __restrict__ bias, bf16* __restrict__ out,
                   float* __restrict__ rout, int nb, int h, int wd, int cin,
                   int cout, int use_pn, float slope, float eps) {
  constexpr int CP = kBN * NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [stages][BM+BN][LDS]
  float* red = reinterpret_cast<float*>(ring + kMmaStages * kStage);  // [2][BM]
  float* part = red + 2 * kBM;                       // [BM], read by the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();        // channel slice
  const int n0 = rank * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int64_t M = (int64_t)nb * h * wd;
  const int64_t m0 = (int64_t)(blockIdx.x / NC) * kBM;

  // A staging: chunk i = tid + 256 j is pixel row i/4, channels 8*(i%4)
  int ay[2], ax[2];
  const bf16* abase[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + kCtaThreads * j;
    const int64_t m = m0 + (i >> 2);
    ay[j] = -(1 << 20);  // out of range: every tap zero-fills
    ax[j] = 0;
    abase[j] = x;
    if (m < M) {
      ax[j] = (int)(m % wd);
      ay[j] = (int)((m / wd) % h);
      abase[j] = x + m * cin + (i & 3) * 8;
    }
  }

  const int kchunks = (cin + kMmaKC - 1) / kMmaKC;
  const int KT = 9 * kchunks;

  auto load_stage = [&](int it) {
    bf16* As = ring + (it % kMmaStages) * kStage;
    bf16* Bs = As + kBM * kMmaLDS;
    const int tap = it / kchunks, c0 = (it % kchunks) * kMmaKC;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + kCtaThreads * j;
      const int sy = ay[j] + dy, sx = ax[j] + dx;
      const bool ok = sy >= 0 && sy < h && sx >= 0 && sx < wd &&
                      c0 + (i & 3) * 8 < cin;
      const bf16* src =
          ok ? abase[j] + ((int64_t)dy * wd + dx) * cin + c0 : x;
      cp_async16(As + (i >> 2) * kMmaLDS + (i & 3) * 8, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + kCtaThreads * j;
      const int c = c0 + (i & 3) * 8;
      const bool ok = c < cin;
      const bf16* src =
          ok ? wt + ((int64_t)tap * CP + n0 + (i >> 2)) * cin + c : wt;
      cp_async16(Bs + (i >> 2) * kMmaLDS + (i & 3) * 8, src, ok ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  // per-lane ldmatrix row offsets (see the m16n8k16 fragment layouts)
  const int a_off = (wm * 32 + (lane & 15)) * kMmaLDS + (lane >> 4) * 8;
  const int b_off = (wn * 64 + ((lane >> 4) << 3) + (lane & 7)) * kMmaLDS +
                    ((lane >> 3) & 1) * 8;
  for (int it = 0; it < KT; ++it) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage `it` landed; stage it-1 is free to refill
    if (it + kMmaStages - 1 < KT) load_stage(it + kMmaStages - 1);
    cp_async_commit();
    const bf16* A = ring + (it % kMmaStages) * kStage;
    const bf16* B = A + kBM * kMmaLDS;
#pragma unroll
    for (int kk = 0; kk < kMmaKC; kk += 16) {
      uint32_t af[2][4];
      ldmatrix_x4(af[0], A + a_off + kk);
      ldmatrix_x4(af[1], A + a_off + 16 * kMmaLDS + kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, B + b_off + np * 16 * kMmaLDS + kk);
        mma_bf16(acc[0][2 * np], af[0], bf[0], bf[1]);
        mma_bf16(acc[1][2 * np], af[1], bf[0], bf[1]);
        mma_bf16(acc[0][2 * np + 1], af[0], bf[2], bf[3]);
        mma_bf16(acc[1][2 * np + 1], af[1], bf[2], bf[3]);
      }
    }
  }

  // epilogue: bias, per-pixel sum of squares over all C_out, scale, lrelu
  const int g = lane >> 2, tg = lane & 3;
  float rs[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    rs[mi][0] = rs[mi][1] = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn * 64 + ni * 8 + tg * 2;
      const float b0 = col < cout ? pgx::to_f(bias[col]) : 0.f;
      const float b1 = col + 1 < cout ? pgx::to_f(bias[col + 1]) : 0.f;
      float* c = acc[mi][ni];
      c[0] += b0; c[1] += b1; c[2] += b0; c[3] += b1;
      rs[mi][0] += c[0] * c[0] + c[1] * c[1];
      rs[mi][1] += c[2] * c[2] + c[3] * c[3];
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = rs[mi][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tg == 0) red[wn * kBM + wm * 32 + mi * 16 + hh * 8 + g] = v;
    }
  __syncthreads();
  if (tid < kBM) part[tid] = red[tid] + red[kBM + tid];
  cluster.sync();  // every CTA's partial sums are visible cluster-wide
  if (tid < kBM) {
    float ssq = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) ssq += cluster.map_shared_rank(part, q)[tid];
    const float r = use_pn ? rsqrtf(ssq * (1.f / cout) + eps) : 1.f;
    red[tid] = r;
    // every rank holds the same r; one of them stores it
    if (rout != nullptr && rank == 0 && m0 + tid < M) rout[m0 + tid] = r;
  }
  cluster.sync();  // no CTA leaves while another still reads its `part`
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int lr = wm * 32 + mi * 16 + hh * 8 + g;
      const float r = red[lr];
      const int64_t m = m0 + lr;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + tg * 2;
        if (col >= cout) continue;
        const float* c = acc[mi][ni] + 2 * hh;
        __nv_bfloat162 v;
        v.x = __float2bfloat16(pgx::lrelu(c[0] * r, slope));
        v.y = __float2bfloat16(pgx::lrelu(c[1] * r, slope));
        *reinterpret_cast<__nv_bfloat162*>(out + m * cout + col) = v;
      }
    }
}

int launch_mma(const void* x, const void* w, const void* b, void* out,
               float* rout, int nb, int h, int wd, int cin, int cout,
               int use_pn, float slope, float eps, cudaStream_t stream) {
  const int64_t M = (int64_t)nb * h * wd;
  const int nc = mma_cout_pad(cout) / kBN;
  const int64_t tiles = (M + kBM - 1) / kBM;
#define PGX_MMA_CASE(NC)                                                     \
  if (nc == NC) {                                                            \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        conv3x3_mma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        kSmem);                                                              \
    if (e != cudaSuccess) return (int)e;                                     \
    conv3x3_mma_kernel<NC><<<(unsigned)(tiles * NC), kCtaThreads, kSmem,     \
                             stream>>>(                                      \
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)out, rout,    \
        nb, h, wd, cin, cout, use_pn, slope, eps);                           \
    return (int)cudaGetLastError();                                          \
  }
  PGX_MMA_CASE(1)
  PGX_MMA_CASE(2)
  PGX_MMA_CASE(4)
#undef PGX_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

int dispatch(const void* x, const void* w, const void* b, void* out,
             float* rout, int nb, int h, int wd, int cin, int cout, int dtype,
             int use_pn, float slope, float eps, void* stream) {
  if (cin <= 0 || cin % 8 != 0 || cout <= 0 || cout % 8 != 0 || cout > 512)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)nb * h * wd == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pgx::kFloat32)
    return launch_fma(x, w, b, out, rout, nb, h, wd, cin, cout, use_pn, slope,
                      eps, s);
  if (dtype == pgx::kBFloat16)
    return launch_mma(x, w, b, out, rout, nb, h, wd, cin, cout, use_pn, slope,
                      eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (nb, h, wd, cin) NHWC; out: (nb, h, wd, cout); b: (cout,).
// w, pre-scaled: f32 as [9][cin][cout]; bf16 as [9][cout_pad][cin] with
// cout_pad the next of 128, 256, 512 at or above cout, zero rows past
// cout (pgx_conv3x3_cout_pad returns it).
extern "C" int pgx_conv3x3_cout_pad(int cout) { return mma_cout_pad(cout); }

extern "C" int pgx_conv3x3_epilogue(const void* x, const void* w,
                                    const void* b, void* out, int nb, int h,
                                    int wd, int cin, int cout, int dtype,
                                    int use_pn, float slope, float eps,
                                    void* stream) {
  return dispatch(x, w, b, out, nullptr, nb, h, wd, cin, cout, dtype, use_pn,
                  slope, eps, stream);
}

// The differentiated forward: the same conv + bias + pixel-norm + lrelu,
// and r: (nb, h, wd, 1) f32, the pixel-norm scale of each output pixel.
extern "C" int pgx_conv3x3_epilogue_r(const void* x, const void* w,
                                      const void* b, void* out, void* r,
                                      int nb, int h, int wd, int cin,
                                      int cout, int dtype, float slope,
                                      float eps, void* stream) {
  if (r == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(x, w, b, out, (float*)r, nb, h, wd, cin, cout, dtype, 1,
                  slope, eps, stream);
}
