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
// The pixel norm reduces over all of Cout, so a block (or a cluster of two)
// owns a tile of output pixels and every output channel (Cout <= 512), and
// the epilogue runs on the accumulators before the single store: the
// pre-activation never reaches device memory.  Taps that fall outside the
// image are zero-filled by the copy itself, so no padded copy of x is made.
//
// * bf16: Hopper's warpgroup MMA fed by the tensor memory accelerator.
//   A CTA of 384 threads computes 128 output pixels x BN output channels:
//   two consumer warpgroups of 64 pixels each (wgmma.mma_async m64nBNk16,
//   f32 accumulators in registers, 232 registers a thread by setmaxnreg)
//   and one producer warpgroup, of which one thread issues the copies.
//   C_out is padded to CP in {128, 256, 512}: BN = CP with one CTA per tile
//   for CP <= 256; for CP = 512 a cluster of two CTAs shares the tile and
//   splits the channels (256 each).
//   - The pixel tile is a box (bt, th, tw) of images x rows x columns with
//     bt*th*tw = 128 (tile_geom: (8,4,4) at 4 px, (2,8,8) at 8 px, (1,8,16)
//     at 16 px, (1,4,32) at 32 px, ...).  Each K step copies, by 4-D TMA
//     loads of the NHWC tensor, the box shifted by the tap (dy, dx) with 64
//     input channels: TMA fills the elements past any edge (or past the
//     batch) with zeros, which is the SAME padding, and the rows of pixels
//     past the edge are masked at the store.  In a cluster each CTA loads
//     one half of the box (64 pixels) and multicasts it to both.
//   - The weight tile, [BN][64] of the [9][CP][Cin] weights, by 2-D TMA.
//     Rows of 64 bf16 are 128 bytes, so both tiles use the 128-byte swizzle
//     that wgmma's K-major operands read without bank conflicts.
//   - K runs over 9 taps x ceil(Cin / 64) chunks through a 4-stage ring in
//     shared memory (16 KB of pixels + BN x 128 B of weights a stage);
//     full/empty mbarrier pairs replace __syncthreads.  A consumer keeps one
//     group of wgmmas in flight and frees a stage when the group reading it
//     has retired; the empty barrier of a stage counts both warpgroups of
//     both CTAs of a cluster, since the multicast writes into each.
//   - Persistent: as many clusters as fit on the card walk the tiles, and
//     the ring runs on across tiles, so the producer loads the next tile
//     while the consumers run this one's epilogue.
//   - Epilogue: bias, each row's sum of squares by quad shuffles in the
//     accumulator layout; in a cluster the two halves of each row's sum are
//     swapped through distributed shared memory (st.async completing on
//     the peer's mbarrier, double-buffered by tile); then scale, leaky-ReLU
//     and the bf16 store.
//   - Tensor maps are encoded on the host for each launch with
//     cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (the
//     library links only -lcudart), and passed as __grid_constant__.
// * f32: CUDA-core FMA (the tensor cores have no full-f32 path).  Block = 64
//   pixels x C_out padded to 32*CPT, 8 warps of 8 pixels, lane l owns
//   channels l + 32j; K steps of 16 input channels double-buffered with
//   cp.async.  Weights come as [9][Cin][Cout].
//
// Both kernels take an optional `rout`: when it is not null (the
// differentiated forward, conv3x3_epilogue_fwd(..., emit_r=True)) the
// pixel-norm scale r = rsqrt(mean_c(a^2) + eps) of every output pixel is also
// written, as (nb, h, wd, 1) f32.  It is the only residual the backward needs
// beside the output itself.  Every channel slice of a tile holds the summed
// statistic after the reduction; the first alone writes r.
#include <cuda.h>

#include "common.cuh"

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
// bf16 kernel: wgmma + TMA, warp-specialised, persistent, clusters of 1-2
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;            // output pixels per CTA
constexpr int kWgBK = 64;             // input channels per K step (128 B)
constexpr int kWgStages = 4;          // depth of the shared-memory ring
constexpr int kWgThreads = 384;       // 2 consumer warpgroups + 1 producer
constexpr int kWgABytes = kWgBM * kWgBK * 2;   // 16 KB of pixels a stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Polls the phase (test_wait never suspends the thread); a wait that never
// ends (a lost arrival) traps after 2^30 polls, so a fault surfaces as a
// launch error and not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// arrive on the barrier at the same offset in CTA `rank` of the cluster.
// The default (CTA-scope) release: the arrival only frees a stage whose
// reads, by the async proxy, wgmma.wait_group has already retired.  A
// cluster-scope release here stalled the consumer at every stage.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::
                   : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same box into the same offset of every CTA in `mask`, completing on
// the barrier at the same offset in each
__device__ __forceinline__ void tma_load_4d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, uint16_t mask, int c0,
    int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes): 8-row groups
// 1024 bytes apart; the tile starts on a 1024-byte boundary.  A step of 16
// elements along K adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async MMA
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64n256k16, bf16 x bf16 -> f32, both operands K-major
// in shared memory (descriptors), D += A * B in 128 registers.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63,\n"
      " %64, %65, %66, %67, %68, %69, %70, %71,\n"
      " %72, %73, %74, %75, %76, %77, %78, %79,\n"
      " %80, %81, %82, %83, %84, %85, %86, %87,\n"
      " %88, %89, %90, %91, %92, %93, %94, %95,\n"
      " %96, %97, %98, %99, %100, %101, %102, %103,\n"
      " %104, %105, %106, %107, %108, %109, %110, %111,\n"
      " %112, %113, %114, %115, %116, %117, %118, %119,\n"
      " %120, %121, %122, %123, %124, %125, %126, %127},\n"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// wgmma.mma_async m64n128k16, bf16 x bf16 -> f32, both operands K-major
// in shared memory (descriptors), D += A * B in 64 registers.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db);
  else
    wgmma_n128(d, da, db);
}

// The pixel tile: a box of bt images x th rows x tw columns (128 pixels),
// loaded as two halves of 64 pixels, the second `hb, hh, hw` further on.
struct TileGeom {
  int bt, th, tw;        // the tile
  int bt2, th2, tw2;     // one half (the TMA box)
  int hb, hh, hw;        // offset of the second half
  int tiles_h, tiles_w;  // tiles along H and W
};

TileGeom tile_geom(int h, int wd) {
  auto pow2 = [](int v) {
    int p = 1;
    while (p < v) p *= 2;
    return p;
  };
  TileGeom t;
  t.tw = pow2(wd) < kWgBM ? pow2(wd) : kWgBM;
  t.th = pow2(h) < kWgBM / t.tw ? pow2(h) : kWgBM / t.tw;
  t.bt = kWgBM / (t.tw * t.th);
  t.bt2 = t.bt, t.th2 = t.th, t.tw2 = t.tw;
  t.hb = t.hh = t.hw = 0;
  if (t.bt >= 2) {
    t.bt2 = t.hb = t.bt / 2;
  } else if (t.th >= 2) {
    t.th2 = t.hh = t.th / 2;
  } else {
    t.tw2 = t.hw = t.tw / 2;
  }
  t.tiles_h = (h + t.th - 1) / t.th;
  t.tiles_w = (wd + t.tw - 1) / t.tw;
  return t;
}

template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() {
  return kWgABytes + BN * kWgBK * 2;
}
template <int BN>
constexpr int wg_smem_bytes() {
  // ring + full/empty/stat barriers + the peer's [2][128] row sums +
  // alignment slack
  return kWgStages * wg_stage_bytes<BN>() + (2 * kWgStages + 2) * 8 +
         2 * kWgBM * 4 + 1024;
}

// st.async: a 4-byte store into CTA `rank`'s shared memory at the offset of
// `p`, completing 4 bytes of transaction on its barrier at the offset of
// `bar`
__device__ __forceinline__ void st_async_cluster(float* p, float v,
                                                 uint64_t* bar,
                                                 uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [ra], %3, "
      "[rb];\n"
      "}\n" ::"r"(smem_u32(p)),
      "r"(smem_u32(bar)), "r"(rank), "f"(v)
      : "memory");
}

// A cluster of NC CTAs shares one pixel tile; CTA `rank` computes channels
// [rank * BN, (rank + 1) * BN).  The clusters are persistent: cluster c
// takes the tiles c, c + clusters, ..., so the producer loads the next
// tile's first stages while the consumers run the last one's epilogue.
template <int BN, int NC>
__global__ void __cluster_dims__(NC, 1, 1) __launch_bounds__(kWgThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     float* __restrict__ rout, int nb, int h, int wd,
                     int cout, int cp, int kchunks, const TileGeom geo,
                     int tiles, int use_pn, float slope, float eps) {
  static_assert(NC <= 2, "the row sums are exchanged with one peer");
  constexpr int kStage = wg_stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kStage);
  uint64_t* empty = full + kWgStages;
  uint64_t* stat = empty + kWgStages;             // [2] peer's row sums in
  float* peer = reinterpret_cast<float*>(stat + 2);  // [2][BM] written by it

  const int tid = threadIdx.x;
  const uint32_t rank = NC > 1 ? cluster_rank() : 0;
  const int n0 = (int)rank * BN;
  const int KT = 9 * kchunks;
  const int n_clusters = (int)(gridDim.x / NC);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);            // the producer's expect_tx
      mbar_init(&empty[s], 2 * NC);      // each warpgroup of the cluster
    }
    mbar_init(&stat[0], 1);
    mbar_init(&stat[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers exist before any copy lands

  if (tid >= 256) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      int it = 0;  // k steps issued, over all tiles
      for (int tile = (int)(blockIdx.x / NC); tile < tiles;
           tile += n_clusters) {
        const int tw_i = tile % geo.tiles_w;
        const int th_i = (tile / geo.tiles_w) % geo.tiles_h;
        const int tb_i = tile / (geo.tiles_w * geo.tiles_h);
        const int b0 = tb_i * geo.bt, h0 = th_i * geo.th, w0 = tw_i * geo.tw;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % kWgStages;
          mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          unsigned char* st = smem + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          const int tap = kt / kchunks, c0 = (kt % kchunks) * kWgBK;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          // the pixel tile: in a cluster each CTA loads one half for both
          if (NC == 1) {
            tma_load_4d(st, &tm_x, &full[s], c0, w0 + dx, h0 + dy, b0);
            tma_load_4d(st + kWgABytes / 2, &tm_x, &full[s], c0,
                        w0 + geo.hw + dx, h0 + geo.hh + dy, b0 + geo.hb);
          } else {
            const int q = (int)rank;
            tma_load_4d_multicast(st + q * (kWgABytes / 2), &tm_x, &full[s],
                                  (uint16_t)((1 << NC) - 1), c0,
                                  w0 + q * geo.hw + dx, h0 + q * geo.hh + dy,
                                  b0 + q * geo.hb);
          }
          tma_load_2d(st + kWgABytes, &tm_w, &full[s], c0, tap * cp + n0);
        }
      }
    }
    __syncwarp();
    // no CTA leaves while a peer may still signal its barriers
    if (NC > 1) cluster_sync();
  } else {
    // ---- two consumer warpgroups: 64 pixels x BN channels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid >> 7, wtid = tid & 127;
    const int lane = tid & 31, warp = wtid >> 5, q4 = lane & 3;
    // accumulator layout (m64nBN): warp w of the warpgroup holds rows
    // 16w + lane/4 and 16w + lane/4 + 8; acc[4j + e] (e < 2) is column
    // 8j + 2(lane%4) + e of the first row, acc[4j + 2 + e] of the second
    const int ra = wg * 64 + warp * 16 + (lane >> 2);   // and ra + 8
    int it = 0, done = 0;  // k steps consumed, tiles finished
    for (int tile = (int)(blockIdx.x / NC); tile < tiles;
         tile += n_clusters, ++done) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % kWgStages;
        mbar_wait(&full[s], (it / kWgStages) & 1);
        const unsigned char* st = smem + s * kStage;
        const uint64_t da = desc_sw128(st + wg * (kWgABytes / 2));
        const uint64_t db = desc_sw128(st + kWgABytes);
        fence_acc<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kWgBK / 16; ++k)
          wgmma_tile<BN>(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        wgmma_wait<1>();  // the group of the step before has retired
        fence_acc<BN / 2>(acc);
        if (kt > 0 && wtid < NC)
          mbar_arrive_cluster(&empty[(it - 1) % kWgStages], (uint32_t)wtid);
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
      if (wtid < NC)  // the tile's last stage: the next tile needs it
        mbar_arrive_cluster(&empty[(it - 1) % kWgStages], (uint32_t)wtid);

      // epilogue: bias, then each row's sum of squares over its channels
      float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q4;
        const float bv0 = col < cout ? pgx::to_f(bias[col]) : 0.f;
        const float bv1 = col + 1 < cout ? pgx::to_f(bias[col + 1]) : 0.f;
        acc[4 * j] += bv0;
        acc[4 * j + 1] += bv1;
        acc[4 * j + 2] += bv0;
        acc[4 * j + 3] += bv1;
        // padded channels hold exactly 0
        ss0 += acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1];
        ss1 += acc[4 * j + 2] * acc[4 * j + 2] +
               acc[4 * j + 3] * acc[4 * j + 3];
      }
      ss0 += __shfl_xor_sync(0xffffffffu, ss0, 1);
      ss0 += __shfl_xor_sync(0xffffffffu, ss0, 2);
      ss1 += __shfl_xor_sync(0xffffffffu, ss1, 1);
      ss1 += __shfl_xor_sync(0xffffffffu, ss1, 2);
      if (NC == 2) {
        // the other channel slice of this tile holds the rest of each row:
        // swap the sums through its shared memory.  Buffers alternate by
        // tile; the peer cannot reach this buffer's next use (two tiles
        // on) before this tile's read, since it needs this CTA's loads of
        // the tile in between.
        const int buf = done & 1;
        const uint32_t other = 1 - rank;
        if (tid == 0) mbar_expect_tx(&stat[buf], kWgBM * 4);
        if (q4 == 0) {
          st_async_cluster(peer + buf * kWgBM + ra, ss0, &stat[buf], other);
          st_async_cluster(peer + buf * kWgBM + ra + 8, ss1, &stat[buf],
                           other);
        }
        mbar_wait(&stat[buf], (done >> 1) & 1);
        ss0 += peer[buf * kWgBM + ra];
        ss1 += peer[buf * kWgBM + ra + 8];
      }
      const float rr[2] = {use_pn ? rsqrtf(ss0 * (1.f / cout) + eps) : 1.f,
                           use_pn ? rsqrtf(ss1 * (1.f / cout) + eps) : 1.f};
      const int b0 = tile / (geo.tiles_w * geo.tiles_h) * geo.bt;
      const int h0 = (tile / geo.tiles_w) % geo.tiles_h * geo.th;
      const int w0 = tile % geo.tiles_w * geo.tw;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // the row's pixel: half (wg) of the tile, index i in the half box
        const int i = (ra + 8 * hh) & 63;
        const int bb = b0 + wg * geo.hb + i / (geo.th2 * geo.tw2);
        const int yy = h0 + wg * geo.hh + (i / geo.tw2) % geo.th2;
        const int xx = w0 + wg * geo.hw + i % geo.tw2;
        if (bb >= nb || yy >= h || xx >= wd) continue;
        const int64_t m = ((int64_t)bb * h + yy) * wd + xx;
        const float r = rr[hh];
        // every channel slice holds the same r; the first stores it
        if (rout != nullptr && rank == 0 && q4 == 0) rout[m] = r;
        bf16* orow = out + m * cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * q4;
          if (col >= cout) continue;
          __nv_bfloat162 v;
          v.x = __float2bfloat16(pgx::lrelu(acc[4 * j + 2 * hh] * r, slope));
          v.y = __float2bfloat16(
              pgx::lrelu(acc[4 * j + 2 * hh + 1] * r, slope));
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = v;
        }
      }
    }
    if (NC > 1) cluster_sync();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (no link against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// bf16 tensor map, 128-byte swizzle, zeros past every edge
bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                 const cuuint64_t* dims, const cuuint64_t* strides,
                 const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int NC>
int launch_wgmma_cfg(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                     const void* b, void* out, float* rout, int nb, int h,
                     int wd, int cout, int cp, int kchunks,
                     const TileGeom& geo, int use_pn, float slope, float eps,
                     cudaStream_t stream) {
  constexpr int smem = wg_smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (int64_t)((nb + geo.bt - 1) / geo.bt) * geo.tiles_h *
                        geo.tiles_w;
  // as many clusters as fit on the card at once (looked up once), each
  // walking its share of the tiles
  static const int fit = [] {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(NC);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = smem;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, conv3x3_wgmma_kernel<BN, NC>,
                                       &cfg) != cudaSuccess)
      n = 0;
    return n;
  }();
  if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t clusters = tiles < fit ? tiles : fit;
  conv3x3_wgmma_kernel<BN, NC><<<(unsigned)(clusters * NC), kWgThreads, smem,
                                 stream>>>(
      tm_x, tm_w, (const bf16*)b, (bf16*)out, rout, nb, h, wd, cout, cp,
      kchunks, geo, (int)tiles, use_pn, slope, eps);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* x, const void* w, const void* b, void* out,
                 float* rout, int nb, int h, int wd, int cin, int cout,
                 int use_pn, float slope, float eps, cudaStream_t stream) {
  const int cp = mma_cout_pad(cout);
  const int bn = cp < 256 ? cp : 256;
  const TileGeom geo = tile_geom(h, wd);
  const int kchunks = (cin + kWgBK - 1) / kWgBK;
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)wd,
                               (cuuint64_t)h, (cuuint64_t)nb};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 2,
                                  (cuuint64_t)wd * cin * 2,
                                  (cuuint64_t)h * wd * cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)kWgBK, (cuuint32_t)geo.tw2,
                              (cuuint32_t)geo.th2, (cuuint32_t)geo.bt2};
  const cuuint64_t wdims[2] = {(cuuint64_t)cin, (cuuint64_t)9 * cp};
  const cuuint64_t wstrides[1] = {(cuuint64_t)cin * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)kWgBK, (cuuint32_t)bn};
  if (!encode_bf16(&tm_x, x, 4, xdims, xstrides, xbox) ||
      !encode_bf16(&tm_w, w, 2, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  if (cp == 128)
    return launch_wgmma_cfg<128, 1>(tm_x, tm_w, b, out, rout, nb, h, wd,
                                       cout, cp, kchunks, geo, use_pn, slope,
                                       eps, stream);
  if (cp == 256)
    return launch_wgmma_cfg<256, 1>(tm_x, tm_w, b, out, rout, nb, h, wd,
                                       cout, cp, kchunks, geo, use_pn, slope,
                                       eps, stream);
  return launch_wgmma_cfg<256, 2>(tm_x, tm_w, b, out, rout, nb, h, wd,
                                     cout, cp, kchunks, geo, use_pn, slope,
                                     eps, stream);
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
    return launch_wgmma(x, w, b, out, rout, nb, h, wd, cin, cout, use_pn,
                        slope, eps, s);
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
