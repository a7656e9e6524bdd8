// Grouped (ragged expert) GEMM for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/grouped_gemm.py:32 grouped_gemm
// (body _kernel): out[r] = x[r] @ w[expert(r)] with float32 accumulation,
// rounded once to x's type.  The TPU kernel takes tokens padded so that
// every expert's segment is a whole number of block_t rows; this one takes
// the ragged layout of a Hopper grouped GEMM instead:
//   x (N, K) row-major, its rows sorted by expert;
//   w (E, K, F) row-major (F contiguous: the reference's parameter layout,
//   never transposed or copied);
//   offsets (E + 1,) int32 on the device: expert e owns rows
//   [offsets[e], offsets[e + 1]).
// Every variant writes the whole output: the rows outside every segment
// ([0, offsets[0]) and [offsets[E], N), the pairs the MoE block dropped)
// come out zero, so the wrapper allocates it with torch.empty.  No variant
// reads the offsets on the host.  Two variants, picked by the wrapper from
// dtype and alignment (grouped_gemm.py:_variant):
//
// 1. wgmma (bf16, K % 8 == 0, F % 8 == 0, 16-byte-aligned x and w): the
//    prefill and the decode products.  Bound at qwen3-moe-30b-a3b's served
//    gate product (20,876 kept rows over 128 experts, K = 2048, F = 768) by
//    bytes: 520 MB, 403 of them the experts' weights, 0.155 ms at 3.35
//    TB/s, against 65.7 GFLOP, 0.066 ms on the bf16 tensor cores.  At a
//    decode step (32 pairs over at most 32 of the 128 experts) a tile holds
//    a row or two, and the work is streaming the touched experts' weights
//    (at most 32 x 3.15 MB, 0.030 ms), which the same TMA ring does.  So
//    the design is tensor cores fed by TMA, and weights read from HBM about
//    once:
//    - a CTA computes a 128 x 256 tile (row tile of one expert's segment,
//      column tile) with two consumer warpgroups of 64 rows, each running
//      two wgmma.mma_async m64n128k16 bf16 a k16 step into float32
//      registers, one K tile's group kept in flight while the next is
//      issued, and one producer warp keeping a 4-stage ring of TMA loads
//      in flight (A: 128 x 64 of x; B: four 64 x 64 boxes of w[e]), each
//      stage signalled by a full and an empty mbarrier (warp
//      specialisation).  At the served shapes the tiles are read from L2
//      (weights about twice, x once per column tile), so the wide tile
//      halves the x traffic of a 128 x 128 one;
//    - both operands 128-byte swizzled by TMA (CU_TENSOR_MAP_SWIZZLE_128B),
//      A K-major, B MN-major read with wgmma's transpose bit (tnspB = 1):
//      its descriptor's LBO is the stride between 64-column chunks (8 KB),
//      SBO the stride between groups of 8 K rows (1 KB);
//    - w is mapped as 3-D (F, K, E), so a K tail is zero-filled, never read
//      from the next expert; x as 2-D (K, N): a row tile starts at an
//      arbitrary offsets[e] + t * 128, rows past N are zero-filled, rows of
//      the next expert are loaded and masked at the store;
//    - the float32 sum stays in the wgmma accumulator over all of K (bf16
//      only: one bf16 ulp, rtol 2^-7, holds the rounding; float32 goes to
//      the SIMT variant, whose K tiles are summed apart);
//    - launch order: the column tiles of one row tile are neighbours, and
//      an expert's row tiles follow each other, so the ~12 CTAs that read
//      one expert's weights run together and its 3 MB stay in the 50 MB L2;
//    - each CTA finds its (expert, row tile) from offsets on the device
//      (find_tile: a warp prefix sum of the experts' tile counts).
// 2. simt (float32, prefill and decode; bf16 shapes that TMA does not
//    take, such as K = 100 or F = 77): 128 x 128 tiles of float32 FMAs,
//    8 x 8 outputs a thread, A and B in shared memory as float32,
//    double-buffered, each K tile summed apart.  TF32 wgmma would break the
//    float32 2e-5 limit.
//
// Tricks from the guides (cuda_guide.md, hopper-kernels): TMA with a
// __grid_constant__ CUtensorMap, 128-byte swizzle matched by the wgmma
// descriptor, mbarrier full/empty rings with phase parity, producer warp /
// consumer warpgroups, wgmma.fence before wgmma on rewritten accumulators,
// compile-time indices for every register array, dynamic shared memory
// above 48 KB through cudaFuncSetAttribute.  The wgmma, TMA, mbarrier and
// fence PTX is in hopper_common.cuh; find_tile and zero_outside, which the
// backward shares, in grouped_gemm_common.cuh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "grouped_gemm_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace grouped;

// ---------------------------------------------------------------- simt

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    grouped_gemm_simt(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ offsets, T* __restrict__ out, int N, int K, int F,
                      int E) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kColThreads = BN / TN;  // threads along a row of the tile
  constexpr int kRowThreads = BM / TM;
  constexpr int kAPer = BM * BK / kThreads;
  constexpr int kBPer = BK * BN / kThreads;
  constexpr int kAPad = BM + 4;  // A is stored transposed; the pad spreads its stores
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "tile vs threads");
  static_assert(kThreads % 32 == 0, "whole warps");

  __shared__ int info[3];
  __shared__ float As[2][BK][kAPad];
  __shared__ float Bs[2][BK][BN];

  const int col0 = blockIdx.y * BN;
  zero_outside(out, offsets, N, F, E, blockIdx.x * BM, blockIdx.x * BM + BM, col0, col0 + BN,
               kThreads);
  if (threadIdx.x < 32) find_tile<BM>(offsets, E, N, blockIdx.x, info);
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;  // the same for every thread of the CTA
  const int row0 = info[1], row_end = info[2];
  const T* __restrict__ we = w + static_cast<size_t>(e) * K * F;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;

  float a_reg[kAPer], b_reg[kBPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int idx = tid + i * kThreads;
      const int r = row0 + idx / BK, k = k0 + idx % BK;
      a_reg[i] = (r < row_end && k < K) ? to_f32(x[static_cast<size_t>(r) * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kThreads;
      const int k = k0 + idx / BN, c = col0 + idx % BN;
      b_reg[i] = (k < K && c < F) ? to_f32(we[static_cast<size_t>(k) * F + c]) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int idx = tid + i * kThreads;
      As[buf][idx % BK][idx / BK] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kThreads;
      Bs[buf][idx / BN][idx % BN] = b_reg[i];
    }
  };

  // Thread (ty, tx) owns rows ty + i * kRowThreads and columns
  // tx + j * kColThreads: a warp's reads of a row of As are one or two
  // broadcasts, of a row of Bs consecutive floats.
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
    // A K tile's products are summed apart, then added to the accumulator:
    // the running sum rounds K / BK times instead of K times, so its
    // float32 error against another order of the sums falls by about
    // sqrt(BK) (K = 2048 at qwen3-moe-30b-a3b's gate and up products).
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[buf][kk][ty + i * kRowThreads];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[buf][kk][tx + j * kColThreads];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    // The other buffer was last read before the previous barrier.
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * kRowThreads;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * kColThreads;
      if (c < F) store(out + static_cast<size_t>(r) * F + c, acc[i][j]);
    }
  }
}

template <typename T>
int launch_simt(const void* x, const void* w, const void* offsets, void* out, int N, int K, int F,
                int E, cudaStream_t st) {
  constexpr int BM = 128, BN = 128;
  const long long row_tiles = (static_cast<long long>(N) + BM - 1) / BM + E;
  const long long col_tiles = (static_cast<long long>(F) + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  grouped_gemm_simt<T, BM, BN, 8, 8, 8><<<grid, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(offsets),
      static_cast<T*>(out), N, K, F, E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int kConsumers = 2;                      // warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32;    // and one producer warp
constexpr int kNSub = BN / 128;                    // m64n128k16 products a k16 step
constexpr int kATile = BM * BK * 2;                // 16 KB: 128 rows of 128 bytes
constexpr int kBBox = BK * 64 * 2;                 // 8 KB: 64 K rows x 64 columns
constexpr int kStage = kATile + (BN / 64) * kBBox; // 48 KB
constexpr int kSmem = STAGES * kStage + 1024;      // and room to align to 1 KB: 193 KB
static_assert(BK * 2 == 128, "a K tile row of A is one 128-byte swizzle row");
}  // namespace wg

__global__ void __launch_bounds__(wg::kThreads, 1)
    grouped_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                       __nv_bfloat16* __restrict__ out, int N, int K, int F, int E,
                       int col_tiles) {
  using namespace wg;
  using namespace hopper;
  __shared__ int info[3];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t smem_raw[];
  // Swizzle atoms must start 1024-byte aligned in the shared window.
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);

  const int slot = blockIdx.x / col_tiles;  // column tiles of a row tile are neighbours
  const int col0 = (blockIdx.x % col_tiles) * BN;
  zero_outside(out, offsets, N, F, E, slot * BM, slot * BM + BM, col0, col0 + BN, kThreads);
  if (threadIdx.x < 32) find_tile<BM>(offsets, E, N, slot, info);
  if (threadIdx.x == 32) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer's arrive.expect_tx
      mbar_init(&empty[s], kConsumers * 4);     // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;  // the same for every thread of the CTA
  const int row0 = info[1], row_end = info[2];
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == kConsumers * 4) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // the first round passes at once
        uint8_t* st = smem + s * kStage;
        mbar_arrive_expect_tx(&full[s], kStage);
        tma_load_2d(st, &xmap, &full[s], kt * BK, row0);
        for (int b = 0; b < BN / 64; ++b)
          tma_load_3d(st + kATile + b * kBBox, &wmap, &full[s], col0 + 64 * b, kt * BK, e);
      }
    }
    return;
  }

  const int g = warp / 4;  // this warpgroup's rows: [64 g, 64 g + 64) of the tile
  float acc[kNSub][64];
#pragma unroll
  for (int n = 0; n < kNSub; ++n)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* st = smem + s * kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 K columns are 32 bytes along the swizzled row; B: 16 K rows
      // are 2 KB down each 64-column box (two swizzle atoms), and a product
      // of 128 columns spans two boxes, LBO apart.
      const uint64_t da = smem_desc_b128(st + g * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
      for (int n = 0; n < kNSub; ++n) {
        const uint64_t db =
            smem_desc_b128(st + kATile + 2 * n * kBBox + kk * 16 * 128, kBBox, 1024);
        wgmma_m64n128k16_bf16_kmaj_mnmaj(acc[n], da, db);
      }
    }
    wgmma_commit();
    // One K tile's products stay in flight while the next tile's are
    // issued; once the previous tile's are done, its stage goes back to
    // the producer.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt + STAGES - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // The m64nNk16 fragment: acc[n][4 j + 2 h + b] is row 16 (warp % 4) +
  // lane / 4 + 8 h, column 128 n + 8 j + 2 (lane % 4) + b of the
  // warpgroup's tile.
  const int r_base = row0 + g * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < kNSub; ++n) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // c is even, and so is F: c < F means c + 1 < F.
      const int c = col0 + 128 * n + j * 8 + (lane % 4) * 2;
      if (c >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + 8 * h;
        if (r < row_end)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * F + c) =
              __floats2bfloat162_rn(acc[n][4 * j + 2 * h], acc[n][4 * j + 2 * h + 1]);
      }
    }
  }
}

int launch_wgmma(const void* x, const void* w, const void* offsets, void* out, int N, int K, int F,
                 int E, cudaStream_t st) {
  using namespace wg;
  if (K % 8 || F % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const long long slots = (static_cast<long long>(N) + BM - 1) / BM + E;
  const long long col_tiles = (static_cast<long long>(F) + BN - 1) / BN;
  if (slots * col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(E)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(F) * 2,
                                  static_cast<cuuint64_t>(K) * F * 2};
  const cuuint32_t wbox[3] = {64, BK, 1};
  int rc = hopper::encode_bf16_b128(&xmap, const_cast<void*>(x), 2, xdims, xstrides, xbox);
  if (rc == 0)
    rc = hopper::encode_bf16_b128(&wmap, const_cast<void*>(w), 3, wdims, wstrides, wbox);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(grouped_gemm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
  if (rc != 0) return rc;
  grouped_gemm_wgmma<<<static_cast<unsigned>(slots * col_tiles), kThreads, kSmem, st>>>(
      xmap, wmap, static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out), N, K, F, E,
      static_cast<int>(col_tiles));
  return (int)cudaGetLastError();
}

// Variant codes, as grouped_gemm.py's _VARIANT_CODES.
enum Variant { kSimt = 0, kWgmma = 1 };

template <typename T>
int dispatch(const void* x, const void* w, const void* offsets, void* out, int N, int K, int F,
             int E, int variant, void* stream) {
  if (N < 0 || K < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kSimt:
      return launch_simt<T>(x, w, offsets, out, N, K, F, E, st);
    case kWgmma:
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_wgmma(x, w, offsets, out, N, K, F, E, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, K), w (E, K, F), out (N, F), contiguous, of one type; offsets
// (E + 1,) int32, nondecreasing, each clamped into [0, N].  `variant`: 0
// simt, 1 wgmma (bf16 only).  Returns the CUDA error code of the launch (0
// on success; cudaErrorInvalidValue for a variant that does not take the
// shapes).
extern "C" int grouped_gemm_f32(const void* x, const void* w, const void* offsets, void* out,
                                int N, int K, int F, int E, int variant, void* stream) {
  return dispatch<float>(x, w, offsets, out, N, K, F, E, variant, stream);
}

extern "C" int grouped_gemm_bf16(const void* x, const void* w, const void* offsets, void* out,
                                 int N, int K, int F, int E, int variant, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, offsets, out, N, K, F, E, variant, stream);
}
