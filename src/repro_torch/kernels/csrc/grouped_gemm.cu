// Grouped (ragged expert) GEMM for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/grouped_gemm.py:grouped_gemm
// (body _kernel): out[r] = x[r] @ w[expert(r)] with float32 accumulation,
// rounded once to x's type.  The TPU kernel takes tokens padded so that
// every expert's segment is a whole number of block_t rows; this one takes
// the ragged layout of a Hopper grouped GEMM instead:
//   x (N, K) row-major, its rows sorted by expert;
//   w (E, K, F) row-major;
//   offsets (E + 1,) int32 on the device: expert e owns rows
//   [offsets[e], offsets[e + 1]).
// Rows outside every segment are not written (the wrapper zeroes them).
// Padding each segment to 128 rows would turn decode's 32 (token, choice)
// pairs into up to 32 x 128 rows of work.
//
// Bound on an H100 SXM at qwen3-moe-30b-a3b's served products (bf16,
// 128 experts): at prefill (N about 32,768 pairs, K = 2048, F = 768) the
// gate product reads x (134 MB) and every expert's weights (403 MB) and
// writes 50 MB: 587 MB, 0.175 ms at 3.35 TB/s, against 103 GFLOP, 0.104
// ms on the tensor cores: bytes-bound.  At decode (32 pairs) only the
// weights of the touched experts count: up to 32 x 3.1 MB.
//
// Design.  SIMT, float32 accumulators in registers (each K tile summed
// apart, then added to them), A and B tiles in shared memory as float32,
// double-buffered, the next tile prefetched into registers while the
// current one is multiplied.  The grid is
// (ceil(N / BM) + E, ceil(F / BN)): the sum over experts of
// ceil(rows_e / BM) is at most ceil(N / BM) + E - 1, so every row tile has
// a CTA, and each CTA finds its (expert, row tile) from offsets on the
// device (warp 0: a prefix sum of the experts' tile counts by shuffles),
// with no host sync.  CTAs past the last tile, and so empty experts, exit
// at once.  Rows past a segment's end and columns past F are masked; K
// and F need no alignment.  Two tile shapes: 128 x 128 (8 x 8 outputs a
// thread, 256 threads) when segments are long, as at prefill; 16 x 64
// (2 x 4 outputs, 128 threads, 32-deep K tiles) when they are a few rows,
// as at decode, where the weights' bytes are all the work.  Tensor cores
// (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Warp 0 finds row tile `tile` (of BM rows) among the experts' segments and
// writes (expert, first row, end row) to info, expert -1 past the last tile.
// Each lane sums the tile counts of a contiguous run of experts; an
// inclusive scan over the lanes by shuffles gives each run's first tile.
template <int BM>
__device__ void find_tile(const int* __restrict__ offsets, int E, int N, int tile, int* info) {
  const int lane = threadIdx.x;
  const int per = (E + 31) / 32;
  const int e0 = min(E, lane * per), e1 = min(E, e0 + per);
  int local = 0;
  for (int e = e0; e < e1; ++e) {
    const int lo = min(max(offsets[e], 0), N);
    const int hi = min(max(offsets[e + 1], lo), N);
    local += (hi - lo + BM - 1) / BM;
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const bool mine = tile >= incl - local && tile < incl;
  if (mine) {
    int t = tile - (incl - local);
    for (int e = e0; e < e1; ++e) {
      const int lo = min(max(offsets[e], 0), N);
      const int hi = min(max(offsets[e + 1], lo), N);
      const int n = (hi - lo + BM - 1) / BM;
      if (t < n) {
        info[0] = e;
        info[1] = lo + t * BM;
        info[2] = hi;
        break;
      }
      t -= n;
    }
  }
  if (__ballot_sync(0xffffffffu, mine) == 0 && lane == 0) info[0] = -1;
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ offsets, T* __restrict__ out, int N, int K,
                        int F, int E) {
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

  if (threadIdx.x < 32) find_tile<BM>(offsets, E, N, blockIdx.x, info);
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;  // the same for every thread of the CTA
  const int row0 = info[1], row_end = info[2];
  const int col0 = blockIdx.y * BN;
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

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w, const void* offsets, void* out, int N, int K, int F,
           int E, cudaStream_t st) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  const long long row_tiles = (static_cast<long long>(N) + BM - 1) / BM + E;
  const long long col_tiles = (static_cast<long long>(F) + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  grouped_gemm_kernel<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(offsets),
      static_cast<T*>(out), N, K, F, E);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* offsets, void* out, int N, int K, int F,
             int E, int large, void* stream) {
  if (N < 0 || K < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (large) return launch<T, 128, 128, 8, 8, 8>(x, w, offsets, out, N, K, F, E, st);
  return launch<T, 16, 64, 32, 2, 4>(x, w, offsets, out, N, K, F, E, st);
}

}  // namespace

// x (N, K), w (E, K, F), out (N, F), contiguous, of one type; offsets
// (E + 1,) int32, nondecreasing, each clamped into [0, N]; `large` picks
// the 128 x 128 tile (long segments) over the 16 x 64 one.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int grouped_gemm_f32(const void* x, const void* w, const void* offsets, void* out,
                                int N, int K, int F, int E, int large, void* stream) {
  return dispatch<float>(x, w, offsets, out, N, K, F, E, large, stream);
}

extern "C" int grouped_gemm_bf16(const void* x, const void* w, const void* offsets, void* out,
                                 int N, int K, int F, int E, int large, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, offsets, out, N, K, F, E, large, stream);
}
