// The grouped (ragged expert) GEMM's backward for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes.
//
// No Pallas kernel computes it: the reference takes these gradients with
// jax.grad through its capacity-buffer einsums (src/repro/models/moe.py:133-138),
// whose forward the Pallas grouped_gemm (src/repro/kernels/grouped_gemm.py:32)
// computes and grouped_gemm.cu ports.  For that forward,
// out[r] = x[r] @ w[e(r)], and dy = d(loss)/d(out) of shape (N, F):
//   dx[r] = dy[r] @ w[e(r)]^T   (N, K): the rows outside every segment (the
//           pairs the MoE block dropped) come out zero;
//   dw[e] = x[seg_e]^T @ dy[seg_e]   (E, K, F): an expert whose segment is
//           empty gets a zero dw, written like any other.
// Layouts are the forward's: x (N, K) and dy (N, F) row-major with their
// rows sorted by expert; w and dw (E, K, F) row-major; offsets (E + 1,)
// int32 on the device, expert e owning rows [offsets[e], offsets[e + 1]),
// each bound clamped into [0, N].  Neither kernel reads the offsets on the
// host.
//
// Bound.  At qwen3-moe-30b-a3b's training call (B 1 x S 4096: 32,768
// (token, choice) pairs over 128 experts, some 30,000 kept, K 2048, F 768
// for gate and up, K 768, F 2048 for down), each launch moves an expert
// stack (403 MB in bf16, read by dx, written by dw) and the row operands
// (dy and dx, or x and dy: about 0.18 GB): some 0.59 GB, 0.175 ms at 3.35
// TB/s, against 2 N K F = 103 GFLOP, 0.104 ms on the bf16 tensor cores or
// 1.54 ms at float32's 67 TFLOP/s.  So bytes bound bf16, operations bound
// float32.
//
// Design: correct and simple first.  Both kernels are 128 x 128 output
// tiles of float32 FMAs (8 x 8 outputs a thread, 256 threads), the A and B
// tiles staged in shared memory as float32 (a bf16 element widens exactly,
// and so does the product of two), double-buffered, each tile of 8
// contraction steps summed apart before it joins the accumulator (as the
// forward's simt kernel sums its K tiles).  In float32 nothing goes
// through TF32, which would break the 2e-5 limit.  No float atomics: every
// output element is one thread's sum in a fixed order, so a repeat is bit
// for bit.  The tensor cores (wgmma, as the forward's bf16 kernel) are
// later work: in bf16 both kernels are held by the float32 FMA rate, some
// 9x their bytes bound.
//
// 1. dx: the forward's grouped GEMM by each expert's transposed weights.
//    A CTA takes a (row tile of one expert's segment, K tile), found on the
//    device by the forward's find_tile, and zeroes its rows outside every
//    segment with the forward's zero_outside (grouped_gemm_common.cuh).
//    It walks F: A(m, t) = dy[row0 + m, t], B(t, n) = w[e, col0 + n, t],
//    both contiguous along t, so each is read 8 t a row and stored
//    transposed (a pad of 4 floats spreads the stores over the banks).
// 2. dw: one CTA per (expert, K tile, F tile), the F tiles of a K tile
//    neighbours and an expert's tiles together, so an expert's rows of x
//    and dy stay in L2 while its tiles run.  It walks that expert's rows in
//    order, A(m, t) = x[lo + t, k0 + m], B(t, n) = dy[lo + t, f0 + n], both
//    read along the tile's width, and masks the rows past its segment
//    (those of its neighbour).  TMA's zero fill cannot do that masking
//    inside a box that straddles two segments, so the loads are plain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "grouped_gemm_common.cuh"

namespace {

using namespace grouped;

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kColThreads = BN / TN;              // threads along a row of the tile
constexpr int kRowThreads = BM / TM;
constexpr int kPer = BM * BK / kThreads;          // elements of A (and of B) a thread a step
constexpr int kPad = 4;
static_assert(BM == BN, "dx's loads index A's rows and B's columns alike");
static_assert(BM * BK % kThreads == 0 && kThreads % 32 == 0, "tile vs threads");

// The two shared tiles, t (the contraction) outermost, double-buffered.
struct Tiles {
  float a[2][BK][BM + kPad];
  float b[2][BK][BN + kPad];
};

// acc[i][j] = sum over t in [0, len) of A(ty + i kRowThreads, t) B(t, tx +
// j kColThreads), thread (ty, tx).  fetch(t0, ra, rb) reads this thread's
// kPer elements of A's and of B's tile at t0 into registers (zero past the
// ends); put(buf, ra, rb) writes them to tile buffer buf.  len is the same
// for every thread of the CTA.
template <class Fetch, class Put>
__device__ __forceinline__ void mainloop(Tiles& s, int len, Fetch fetch, Put put,
                                         float (&acc)[TM][TN]) {
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (len <= 0) return;
  float ra[kPer], rb[kPer];
  fetch(0, ra, rb);
  put(0, ra, rb);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < len; t0 += BK) {
    const bool more = t0 + BK < len;
    if (more) fetch(t0 + BK, ra, rb);
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[buf][kk][ty + i * kRowThreads];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[buf][kk][tx + j * kColThreads];
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
    if (more) put(buf ^ 1, ra, rb);
    __syncthreads();
    buf ^= 1;
  }
}

// Writes thread (ty, tx)'s outputs of the tile at (row0, col0) of a
// row-major (rows, cols) array, rows below row_end and columns below cols.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, const float (&acc)[TM][TN],
                                           int row0, int row_end, int col0, int cols) {
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * kRowThreads;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * kColThreads;
      if (c < cols) store(out + static_cast<size_t>(r) * cols + c, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- dx

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_bwd_dx(const T* __restrict__ dy, const T* __restrict__ w,
                        const int* __restrict__ offsets, T* __restrict__ dx, int N, int K, int F,
                        int E) {
  __shared__ int info[3];
  __shared__ Tiles s;
  const int col0 = blockIdx.y * BN;  // dx's columns: K
  zero_outside(dx, offsets, N, K, E, blockIdx.x * BM, blockIdx.x * BM + BM, col0, col0 + BN,
               kThreads);
  if (threadIdx.x < 32) find_tile<BM>(offsets, E, N, blockIdx.x, info);
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;  // the same for every thread of the CTA
  const int row0 = info[1], row_end = info[2];
  const T* __restrict__ we = w + static_cast<size_t>(e) * K * F;
  const int tid = threadIdx.x;

  auto fetch = [&](int t0, float (&ra)[kPer], float (&rb)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / BK, t = t0 + idx % BK;
      const int r = row0 + m, c = col0 + m;
      ra[i] = (r < row_end && t < F) ? to_f32(dy[static_cast<size_t>(r) * F + t]) : 0.f;
      rb[i] = (c < K && t < F) ? to_f32(we[static_cast<size_t>(c) * F + t]) : 0.f;
    }
  };
  auto put = [&](int buf, const float (&ra)[kPer], const float (&rb)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      s.a[buf][idx % BK][idx / BK] = ra[i];
      s.b[buf][idx % BK][idx / BK] = rb[i];
    }
  };
  float acc[TM][TN];
  mainloop(s, F, fetch, put, acc);
  store_tile(dx, acc, row0, row_end, col0, K);
}

// ---------------------------------------------------------------- dw

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_bwd_dw(const T* __restrict__ x, const T* __restrict__ dy,
                        const int* __restrict__ offsets, T* __restrict__ dw, int N, int K, int F,
                        int k_tiles, int f_tiles) {
  __shared__ Tiles s;
  const int per_expert = k_tiles * f_tiles;
  const int e = blockIdx.x / per_expert;
  const int tile = blockIdx.x % per_expert;
  const int k0 = (tile / f_tiles) * BM, f0 = (tile % f_tiles) * BN;
  const int lo = min(max(offsets[e], 0), N);
  const int hi = min(max(offsets[e + 1], lo), N);
  const int tid = threadIdx.x;

  auto fetch = [&](int t0, float (&ra)[kPer], float (&rb)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      const int r = lo + t0 + idx / BM, m = idx % BM;
      const bool row = r < hi;  // rows from hi on are the next expert's
      ra[i] = (row && k0 + m < K) ? to_f32(x[static_cast<size_t>(r) * K + k0 + m]) : 0.f;
      rb[i] = (row && f0 + m < F) ? to_f32(dy[static_cast<size_t>(r) * F + f0 + m]) : 0.f;
    }
  };
  auto put = [&](int buf, const float (&ra)[kPer], const float (&rb)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      s.a[buf][idx / BM][idx % BM] = ra[i];
      s.b[buf][idx / BN][idx % BN] = rb[i];
    }
  };
  float acc[TM][TN];
  mainloop(s, hi - lo, fetch, put, acc);  // an empty segment leaves acc zero
  store_tile(dw + static_cast<size_t>(e) * K * F, acc, k0, K, f0, F);
}

template <typename T>
int launch_dx(const void* dy, const void* w, const void* offsets, void* dx, int N, int K, int F,
              int E, void* stream) {
  if (N < 0 || K < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const long long row_tiles = (static_cast<long long>(N) + BM - 1) / BM + E;
  const long long col_tiles = (static_cast<long long>(K) + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  grouped_gemm_bwd_dx<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const int*>(offsets),
      static_cast<T*>(dx), N, K, F, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, const void* offsets, void* dw, int N, int K, int F,
              int E, void* stream) {
  if (N < 0 || K < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const long long k_tiles = (static_cast<long long>(K) + BM - 1) / BM;
  const long long f_tiles = (static_cast<long long>(F) + BN - 1) / BN;
  const long long blocks = static_cast<long long>(E) * k_tiles * f_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grouped_gemm_bwd_dw<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const int*>(offsets),
      static_cast<T*>(dw), N, K, F, static_cast<int>(k_tiles), static_cast<int>(f_tiles));
  return (int)cudaGetLastError();
}

}  // namespace

// dx (N, K) from dy (N, F), w (E, K, F) and offsets (E + 1,) int32: every
// row written, zero outside the segments.  dw (E, K, F) from x (N, K), dy
// and offsets: every expert written, zero for an empty segment.  All
// contiguous, x, dy, w, dx and dw of one type.  Returns the CUDA error code
// of the launch (0 on success; cudaErrorInvalidValue for shapes the
// launch cannot take).
extern "C" int grouped_gemm_dx_f32(const void* dy, const void* w, const void* offsets, void* dx,
                                   int N, int K, int F, int E, void* stream) {
  return launch_dx<float>(dy, w, offsets, dx, N, K, F, E, stream);
}

extern "C" int grouped_gemm_dx_bf16(const void* dy, const void* w, const void* offsets, void* dx,
                                    int N, int K, int F, int E, void* stream) {
  return launch_dx<__nv_bfloat16>(dy, w, offsets, dx, N, K, F, E, stream);
}

extern "C" int grouped_gemm_dw_f32(const void* x, const void* dy, const void* offsets, void* dw,
                                   int N, int K, int F, int E, void* stream) {
  return launch_dw<float>(x, dy, offsets, dw, N, K, F, E, stream);
}

extern "C" int grouped_gemm_dw_bf16(const void* x, const void* dy, const void* offsets, void* dw,
                                    int N, int K, int F, int E, void* stream) {
  return launch_dw<__nv_bfloat16>(x, dy, offsets, dw, N, K, F, E, stream);
}
