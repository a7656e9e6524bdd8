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
// host.  No float atomics in either design: every output element is one
// thread's (or one warpgroup's) sum in a fixed order, so a repeat is bit
// for bit.
//
// Bound.  At qwen3-moe-30b-a3b's training call (B 1 x S 4096: 32,768
// (token, choice) pairs over 128 experts, some 32,000 kept, K 2048, F 768
// for gate and up, K 768, F 2048 for down), each launch moves an expert
// stack (403 MB in bf16, read by dx, written by dw) and the row operands
// (dy and dx, or x and dy: about 0.18 GB): some 0.59 GB, 0.175 ms at 3.35
// TB/s, against 2 N K F = 103 GFLOP, 0.104 ms on the bf16 tensor cores or
// 1.54 ms at float32's 67 TFLOP/s.  So bytes bound bf16, operations bound
// float32.  Two designs, picked by the wrapper from dtype and alignment
// (grouped_gemm.py:_bwd_variant), each with a dx and a dw kernel:
//
// 1. wgmma (bf16, K % 8 == 0, F % 8 == 0, 16-byte-aligned x, w, dy and
//    outputs): tensor cores fed by TMA rings, as the forward's bf16 kernel
//    (grouped_gemm.cu, grouped_gemm_wgmma): one producer warp keeps the
//    ring's loads in flight, two consumer warpgroups of 64 output rows run
//    wgmma m64n128k16 into float32 registers (a 128 x 256 tile: 128 floats
//    a thread), every stage with a full and an empty mbarrier, both
//    operands 128-byte swizzled.  The float32 sum stays in the accumulator
//    over the whole contraction and is rounded to bf16 once.
//    - dx: the forward's grid (a row tile of one expert's segment found on
//      the device by find_tile, by a column tile of dx's K; the column
//      tiles of a row tile neighbours in launch order, so an expert's 3 MB
//      of weights stay in L2 while its tiles run) and its 4-stage ring.
//      A(m, t) = dy[row0 + m, t] and B(t, n) = w[e, col0 + n, t] are both
//      K-major (contiguous along the contraction F): dy through a 2-D map
//      (F, N), boxes 64 wide along F by 128 rows (rows past N zero-filled,
//      the next expert's rows masked at the store), w through a 3-D map
//      (F, K, E), boxes 64 along F by 256 along K (a K tail zero-filled,
//      never read from the next expert), tnspB clear.  Rows outside every
//      segment are zeroed by zero_outside.  Held, as the forward, by the
//      weights' bytes from HBM and by the tiles' reads from L2 (weights
//      once a row tile, dy once a column tile).
//    - dw: one output tile is (expert, 128 K rows, 256 F columns); the
//      contraction runs over the expert's rows [lo, hi) in steps of 64
//      from row lo (a TMA coordinate may be any row).  A(m = k, t) =
//      x[lo + t, k] and B(t, n = f) = dy[lo + t, f] are both MN-major:
//      2-D maps (K, N) and (F, N), boxes 64 wide by 64 rows, tnspA = tnspB
//      = 1.  A box can straddle two segments: before the wgmma of a step
//      whose rows reach past hi, the two warpgroups zero those rows (whole
//      128-byte lines, so the swizzle does not enter) in both operands,
//      each its own A box and half of the shared B boxes, fence the writes
//      to the async proxy and sync their 256 threads; zeroing one operand
//      would let a neighbour's Inf or NaN in (0 * Inf is NaN).
//      The contraction is short (205-291 rows an expert at the training
//      routing: 4-5 steps) and dw writes all of its 403 MB whatever the
//      routing, so the epilogue sets the pace: the kernel is persistent
//      (a CTA an SM walks tiles b, b + grid, ...; an expert's tiles run
//      together, its rows of x and dy staying in L2), the producer loads
//      the next tile's stages while the consumers store this one, and the
//      store goes through shared memory by TMA (full 128-byte lines, the
//      threads free once their fragment is written).  An empty expert's
//      tiles issue no loads and store zeros.  Of the designs tried, this
//      one was fastest: a CTA a tile, and the fragments stored straight
//      from registers (the forward's epilogue), were slower.  With the
//      store taken out (scripts/torch_gg_bwd_probe.py, one NVIDIA H100
//      80GB HBM3 at 700 W, the training routing, gate/up and down) it
//      runs 0.219 and 0.221 ms against 0.278 and 0.302, beside a 0.174 ms
//      bound: the store, not the products, holds it.
// 2. simt (float32; bf16 shapes TMA cannot take, such as K 100 or F 77):
//    128 x 128 output tiles of float32 FMAs (8 x 8 outputs a thread, 256
//    threads), the A and B tiles staged in shared memory as float32 (a bf16
//    element widens exactly, and so does the product of two),
//    double-buffered, each tile of 8 contraction steps summed apart before
//    it joins the accumulator (as the forward's simt kernel sums its K
//    tiles).  In float32 nothing goes through TF32, which would break the
//    2e-5 limit: float32 is held by the FMA rate.
//    - dx: a CTA takes a (row tile of one expert's segment, K tile), found
//      with find_tile, zeroes its rows outside every segment with
//      zero_outside, and walks F: A(m, t) = dy[row0 + m, t], B(t, n) =
//      w[e, col0 + n, t], both contiguous along t, read 8 t a row and
//      stored transposed (a pad of 4 floats spreads the stores).
//    - dw: one CTA per (expert, K tile, F tile) walking that expert's rows
//      in order, A(m, t) = x[lo + t, k0 + m], B(t, n) = dy[lo + t, f0 +
//      n], masking the rows past its segment as it loads them.
//
// The wgmma, TMA, mbarrier, fence and barrier PTX is in hopper_common.cuh;
// find_tile, zero_outside and the element loads and stores, which the
// forward shares, in grouped_gemm_common.cuh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "grouped_gemm_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace grouped;

// ---------------------------------------------------------------- simt

namespace simt {

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
    grouped_gemm_bwd_dx_simt(const T* __restrict__ dy, const T* __restrict__ w,
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
    grouped_gemm_bwd_dw_simt(const T* __restrict__ x, const T* __restrict__ dy,
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
  const long long row_tiles = (static_cast<long long>(N) + BM - 1) / BM + E;
  const long long col_tiles = (static_cast<long long>(K) + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  grouped_gemm_bwd_dx_simt<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const int*>(offsets),
      static_cast<T*>(dx), N, K, F, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, const void* offsets, void* dw, int N, int K, int F,
              int E, void* stream) {
  const long long k_tiles = (static_cast<long long>(K) + BM - 1) / BM;
  const long long f_tiles = (static_cast<long long>(F) + BN - 1) / BN;
  const long long blocks = static_cast<long long>(E) * k_tiles * f_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grouped_gemm_bwd_dw_simt<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const int*>(offsets),
      static_cast<T*>(dw), N, K, F, static_cast<int>(k_tiles), static_cast<int>(f_tiles));
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- wgmma

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kConsumers = 2;                    // warpgroups, 64 output rows each
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kNSub = BN / 128;                  // m64n128k16 products a k16 step
constexpr int kRow = BK * 2;                     // one 128-byte swizzle row of a box
constexpr int kBox = 64 * kRow;                  // 8 KB: a box of 64 such rows
static_assert(kRow == 128, "a box row is one 128-byte swizzle row");

// dx: a stage holds 128 rows of dy and 256 rows (K) of w[e], each 64 wide
// along F.
constexpr int kDxStages = 4;
constexpr int kDxA = BM * kRow;                       // 16 KB
constexpr int kDxStage = kDxA + BN * kRow;            // 48 KB
constexpr int kDxSmem = kDxStages * kDxStage + 1024;  // and room to align to 1 KB: 193 KB

// dw: a stage holds two 64 x 64 boxes of x (64 K columns a warpgroup) and
// four of dy (64 F columns each), 64 rows deep; the output tile is staged
// as four 64-column boxes a warpgroup.
constexpr int kDwStages = 3;
constexpr int kDwA = (BM / 64) * kBox;              // 16 KB
constexpr int kDwStage = kDwA + (BN / 64) * kBox;   // 48 KB
constexpr int kDwOut = (BN / 64) * kBox;            // 32 KB a warpgroup
constexpr int kDwSmem = kDwStages * kDwStage + kConsumers * kDwOut + 1024;  // 209 KB
static_assert(kDwSmem <= 232448, "one CTA an SM");
}  // namespace wg

// Swizzle atoms must start 1024-byte aligned in the shared window.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (hopper::smem_addr(p) & 1023u)) & 1023u);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
    grouped_gemm_bwd_dx_wgmma(const __grid_constant__ CUtensorMap dymap,
                              const __grid_constant__ CUtensorMap wmap,
                              const int* __restrict__ offsets, __nv_bfloat16* __restrict__ dx,
                              int N, int K, int F, int E, int col_tiles) {
  using namespace wg;
  using namespace hopper;
  __shared__ int info[3];
  __shared__ __align__(8) uint64_t full[kDxStages];
  __shared__ __align__(8) uint64_t empty[kDxStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);

  const int slot = blockIdx.x / col_tiles;  // column tiles of a row tile are neighbours
  const int col0 = (blockIdx.x % col_tiles) * BN;
  zero_outside(dx, offsets, N, K, E, slot * BM, slot * BM + BM, col0, col0 + BN, kThreads);
  if (threadIdx.x < 32) find_tile<BM>(offsets, E, N, slot, info);
  if (threadIdx.x == 32) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive.expect_tx
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;  // the same for every thread of the CTA
  const int row0 = info[1], row_end = info[2];
  const int nt = (F + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == kConsumers * 4) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      for (int it = 0; it < nt; ++it) {
        const int s = it % kDxStages;
        mbar_wait(&empty[s], ((it / kDxStages) & 1) ^ 1);  // the first round passes at once
        uint8_t* st = smem + s * kDxStage;
        mbar_arrive_expect_tx(&full[s], kDxStage);
        tma_load_2d(st, &dymap, &full[s], it * BK, row0);
        tma_load_3d(st + kDxA, &wmap, &full[s], it * BK, col0, e);
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
  for (int it = 0; it < nt; ++it) {
    const int s = it % kDxStages;
    mbar_wait(&full[s], (it / kDxStages) & 1);
    const uint8_t* st = smem + s * kDxStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // Both operands K-major: 16 F columns are 32 bytes along each
      // swizzled row, 8-row groups 1 KB apart.
      const uint64_t da = smem_desc_b128(st + g * 64 * kRow + kk * 32, 16, 1024);
#pragma unroll
      for (int n = 0; n < kNSub; ++n) {
        const uint64_t db = smem_desc_b128(st + kDxA + n * 128 * kRow + kk * 32, 16, 1024);
        wgmma_m64n128k16_ss_kmaj(acc[n], da, db, 1);
      }
    }
    wgmma_commit();
    // One F tile's products stay in flight while the next tile's are
    // issued; once the previous tile's are done, its stage goes back.
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it + kDxStages - 1) % kDxStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < kNSub; ++n) reg_fence(acc[n]);

  // The m64nNk16 fragment: acc[n][4 j + 2 h + b] is row 16 (warp % 4) +
  // lane / 4 + 8 h, column 128 n + 8 j + 2 (lane % 4) + b of the
  // warpgroup's tile.
  const int r_base = row0 + g * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < kNSub; ++n) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // c is even, and so is K: c < K means c + 1 < K.
      const int c = col0 + 128 * n + j * 8 + (lane % 4) * 2;
      if (c >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + 8 * h;
        if (r < row_end)
          *reinterpret_cast<__nv_bfloat162*>(dx + static_cast<size_t>(r) * K + c) =
              __floats2bfloat162_rn(acc[n][4 * j + 2 * h], acc[n][4 * j + 2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(wg::kThreads, 1)
    grouped_gemm_bwd_dw_wgmma(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap dymap,
                              const __grid_constant__ CUtensorMap dwmap,
                              const int* __restrict__ offsets, int N, int K, int F, int E,
                              int k_tiles, int f_tiles) {
  using namespace wg;
  using namespace hopper;
  __shared__ __align__(8) uint64_t full[kDwStages];
  __shared__ __align__(8) uint64_t empty[kDwStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  if (threadIdx.x == 32) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int per_expert = k_tiles * f_tiles;
  const int tiles = E * per_expert;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Tile `tile` (the F tiles of a K tile neighbours, an expert's tiles
  // together): its expert, first K row, first F column and rows [lo, hi).
  auto locate = [&](int tile, int& e, int& k0, int& f0, int& lo, int& hi) {
    e = tile / per_expert;
    const int rest = tile % per_expert;
    k0 = (rest / f_tiles) * BM;
    f0 = (rest % f_tiles) * BN;
    lo = min(max(offsets[e], 0), N);
    hi = min(max(offsets[e + 1], lo), N);
  };

  if (warp == kConsumers * 4) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int e, k0, f0, lo, hi;
        locate(tile, e, k0, f0, lo, hi);
        for (int t0 = lo; t0 < hi; t0 += BK, ++it) {
          const int s = it % kDwStages;
          mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);
          uint8_t* st = smem + s * kDwStage;
          mbar_arrive_expect_tx(&full[s], kDwStage);
          for (int a = 0; a < BM / 64; ++a)
            tma_load_2d(st + a * kBox, &xmap, &full[s], k0 + 64 * a, t0);
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(st + kDwA + b * kBox, &dymap, &full[s], f0 + 64 * b, t0);
        }
      }
    }
    return;
  }

  const int g = warp / 4;            // this warpgroup's K rows: [64 g, 64 g + 64) of the tile
  const int tg = threadIdx.x % 128;  // the thread's place in its warpgroup
  uint8_t* out = smem + kDwStages * kDwStage + g * kDwOut;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int e, k0, f0, lo, hi;
    locate(tile, e, k0, f0, lo, hi);
    float acc[kNSub][64];
#pragma unroll
    for (int n = 0; n < kNSub; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
    const int steps = (hi - lo + BK - 1) / BK;  // 0 for an empty expert: its dw is zero
    for (int i = 0; i < steps; ++i, ++it) {
      const int s = it % kDwStages;
      mbar_wait(&full[s], (it / kDwStages) & 1);
      uint8_t* st = smem + s * kDwStage;
      const int valid = hi - lo - i * BK;  // this step's rows inside the segment
      if (valid < BK) {
        // The rest belong to the next expert (or lie outside every
        // segment, or past N): zero them, whole 128-byte lines, in this
        // warpgroup's A box and in its half of the shared B boxes, so that
        // they add nothing even where those rows hold Inf or NaN (0 * Inf
        // is NaN); then hand the lines to the tensor cores once both
        // warpgroups are done.  At most once a tile.
        const int lines = (BK - valid) * (kRow / 16);
        constexpr int kHalfB = BN / 64 / kConsumers;  // the B boxes a warpgroup zeroes
        for (int b = 0; b <= kHalfB; ++b) {
          uint8_t* box = b == 0 ? st + g * kBox : st + kDwA + (kHalfB * g + b - 1) * kBox;
          uint4* z = reinterpret_cast<uint4*>(box + valid * kRow);
          for (int q = tg; q < lines; q += 128) z[q] = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_bar_sync(1 + kConsumers, 128 * kConsumers);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // Both operands MN-major: 16 rows are 2 KB down each box (two
        // swizzle atoms); a product of 128 F columns spans two boxes, LBO
        // apart; A is one box (64 K columns) a warpgroup.
        const uint64_t da = smem_desc_b128(st + g * kBox + kk * 16 * kRow, kBox, 1024);
#pragma unroll
        for (int n = 0; n < kNSub; ++n) {
          const uint64_t db =
              smem_desc_b128(st + kDwA + 2 * n * kBox + kk * 16 * kRow, kBox, 1024);
          wgmma_m64n128k16_bf16_mnmaj_mnmaj(acc[n], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(&empty[(it + kDwStages - 1) % kDwStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kNSub; ++n) reg_fence(acc[n]);
    if (steps > 0 && lane == 0) mbar_arrive(&empty[(it + kDwStages - 1) % kDwStages]);

    // Epilogue: the warpgroup's 64 x 256 tile into shared memory as four
    // 128-byte-swizzled 64 x 64 boxes (row rr's 16-byte chunk c at chunk c
    // ^ (rr % 8): a warp's 32 four-byte writes fill the 32 banks once),
    // then stored by TMA, which clips the K and F tails.  Meanwhile the
    // producer loads the next tile's stages.
    if (tg == 0) tma_store_wait_read<0>();  // the last tile's store has read `out`
    named_bar_sync(1 + g, 128);
#pragma unroll
    for (int n = 0; n < kNSub; ++n) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = (warp % 4) * 16 + lane / 4 + 8 * h;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[n][4 * j + 2 * h], acc[n][4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(out + (2 * n + j / 8) * kBox + rr * kRow +
                                             (((j % 8) ^ (rr % 8)) * 16) + (lane % 4) * 4) = v;
        }
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + g, 128);
    if (tg == 0 && k0 + 64 * g < K) {
      for (int b = 0; b < BN / 64; ++b)
        if (f0 + 64 * b < F) tma_store_3d(&dwmap, out + b * kBox, f0 + 64 * b, k0 + 64 * g, e);
      tma_store_commit();
    }
  }
  if (tg == 0) tma_store_wait_read<0>();  // shared memory outlives the stores' reads
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_dx_wgmma(const void* dy, const void* w, const void* offsets, void* dx, int N, int K,
                    int F, int E, cudaStream_t st) {
  using namespace wg;
  if (K % 8 || F % 8 || !aligned16(dy) || !aligned16(w) || !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  const long long slots = (static_cast<long long>(N) + BM - 1) / BM + E;
  const long long col_tiles = (static_cast<long long>(K) + BN - 1) / BN;
  if (slots * col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap dymap, wmap;
  const cuuint64_t dydims[2] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(N)};
  const cuuint64_t dystrides[1] = {static_cast<cuuint64_t>(F) * 2};
  const cuuint32_t dybox[2] = {BK, BM};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(E)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(F) * 2,
                                  static_cast<cuuint64_t>(K) * F * 2};
  const cuuint32_t wbox[3] = {BK, BN, 1};
  int rc = hopper::encode_bf16_b128(&dymap, const_cast<void*>(dy), 2, dydims, dystrides, dybox);
  if (rc == 0)
    rc = hopper::encode_bf16_b128(&wmap, const_cast<void*>(w), 3, wdims, wstrides, wbox);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(grouped_gemm_bwd_dx_wgmma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  if (rc != 0) return rc;
  grouped_gemm_bwd_dx_wgmma<<<static_cast<unsigned>(slots * col_tiles), kThreads, kDxSmem, st>>>(
      dymap, wmap, static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(dx), N, K, F,
      E, static_cast<int>(col_tiles));
  return (int)cudaGetLastError();
}

int launch_dw_wgmma(const void* x, const void* dy, const void* offsets, void* dw, int N, int K,
                    int F, int E, cudaStream_t st) {
  using namespace wg;
  if (K % 8 || F % 8 || !aligned16(x) || !aligned16(dy) || !aligned16(dw))
    return (int)cudaErrorInvalidValue;
  const long long k_tiles = (static_cast<long long>(K) + BM - 1) / BM;
  const long long f_tiles = (static_cast<long long>(F) + BN - 1) / BN;
  const long long tiles = static_cast<long long>(E) * k_tiles * f_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != 0) return rc;
  // With N = 0 every segment is empty and no row is loaded: the maps of x
  // and dy are never read (and a map of no rows cannot be encoded).
  CUtensorMap xmap{}, dymap{}, dwmap;
  const cuuint32_t box[2] = {64, BK};
  if (N > 0) {
    const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
    const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint64_t dydims[2] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(N)};
    const cuuint64_t dystrides[1] = {static_cast<cuuint64_t>(F) * 2};
    rc = hopper::encode_bf16_b128(&xmap, const_cast<void*>(x), 2, xdims, xstrides, box);
    if (rc == 0)
      rc = hopper::encode_bf16_b128(&dymap, const_cast<void*>(dy), 2, dydims, dystrides, box);
    if (rc != 0) return rc;
  }
  const cuuint64_t dwdims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t dwstrides[2] = {static_cast<cuuint64_t>(F) * 2,
                                   static_cast<cuuint64_t>(K) * F * 2};
  const cuuint32_t dwbox[3] = {64, 64, 1};
  rc = hopper::encode_bf16_b128(&dwmap, dw, 3, dwdims, dwstrides, dwbox);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(grouped_gemm_bwd_dw_wgmma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (rc != 0) return rc;
  // Persistent: a CTA an SM, each walking tiles blockIdx.x, + grid, ...
  const long long grid = std::min(tiles, static_cast<long long>(std::max(sms, 1)));
  grouped_gemm_bwd_dw_wgmma<<<static_cast<unsigned>(grid), kThreads, kDwSmem, st>>>(
      xmap, dymap, dwmap, static_cast<const int*>(offsets), N, K, F, E,
      static_cast<int>(k_tiles), static_cast<int>(f_tiles));
  return (int)cudaGetLastError();
}

// Variant codes, as grouped_gemm.py's _VARIANT_CODES.
enum Variant { kSimt = 0, kWgmma = 1 };

template <typename T>
int dispatch_dx(const void* dy, const void* w, const void* offsets, void* dx, int N, int K, int F,
                int E, int variant, void* stream) {
  if (N < 0 || K < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  switch (variant) {
    case kSimt:
      return simt::launch_dx<T>(dy, w, offsets, dx, N, K, F, E, stream);
    case kWgmma:
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_dx_wgmma(dy, w, offsets, dx, N, K, F, E,
                               static_cast<cudaStream_t>(stream));
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dw(const void* x, const void* dy, const void* offsets, void* dw, int N, int K, int F,
                int E, int variant, void* stream) {
  if (N < 0 || K < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kSimt:
      return simt::launch_dw<T>(x, dy, offsets, dw, N, K, F, E, stream);
    case kWgmma:
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_dw_wgmma(x, dy, offsets, dw, N, K, F, E,
                               static_cast<cudaStream_t>(stream));
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dx (N, K) from dy (N, F), w (E, K, F) and offsets (E + 1,) int32: every
// row written, zero outside the segments.  dw (E, K, F) from x (N, K), dy
// and offsets: every expert written, zero for an empty segment.  All
// contiguous, x, dy, w, dx and dw of one type.  `variant`: 0 simt, 1
// wgmma (bf16 only).  Returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidValue for shapes or a variant the launch cannot
// take).
extern "C" int grouped_gemm_dx_f32(const void* dy, const void* w, const void* offsets, void* dx,
                                   int N, int K, int F, int E, int variant, void* stream) {
  return dispatch_dx<float>(dy, w, offsets, dx, N, K, F, E, variant, stream);
}

extern "C" int grouped_gemm_dx_bf16(const void* dy, const void* w, const void* offsets, void* dx,
                                    int N, int K, int F, int E, int variant, void* stream) {
  return dispatch_dx<__nv_bfloat16>(dy, w, offsets, dx, N, K, F, E, variant, stream);
}

extern "C" int grouped_gemm_dw_f32(const void* x, const void* dy, const void* offsets, void* dw,
                                   int N, int K, int F, int E, int variant, void* stream) {
  return dispatch_dw<float>(x, dy, offsets, dw, N, K, F, E, variant, stream);
}

extern "C" int grouped_gemm_dw_bf16(const void* x, const void* dy, const void* offsets, void* dw,
                                    int N, int K, int F, int E, int variant, void* stream) {
  return dispatch_dw<__nv_bfloat16>(x, dy, offsets, dw, N, K, F, E, variant, stream);
}
