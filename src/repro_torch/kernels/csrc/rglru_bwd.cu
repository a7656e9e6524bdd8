// The backward of the RG-LRU linear recurrence for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes.
//
// No Pallas kernel computes it: the reference trains through jax.grad of
// jax.lax.associative_scan (src/repro/models/rglru.py:96 rglru_scan, reached
// from rglru_train, :136), whose forward the TPU kernel
// src/repro/kernels/rglru.py:41 rglru_scan_kernel computes.  For h_t =
// a_t h_{t-1} + b_t from h_{-1} = 0 and the output gradient dh, in float32:
//   g_t = dh_t + a_{t+1} g_{t+1}  (g_S = 0),  db_t = g_t,  da_t = g_t h_{t-1}.
//
// Bound on an H100 SXM at recurrentgemma-9b's training call (B 1, S 4096,
// W 4096): a, h and dh read, da and db written, 67.1 MB each, 335 MB, 100 us
// at 3.35 TB/s, against 16.8 M multiply-adds: bytes-bound by far.
//
// Two variants, picked by shape before the launch (rglru._bwd_variant):
//
// "split" (W a multiple of 4, 16-byte-aligned rows, S long enough): the time
// axis cut into SEG segments of L steps.  Over a segment [t0, t1) the carry
// in is an affine map of the carry out, g_{t0} = G + A g_{t1}, with G the
// segment's walk from a zero carry and A = a_{t0+1} ... a_{t1} (a_S = 0).
// A thread-block cluster of SEG CTAs walks items, each a (batch row, block
// of LANES lanes); CTA k owns segment k of every item, one thread a lane.
// For an item each CTA holds its segment's dh_t, a_{t+1} and h_{t-1} in
// shared memory, brought in once by TMA boxes of kBoxSteps steps x LANES
// lanes (zero past either end, negative coordinates included); it walks
// the segment from a zero carry as the boxes land (last first) to get
// (G, A), publishes them, and after a cluster barrier reads the later
// segments' pairs through distributed shared memory and folds them, last
// to first, into its true carry; then it walks the segment again from
// shared memory, writing db and da over each box's dh and a, which TMA
// stores write out.  Once a box's stores have read it, the next item's box
// is loaded in its place, so the loads run under the second walk.  Every
// tensor is read or written once; no atomics, and the fold's order is
// fixed, so a repeat is bit for bit equal.  At (1, 4096, 4096): SEG 8
// segments of 512 steps, 32 lanes, 196 KB of shared memory a CTA (one CTA
// an SM), 15 clusters at once on an H100, 128 items.
//
// "walk" (any shape): the forward's cp_async walk reversed.
// One CTA owns a (batch row, block of LANES lanes) and walks all S steps
// from the last with g in a register.  Each thread copies its own lane's
// dh_t, a_{t+1} and h_{t-1} (zero past either end, by cp.async's zero fill)
// with 4-byte cp.async into a ring of kStages boxes of kSteps steps, walked
// from the last box, and reads only what it copied, so the ring needs no
// barrier.  LANES is 64 or 128 as the forward picks (rglru._lanes); 32 is
// built for measurements.
#include <cooperative_groups.h>
#include <algorithm>
#include <initializer_list>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- "walk" ------------------------------------------------------------------

constexpr int kSteps = 32;  // time steps a box
constexpr int kStages = 4;  // boxes in the ring

template <int LANES>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(kStages) * 3 * kSteps * LANES * sizeof(float);
}

// n steps of a box in reverse from g: dh, a_{t+1} and h_{t-1} LANES apart in
// shared memory, each da and db stored W apart (where `on`).
template <int LANES>
__device__ __forceinline__ float walk_back(const float* dh, const float* an, const float* hp,
                                           float g, float* da, float* db, int n, int W,
                                           bool on) {
  if (n == kSteps) {
#pragma unroll
    for (int k = kSteps - 1; k >= 0; --k) {
      g = fmaf(an[k * LANES], g, dh[k * LANES]);
      if (on) {
        db[static_cast<size_t>(k) * W] = g;
        da[static_cast<size_t>(k) * W] = g * hp[k * LANES];
      }
    }
  } else {
    for (int k = n - 1; k >= 0; --k) {
      g = fmaf(an[k * LANES], g, dh[k * LANES]);
      if (on) {
        db[static_cast<size_t>(k) * W] = g;
        da[static_cast<size_t>(k) * W] = g * hp[k * LANES];
      }
    }
  }
  return g;
}

template <int LANES>
__global__ void __launch_bounds__(LANES)
    rglru_bwd_walk(const float* __restrict__ a, const float* __restrict__ h,
                   const float* __restrict__ dh, float* __restrict__ da, float* __restrict__ db,
                   int S, int W) {
  extern __shared__ __align__(128) float ring[];  // [kStages][dh, a_next, h_prev][kSteps][LANES]
  const int lane = threadIdx.x;
  const int row = blockIdx.y;
  const int w = blockIdx.x * LANES + lane;
  const bool on = w < W;
  const int n_boxes = (S + kSteps - 1) / kSteps;
  const size_t base = static_cast<size_t>(row) * S * W + (on ? w : 0);
  // The i-th box walked is box n_boxes - 1 - i.
  auto load_box = [&](int i) {
    float* dst = ring + (i % kStages) * 3 * kSteps * LANES + lane;
    const int t0 = (n_boxes - 1 - i) * kSteps;
    const int n = min(kSteps, S - t0);
    if (on) {
      for (int k = 0; k < n; ++k) {
        const int t = t0 + k;
        const size_t off = base + static_cast<size_t>(t) * W;
        mma::cp_async4(dst + k * LANES, dh + off, true);
        mma::cp_async4(dst + (kSteps + k) * LANES, t + 1 < S ? a + off + W : a + off, t + 1 < S);
        mma::cp_async4(dst + (2 * kSteps + k) * LANES, t > 0 ? h + off - W : h + off, t > 0);
      }
    }
    mma::cp_async_commit();
  };
  for (int i = 0; i < kStages; ++i) {
    if (i < n_boxes) load_box(i);
    else mma::cp_async_commit();
  }
  float g = 0.f;
  for (int i = 0; i < n_boxes; ++i) {
    mma::cp_async_wait<kStages - 1>();  // box i has landed
    const int t0 = (n_boxes - 1 - i) * kSteps;
    const size_t off = base + static_cast<size_t>(t0) * W;
    const float* box = ring + (i % kStages) * 3 * kSteps * LANES + lane;
    g = walk_back<LANES>(box, box + kSteps * LANES, box + 2 * kSteps * LANES, g, da + off,
                         db + off, min(kSteps, S - t0), W, on);
    if (i + kStages < n_boxes) load_box(i + kStages);
    else mma::cp_async_commit();
  }
}

template <int LANES>
int launch_walk(const void* a, const void* h, const void* dh, void* da, void* db, int B, int S,
                int W, cudaStream_t st) {
  constexpr size_t smem = ring_bytes<LANES>();
  static_assert(smem <= 232448, "shared memory");
  auto kernel = rglru_bwd_walk<LANES>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + LANES - 1) / LANES, B);
  kernel<<<grid, LANES, smem, st>>>(static_cast<const float*>(a), static_cast<const float*>(h),
                                    static_cast<const float*>(dh), static_cast<float*>(da),
                                    static_cast<float*>(db), S, W);
  return (int)cudaGetLastError();
}

// ---- "split" -----------------------------------------------------------------

constexpr int kSplitLanes = 32;   // lanes a CTA (one warp)
constexpr int kBoxSteps = 32;     // steps a TMA box
constexpr int kPlaneFloats = 576 * kSplitLanes;  // one of a segment's three planes, at most
constexpr int kMaxBoxes = kPlaneFloats / (kBoxSteps * kSplitLanes);  // boxes a segment
constexpr int kMaxSeg = 16;       // CTAs a cluster (8 is the portable size)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The second walk over n steps of a box (at most kBoxSteps) in reverse from
// g, in place: step k's dh and a_{t+1} (LANES apart in shared memory) give
// way to its db and da, which a TMA store then writes out.  The box is
// staged in registers first: the planes' offsets are known only at run
// time, so the compiler keeps each shared load behind the stores before
// it, and every step would pay a load's latency (0.28 ms against 0.17 at
// recurrentgemma-9b's call on an H100, scripts/torch_rglru_bwd_probe.py).
template <int LANES>
__device__ __forceinline__ float rewalk_box(float* dh, float* an, const float* hp, float g, int n) {
  float vd[kBoxSteps], va[kBoxSteps], vh[kBoxSteps];
#pragma unroll
  for (int k = 0; k < kBoxSteps; ++k) {
    vd[k] = dh[k * LANES];
    va[k] = an[k * LANES];
    vh[k] = hp[k * LANES];
  }
#pragma unroll
  for (int k = kBoxSteps - 1; k >= 0; --k) {
    if (k < n) {
      g = fmaf(va[k], g, vd[k]);
      dh[k * LANES] = g;
      an[k * LANES] = g * vh[k];
    }
  }
  return g;
}

// Grid (SEG, G), cluster (SEG, 1, 1): cluster y walks the items (batch
// row, block of LANES lanes) y, y + G, ...  L steps a segment, a multiple
// of kBoxSteps.  Shared memory: the planes dh, a_next and h_prev, each
// [L][LANES].  The next item's boxes are loaded as the second walk frees
// them, last box first, so the loads run under the walk and the stores.
__global__ void __launch_bounds__(kSplitLanes)
    rglru_bwd_split(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_dh,
                    const __grid_constant__ CUtensorMap map_da,
                    const __grid_constant__ CUtensorMap map_db, int S, int L, int n_blocks,
                    int items) {
  constexpr int LANES = kSplitLanes;
  constexpr int kBox = kBoxSteps * LANES;  // floats a box
  constexpr uint32_t kBoxBytes = kBox * sizeof(float);
  extern __shared__ __align__(128) float planes[];
  __shared__ __align__(8) uint64_t full[kMaxBoxes];  // box i's dh and a
  __shared__ __align__(8) uint64_t full_h;           // every box's h
  __shared__ float carry[2][LANES];                  // this segment's (G, A)
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.block_rank());
  const int n_seg = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x;
  const int t0 = k * L;
  const int n = max(0, min(L, S - t0));  // this segment's steps (none past S)
  const int n_boxes = (n + kBoxSteps - 1) / kBoxSteps;
  float* s_dh = planes;
  float* s_an = planes + L * LANES;
  float* s_hp = planes + 2 * L * LANES;
  if (lane == 0) {
    for (int i = 0; i < n_boxes; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_init(&full_h, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // Box i of item q: dh_t and a_{t+1} on full[i], h_{t-1} on full_h (zero
  // past either end).  Thread 0 issues every load.
  auto load_box = [&](int i, int q) {
    const int row = q / n_blocks, w0 = (q - row * n_blocks) * LANES;
    const int t = t0 + i * kBoxSteps;
    hopper::mbar_arrive_expect_tx(&full[i], 2 * kBoxBytes);
    hopper::tma_load_3d(s_dh + i * kBox, &map_dh, &full[i], w0, t, row);
    hopper::tma_load_3d(s_an + i * kBox, &map_a, &full[i], w0, t + 1, row);
    hopper::tma_load_3d(s_hp + i * kBox, &map_h, &full_h, w0, t - 1, row);
  };
  const int q0 = blockIdx.y;
  if (lane == 0 && n_boxes > 0 && q0 < items) {
    hopper::mbar_arrive_expect_tx(&full_h, n_boxes * kBoxBytes);
    for (int i = n_boxes - 1; i >= 0; --i) load_box(i, q0);  // the first walk's first
  }
  int it = 0;
  for (int q = q0; q < items; q += gridDim.y, ++it) {
    const uint32_t parity = it & 1;
    const int row = q / n_blocks, w0 = (q - row * n_blocks) * LANES;
    const int next = q + gridDim.y < items ? q + gridDim.y : -1;
    // 1. The segment from a zero carry: g_{t0} = G + A g_{t1}.
    float g = 0.f, prod = 1.f;
    for (int i = n_boxes - 1; i >= 0; --i) {
      hopper::mbar_wait(&full[i], parity);
      const float* dh = s_dh + i * kBox + lane;
      const float* an = s_an + i * kBox + lane;
      const int m = min(kBoxSteps, n - i * kBoxSteps);
      if (m == kBoxSteps) {
#pragma unroll
        for (int j = kBoxSteps - 1; j >= 0; --j) {
          g = fmaf(an[j * LANES], g, dh[j * LANES]);
          prod *= an[j * LANES];
        }
      } else {
        for (int j = m - 1; j >= 0; --j) {
          g = fmaf(an[j * LANES], g, dh[j * LANES]);
          prod *= an[j * LANES];
        }
      }
    }
    if (it > 0) cluster_wait();  // every CTA is done with the last item's carries
    carry[0][lane] = g;
    carry[1][lane] = prod;
    cluster.sync();  // every segment's (G, A) is in place
    // The true carry out of this segment: the later segments folded, last
    // to first (the last one's carry out is g_S = 0).
    float c = 0.f;
    for (int j = n_seg - 1; j > k; --j)
      c = fmaf(*cluster.map_shared_rank(&carry[1][lane], j), c,
               *cluster.map_shared_rank(&carry[0][lane], j));
    cluster_arrive();  // done reading the others' carries
    // 2. The segment again from the true carry; each box's db and da, in
    // place of its dh and a, go out by TMA (nothing past S or W is
    // written), and once a box's stores have read it, the next item's box
    // takes its place.
    if (n_boxes > 0) hopper::mbar_wait(&full_h, parity);
    __syncwarp();
    if (lane == 0 && next >= 0 && n_boxes > 0)
      hopper::mbar_arrive_expect_tx(&full_h, n_boxes * kBoxBytes);  // the next phase
    g = c;
    for (int i = n_boxes - 1; i >= 0; --i) {
      g = rewalk_box<LANES>(s_dh + i * kBox + lane, s_an + i * kBox + lane,
                            s_hp + i * kBox + lane, g, min(kBoxSteps, n - i * kBoxSteps));
      hopper::fence_proxy_async();  // this thread's results, visible to the TMA unit
      __syncwarp();
      if (lane == 0) {
        hopper::tma_store_3d(&map_db, s_dh + i * kBox, w0, t0 + i * kBoxSteps, row);
        hopper::tma_store_3d(&map_da, s_an + i * kBox, w0, t0 + i * kBoxSteps, row);
        hopper::tma_store_commit();
        if (next >= 0 && i + 1 < n_boxes) {
          hopper::tma_store_wait_read<1>();  // box i + 1's stores have read it
          load_box(i + 1, next);
        }
      }
    }
    if (lane == 0) {
      hopper::tma_store_wait_read<0>();  // the planes stay until read
      if (next >= 0 && n_boxes > 0) load_box(0, next);
    }
  }
  if (it > 0) cluster_wait();  // no CTA leaves while another may still read its carry
}

// Clusters of `seg` CTAs with `smem` bytes each that the current card holds
// at once (the kernel's shared-memory attributes set); 0 where none fits.
int active_clusters(int seg, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(seg, 1, 1);
  cfg.blockDim = dim3(kSplitLanes);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = seg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, rglru_bwd_split, &cfg) != cudaSuccess) n = 0;
  return n;
}

int launch_split(int seg, int L, const void* a, const void* h, const void* dh, void* da,
                 void* db, int B, int S, int W, cudaStream_t st) {
  constexpr int LANES = kSplitLanes;
  if (seg < 1 || seg > kMaxSeg || L < kBoxSteps || L % kBoxSteps != 0 ||
      L * LANES > kPlaneFloats || static_cast<long long>(seg) * L < S || W % 4 != 0 ||
      static_cast<long long>(B) * ((W + LANES - 1) / LANES) > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {a, h, dh, static_cast<const void*>(da), static_cast<const void*>(db)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4,
                                 static_cast<cuuint64_t>(S) * W * 4};
  const cuuint32_t box[3] = {LANES, kBoxSteps, 1};
  CUtensorMap maps[5];
  const void* bases[5] = {a, h, dh, da, db};
  for (int i = 0; i < 5; ++i) {
    const int err = hopper::encode_f32(&maps[i], bases[i], 3, dims, strides, box);
    if (err != 0) return err;
  }
  const size_t smem = static_cast<size_t>(3) * L * LANES * sizeof(float);
  auto kernel = rglru_bwd_split;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  const int n_blocks = (W + LANES - 1) / LANES;
  const int items = B * n_blocks;
  const int clusters = std::min(items, std::min(active_clusters(seg, smem), 65535));
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(seg, clusters, 1);
  cfg.blockDim = dim3(LANES);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = seg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], maps[4], S, L,
                         n_blocks, items);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The "walk": lanes 32, 64 or 128.  a, h, dh, da and db (B, S, W) float32,
// contiguous.  Returns the CUDA error code of the launch (0 on success).
int rglru_bwd_f32(int lanes, const void* a, const void* h, const void* dh, void* da, void* db,
                  int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 32) return launch_walk<32>(a, h, dh, da, db, B, S, W, st);
  if (lanes == 64) return launch_walk<64>(a, h, dh, da, db, B, S, W, st);
  if (lanes == 128) return launch_walk<128>(a, h, dh, da, db, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}

// The "split": a cluster of `seg` CTAs, segments of `steps` steps (a
// multiple of 32, at most rglru_bwd_split_max_steps(), seg x steps >= S);
// W a multiple of 4 and a, h, dh 16-byte aligned.  As rglru_bwd_f32
// otherwise.
int rglru_bwd_split_f32(int seg, int steps, const void* a, const void* h, const void* dh,
                        void* da, void* db, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  return launch_split(seg, steps, a, h, dh, da, db, B, S, W, static_cast<cudaStream_t>(stream));
}

// Clusters of `seg` CTAs with segments of `steps` steps that the current
// card holds at once: the split's grid (0 where none fits).
int rglru_bwd_split_clusters(int seg, int steps) {
  const size_t smem = static_cast<size_t>(3) * steps * kSplitLanes * sizeof(float);
  if (seg < 1 || seg > kMaxSeg || steps < 1 || steps * kSplitLanes > kPlaneFloats) return 0;
  if (cudaFuncSetAttribute(rglru_bwd_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncSetAttribute(rglru_bwd_split, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess)
    return 0;
  return active_clusters(seg, smem);
}

}  // extern "C"
