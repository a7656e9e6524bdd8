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
// Design: the forward's cp_async walk (csrc/rglru.cu) reversed.  One CTA owns
// a (batch row, block of LANES lanes), one thread a lane, and walks all S
// steps from the last with g in a register, so every tensor is read or
// written once.  Each thread copies its own lane's dh_t, a_{t+1} and h_{t-1}
// (zero past either end, by cp.async's zero fill) with 4-byte cp.async into a
// ring of kStages boxes of kSteps steps, walked from the last box, and reads
// only what it copied, so the ring needs no barrier; da and db are stored
// from the registers, a warp's 32 lanes of a step in one 128-byte store.
// Any W.  LANES is 64 or 128, as the forward picks (rglru._lanes).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kSteps = 32;  // time steps a box
constexpr int kStages = 4;  // boxes in the ring

template <int LANES>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(kStages) * 3 * kSteps * LANES * sizeof(float);
}

// Box `box`'s steps in reverse: g through n steps of dh, a_{t+1} and h_{t-1}
// (LANES apart in shared memory), each da and db stored W apart.
template <int LANES>
__device__ __forceinline__ float walk_back(const float* box, float g, float* da, float* db, int n,
                                           int W, bool on) {
  const float* dh = box;
  const float* an = box + kSteps * LANES;
  const float* hp = box + 2 * kSteps * LANES;
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
    rglru_bwd_cp_async(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ dh, float* __restrict__ da,
                       float* __restrict__ db, int S, int W) {
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
    g = walk_back<LANES>(ring + (i % kStages) * 3 * kSteps * LANES + lane, g, da + off, db + off,
                         min(kSteps, S - t0), W, on);
    if (i + kStages < n_boxes) load_box(i + kStages);
    else mma::cp_async_commit();
  }
}

template <int LANES>
int launch(const void* a, const void* h, const void* dh, void* da, void* db, int B, int S, int W,
           cudaStream_t st) {
  constexpr size_t smem = ring_bytes<LANES>();
  static_assert(smem <= 232448, "shared memory");
  auto kernel = rglru_bwd_cp_async<LANES>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + LANES - 1) / LANES, B);
  kernel<<<grid, LANES, smem, st>>>(static_cast<const float*>(a), static_cast<const float*>(h),
                                    static_cast<const float*>(dh), static_cast<float*>(da),
                                    static_cast<float*>(db), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes 64 or 128.  a, h, dh, da and db (B, S, W) float32, contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rglru_bwd_f32(int lanes, const void* a, const void* h, const void* dh, void* da,
                             void* db, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 64) return launch<64>(a, h, dh, da, db, B, S, W, st);
  if (lanes == 128) return launch<128>(a, h, dh, da, db, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}
