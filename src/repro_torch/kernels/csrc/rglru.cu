// RG-LRU linear recurrence for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:rglru_scan_kernel
// (body _kernel): h_t = a_t * h_{t-1} + b_t per width lane, from an
// optional h0 (zeros otherwise), all in float32.
//
// Bound on an H100 SXM at recurrentgemma-9b's served prefill (B=4, S=1024,
// W=4096): a, b and h are 67.1 MB each, 201 MB, 60 us at 3.35 TB/s,
// against 16.8 M multiply-adds: bytes-bound by far.
//
// Design: a streaming walk in the TPU kernel's order, time innermost.  One
// CTA owns a (batch row, block of LANES lanes), one thread a lane, and walks
// all S steps with the state in a register, so a and b are read once and h
// written once.  a and b arrive through a ring of kStages boxes of (kSteps
// steps x LANES lanes) in shared memory, so that kStages boxes of each are
// in flight while the CTA computes (64 KB a CTA at 64 lanes; by Little's
// law 3.35 TB/s over 132 SMs at about 1 us needs some 25 KB an SM).  h is
// stored from the registers, a warp's 32 lanes of a step in one 128-byte
// store.  Two variants, picked by shape before the launch (rglru._variant):
//   - "tma": W a multiple of 4 and 16-byte-aligned a and b (TMA needs
//     16-byte row strides): thread 0 loads each box of a and of b with one
//     TMA copy onto an mbarrier; boxes past S or W are zero-filled;
//   - "cp_async": any W: each thread copies its own lane's steps with 4-byte
//     cp.async and reads only what it copied, so the ring needs no barrier.
// LANES is 64 or 128 (rglru._lanes): 128 unless that leaves more than half
// the SMs idle; at the served shape 128 CTAs of 128 lanes, one an SM.  The
// ring's depth moved nothing there: 2 to 8 stages of 16 to 64 steps all ran
// within 4% of each other, at some 2.6 TB/s of a, b and h together.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kSteps = 32;  // time steps a box
constexpr int kStages = 4;  // boxes in the ring

template <int LANES>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(kStages) * 2 * kSteps * LANES * sizeof(float);
}

// One box's steps: state through n steps of a and b (LANES apart in shared
// memory), each h stored W apart.
template <int LANES>
__device__ __forceinline__ float walk(const float* as, const float* bs, float state, float* hp,
                                      int n, int W, bool on) {
  if (n == kSteps) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      state = fmaf(as[k * LANES], state, bs[k * LANES]);
      if (on) hp[static_cast<size_t>(k) * W] = state;
    }
  } else {
    for (int k = 0; k < n; ++k) {
      state = fmaf(as[k * LANES], state, bs[k * LANES]);
      if (on) hp[static_cast<size_t>(k) * W] = state;
    }
  }
  return state;
}

template <int LANES>
__global__ void __launch_bounds__(LANES)
    rglru_tma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const float* __restrict__ h0, float* __restrict__ h, int S, int W) {
  extern __shared__ __align__(128) float ring[];  // [kStages][a, b][kSteps][LANES]
  __shared__ __align__(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * LANES;
  const int row = blockIdx.y;
  const int w = w0 + lane;
  const bool on = w < W;
  const int n_boxes = (S + kSteps - 1) / kSteps;
  constexpr uint32_t kBoxBytes = kSteps * LANES * sizeof(float);
  if (lane == 0) {
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(&full[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  auto load_box = [&](int i) {
    const int st = i % kStages;
    float* dst = ring + st * 2 * kSteps * LANES;
    hopper::mbar_arrive_expect_tx(&full[st], 2 * kBoxBytes);
    hopper::tma_load_3d(dst, &map_a, &full[st], w0, i * kSteps, row);
    hopper::tma_load_3d(dst + kSteps * LANES, &map_b, &full[st], w0, i * kSteps, row);
  };
  if (lane == 0)
    for (int i = 0; i < kStages && i < n_boxes; ++i) load_box(i);
  float state = (h0 != nullptr && on) ? h0[static_cast<size_t>(row) * W + w] : 0.f;
  float* hp = h + static_cast<size_t>(row) * S * W + w;
  for (int i = 0; i < n_boxes; ++i) {
    const int st = i % kStages;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    const float* as = ring + st * 2 * kSteps * LANES + lane;
    const int t0 = i * kSteps;
    state = walk<LANES>(as, as + kSteps * LANES, state, hp + static_cast<size_t>(t0) * W,
                        min(kSteps, S - t0), W, on);
    // Every thread is done with the stage (its loads fed the stores above)
    // before thread 0 refills it.
    __syncthreads();
    if (lane == 0 && i + kStages < n_boxes) load_box(i + kStages);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(hopper::smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int LANES>
__global__ void __launch_bounds__(LANES)
    rglru_cp_async(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h, int S, int W) {
  extern __shared__ __align__(128) float ring[];  // [kStages][a, b][kSteps][LANES]
  const int lane = threadIdx.x;
  const int row = blockIdx.y;
  const int w = blockIdx.x * LANES + lane;
  const bool on = w < W;
  const int n_boxes = (S + kSteps - 1) / kSteps;
  const size_t base = static_cast<size_t>(row) * S * W + w;
  // A thread copies its own lane's steps of box i and reads only those, so
  // it needs no barrier with the other threads; it refills a stage only
  // after the stores of its last steps, which waited on every read of it.
  auto load_box = [&](int i) {
    float* dst = ring + (i % kStages) * 2 * kSteps * LANES + lane;
    const int t0 = i * kSteps;
    const int n = min(kSteps, S - t0);
    if (on) {
      for (int k = 0; k < n; ++k) {
        const size_t off = base + static_cast<size_t>(t0 + k) * W;
        cp_async4(dst + k * LANES, a + off);
        cp_async4(dst + (kSteps + k) * LANES, b + off);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages; ++i) {
    if (i < n_boxes) load_box(i);
    else cp_async_commit();
  }
  float state = (h0 != nullptr && on) ? h0[static_cast<size_t>(row) * W + w] : 0.f;
  float* hp = h + base;
  for (int i = 0; i < n_boxes; ++i) {
    cp_async_wait<kStages - 1>();  // box i has landed
    const float* as = ring + (i % kStages) * 2 * kSteps * LANES + lane;
    const int t0 = i * kSteps;
    state = walk<LANES>(as, as + kSteps * LANES, state, hp + static_cast<size_t>(t0) * W,
                        min(kSteps, S - t0), W, on);
    if (i + kStages < n_boxes) load_box(i + kStages);
    else cp_async_commit();
  }
}

// A float32 tensor map over (W, S, B), innermost first, with a box of
// (LANES, kSteps, 1), no swizzle, zero fill past the edges.
int encode_f32(CUtensorMap* map, const void* base, int B, int S, int W, int lanes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4,
                                 static_cast<cuuint64_t>(S) * W * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lanes), kSteps, 1};
  return hopper::encode_f32(map, base, 3, dims, strides, box);
}

template <int LANES>
int launch(int variant, const void* a, const void* b, const void* h0, void* h, int B, int S,
           int W, cudaStream_t st) {
  constexpr size_t smem = ring_bytes<LANES>();
  static_assert(smem <= 232448, "shared memory");
  const dim3 grid((W + LANES - 1) / LANES, B);
  const auto* h0f = static_cast<const float*>(h0);
  auto* hf = static_cast<float*>(h);
  if (variant == 0) {
    CUtensorMap map_a, map_b;
    int err = encode_f32(&map_a, a, B, S, W, LANES);
    if (err == 0) err = encode_f32(&map_b, b, B, S, W, LANES);
    if (err != 0) return err;
    auto kernel = rglru_tma<LANES>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, LANES, smem, st>>>(map_a, map_b, h0f, hf, S, W);
    return (int)cudaGetLastError();
  }
  if (variant != 1) return (int)cudaErrorInvalidValue;
  auto kernel = rglru_cp_async<LANES>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, LANES, smem, st>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                    h0f, hf, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0 ("tma": W % 4 == 0, a and b 16-byte aligned) or 1 ("cp_async");
// lanes 64 or 128.  a, b and h (B, S, W), h0 (B, W) or null (zeros),
// float32, contiguous.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int rglru_scan_f32(int variant, int lanes, const void* a, const void* b,
                              const void* h0, void* h, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (variant == 0 && (W % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
                       reinterpret_cast<uintptr_t>(b) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 64) return launch<64>(variant, a, b, h0, h, B, S, W, st);
  if (lanes == 128) return launch<128>(variant, a, b, h0, h, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}
