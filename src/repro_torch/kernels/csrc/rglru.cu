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
// Design.  The TPU kernel tiles (batch, width block, time block) with time
// innermost and carries the state row in VMEM.  One thread per (b, lane)
// walking all S steps gives only B * W = 16,384 threads at the served
// shape, 4 warps an SM, too few loads in flight to approach the card's
// bandwidth.  So time is cut into C chunks of L steps (C <= 16), and the
// recurrence is composed chunk-wise in two passes, one thread per
// (b, chunk, lane), lanes fastest so that a warp's loads of a step are 32
// consecutive floats and a CTA's 256:
//   1. summary: each chunk's composite map h -> A h + Bs, with A the
//      product of its a_t and Bs its recurrence from zero, into a small
//      (B, C, W) scratch pair;
//   2. scan: each chunk folds h0 through the earlier chunks' maps to its
//      entering state, then walks its own steps and writes h.
// Pass 2 reads a and b again: 335 MB moved against the bound's 201 MB, in
// exchange for C times the threads.  With C = 1 (S <= 64) pass 1 is
// skipped.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    summary_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ sum_a, float* __restrict__ sum_b, int S, int W, int L,
                   int C) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y;
  const size_t row = blockIdx.z;
  const int t0 = c * L, t1 = min(S, t0 + L);
  const size_t off = (row * S + t0) * W + w;
  const float* ap = a + off;
  const float* bp = b + off;
  float prod = 1.f, acc = 0.f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const float at = *ap, bt = *bp;
    prod *= at;
    acc = fmaf(at, acc, bt);
    ap += W;
    bp += W;
  }
  sum_a[(row * C + c) * W + w] = prod;
  sum_b[(row * C + c) * W + w] = acc;
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, const float* __restrict__ sum_a,
                const float* __restrict__ sum_b, float* __restrict__ h, int S, int W, int L,
                int C) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y;
  const size_t row = blockIdx.z;
  float state = h0 ? h0[row * W + w] : 0.f;
  for (int k = 0; k < c; ++k)
    state = fmaf(sum_a[(row * C + k) * W + w], state, sum_b[(row * C + k) * W + w]);
  const int t0 = c * L, t1 = min(S, t0 + L);
  const size_t off = (row * S + t0) * W + w;
  const float* ap = a + off;
  const float* bp = b + off;
  float* hp = h + off;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    state = fmaf(*ap, state, *bp);
    *hp = state;
    ap += W;
    bp += W;
    hp += W;
  }
}

}  // namespace

// a, b and h (B, S, W), h0 (B, W) or null (zeros), float32, contiguous;
// sum_a and sum_b (B, C, W) float32 scratch (unused when C = 1); the C
// chunks of L steps cover S ((C - 1) * L < S <= C * L).  Returns the CUDA
// error code of the launches (0 on success).
extern "C" int rglru_scan_f32(const void* a, const void* b, const void* h0, void* sum_a,
                              void* sum_b, void* h, int B, int S, int W, int L, int C,
                              void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535 || C < 1 || C > 65535 || L < 1 ||
      static_cast<long long>(C - 1) * L >= S || static_cast<long long>(C) * L < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kThreads - 1) / kThreads, C, B);
  if (C > 1) {
    summary_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(a),
                                              static_cast<const float*>(b),
                                              static_cast<float*>(sum_a),
                                              static_cast<float*>(sum_b), S, W, L, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(h0),
      static_cast<const float*>(sum_a), static_cast<const float*>(sum_b), static_cast<float*>(h),
      S, W, L, C);
  return (int)cudaGetLastError();
}
