// Batched bounded multi-dimensional knapsack DP: colgen's pricing kernel.
//
// Replaces the TPU kernel repro/kernels/knapsack.py:_pallas_body/_pallas_call
// (grid over the batch, fori_loop over steps, state row in VMEM).
//
// For batch row b and binary-split step t, over every state s of the shared
// C-order grid (coord[s, d] = (s / stride[d]) % level[d]):
//
//     fits  = all_d coord[s, d] >= w[b, t, d]
//     shift = sum_d w[b, t, d] * stride[d]
//     cand  = val[s - shift] + v[b, t]
//     take  = fits && cand > val[s]
//     val'  = take ? cand : val[s]
//
// Every step reads the previous step's array, so a pseudo-step is taken at
// most once.  With weights >= 0 (checked by the wrapper), fits implies
// 0 <= s - shift <= s (s - shift = sum_d (coord - w) * stride), so the
// gather stays inside the row; it is skipped where fits is false.  The
// arithmetic is one add and compares, in the value type: the result is
// bit-identical to the plain version (build with --fmad=false so a later
// multiply cannot contract into an FMA).
//
// Design: one CTA per knapsack loops over the T steps.  The state row does
// not fit in shared memory at the main path's shapes (30,940 float64 states
// are 247,520 B against the 232,448 B a block may have), so it lives in two
// global ping-pong buffers of S values each, which stay in L2; a
// __syncthreads() separates the steps.  `take` is written as one byte per
// state in the (T, B, S) layout the host backtrack reads; `best` is
// val[final_idx[b]] after the last step.
//
// Bound on the card: memory.  The least traffic is the take output, T*B*S
// bytes, plus the inputs: 18.6 MB, some 5.5 us at 3.35 TB/s, at the largest
// call of a 500-camera allocate (B=15, T=40, S=30,940).  With only B CTAs busy
// (3-18 against 132 SMs) and the state row re-read from L2 every step, the
// kernel runs far above that bound; bit-packing take, more CTAs per
// knapsack and a device backtrack are the ways down.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDims = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
knapsack_dp_kernel(const T* __restrict__ step_values,       // (B, T)
                   const int64_t* __restrict__ step_weights,// (B, T, D)
                   const int64_t* __restrict__ levels,      // (D,)
                   const int64_t* __restrict__ strides,     // (D,)
                   const int64_t* __restrict__ final_idx,   // (B,)
                   T* __restrict__ scratch,                 // (B, 2, S)
                   uint8_t* __restrict__ take,              // (T, B, S)
                   T* __restrict__ best,                    // (B,)
                   int n_batch, int n_steps, int64_t n_states, int n_dims) {
  __shared__ int64_t s_levels[kMaxDims];
  __shared__ int64_t s_strides[kMaxDims];
  __shared__ int64_t s_w[kMaxDims];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  T* buf0 = scratch + (int64_t)b * 2 * n_states;
  T* buf1 = buf0 + n_states;

  for (int d = tid; d < n_dims; d += blockDim.x) {
    s_levels[d] = levels[d];
    s_strides[d] = strides[d];
  }
  for (int64_t s = tid; s < n_states; s += blockDim.x) buf0[s] = T(0);
  __syncthreads();

  const T* prev = buf0;
  T* cur = buf1;
  for (int t = 0; t < n_steps; ++t) {
    const int64_t bt = (int64_t)b * n_steps + t;
    for (int d = tid; d < n_dims; d += blockDim.x) s_w[d] = step_weights[bt * n_dims + d];
    __syncthreads();
    const T v = step_values[bt];
    int64_t shift = 0;
    for (int d = 0; d < n_dims; ++d) shift += s_w[d] * s_strides[d];
    uint8_t* take_row = take + ((int64_t)t * n_batch + b) * n_states;
    for (int64_t s = tid; s < n_states; s += blockDim.x) {
      bool fits = true;
      for (int d = 0; d < n_dims; ++d) {
        const int64_t c = (s / s_strides[d]) % s_levels[d];
        fits = fits && (c >= s_w[d]);
      }
      const T old = prev[s];
      T out = old;
      uint8_t tk = 0;
      if (fits) {
        const T cand = prev[s - shift] + v;
        if (cand > old) {
          out = cand;
          tk = 1;
        }
      }
      cur[s] = out;
      take_row[s] = tk;
    }
    // The next step reads `cur` at other threads' states and overwrites
    // `prev`: every thread must be done with this step first.
    __syncthreads();
    const T* tmp = prev;
    prev = cur;
    cur = const_cast<T*>(tmp);
  }
  if (tid == 0) best[b] = prev[final_idx[b]];
}

template <typename T>
int launch(const void* step_values, const void* step_weights,
           const void* levels, const void* strides, const void* final_idx,
           void* scratch, void* take, void* best, int n_batch, int n_steps,
           long long n_states, int n_dims, void* stream) {
  if (n_dims > kMaxDims || n_dims < 1) return (int)cudaErrorInvalidValue;
  knapsack_dp_kernel<T><<<n_batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)step_values, (const int64_t*)step_weights,
      (const int64_t*)levels, (const int64_t*)strides, (const int64_t*)final_idx,
      (T*)scratch, (uint8_t*)take, (T*)best, n_batch, n_steps, (int64_t)n_states,
      n_dims);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int knapsack_dp_f64(const void* step_values, const void* step_weights,
                    const void* levels, const void* strides, const void* final_idx,
                    void* scratch, void* take, void* best, int n_batch, int n_steps,
                    long long n_states, int n_dims, void* stream) {
  return launch<double>(step_values, step_weights, levels, strides, final_idx,
                        scratch, take, best, n_batch, n_steps, n_states, n_dims, stream);
}

int knapsack_dp_f32(const void* step_values, const void* step_weights,
                    const void* levels, const void* strides, const void* final_idx,
                    void* scratch, void* take, void* best, int n_batch, int n_steps,
                    long long n_states, int n_dims, void* stream) {
  return launch<float>(step_values, step_weights, levels, strides, final_idx,
                       scratch, take, best, n_batch, n_steps, n_states, n_dims, stream);
}

}  // extern "C"
