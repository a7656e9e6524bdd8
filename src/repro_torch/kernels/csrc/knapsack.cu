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
// Every step reads the previous step's row, so a pseudo-step is taken at
// most once.  fits implies 0 <= s - shift <= s, so the gather stays inside
// the row; it is skipped where fits is false.  The arithmetic is one add and
// compares in the value type, so any split of the states over threads gives
// the plain version's result bit for bit; only the order of the steps
// matters, and it is kept (built with --fmad=false all the same).
//
// Bound on the card at the largest call of a 500-camera allocate (B=15,
// T=40, S=30,940): the take bits, 2.3 MB packed, and the inputs are some
// 0.7 us at 3.35 TB/s.  The real floor is T dependent steps, each ending in
// a barrier across the CTAs that share a row.
//
// Design.
//   - Coordinates once.  Each thread owns fixed states for the whole call
//     and packs their digits once into one 64-bit word, a field per
//     dimension of level >= 2 with a guard bit above it (`guards`).  A
//     step's weights pack the same way (`need`), so fits is one subtraction:
//     ((x - need) & guards) == guards.  A step with a weight outside
//     [0, level) fits nowhere (shift = -1).  The wrapper lays the fields out
//     (knapsack._packing); they take at most 2 log2(S) < 62 bits.
//   - Variant "cluster": the C CTAs of a thread-block cluster (C <= 16)
//     share one knapsack, each holding a slice of P = 2^k states (a multiple
//     of 32, at most kMaxSlice) of the row in shared memory, ping-pong.  The
//     shifted read val[s - shift] goes to the CTA that owns that state
//     through distributed shared memory; one cluster barrier ends a step,
//     its writes released by one fence a CTA.
//     The wrapper picks C from B, S and the SM count (knapsack._layout).
//   - Variant "global": rows larger than 16 slices.  One CTA a knapsack,
//     the row in two global ping-pong buffers (L2), the packed coordinates
//     in a global table; __syncthreads() ends a step.
//   - take is packed by __ballot_sync, one 32-bit word per 32 states, in a
//     (T, B, ceil(S / 32)) layout.
//   - The backtrack runs on the card: after the last step one thread per
//     knapsack walks t = T-1 .. 0 from final_idx[b] through the packed bits
//     (still in L2) and writes the (B, T) mask of the steps taken, so the
//     host copies best and that mask, not the take bits.
//
// Probes, defined only by scripts/torch_knapsack_probe.py's builds (their
// results are wrong by design): KNAPSACK_PROBE_EMPTY_STEPS leaves the
// cluster variant's step loop with its parameter loads and barriers only,
// KNAPSACK_PROBE_NO_TAKE drops its take stores, KNAPSACK_PROBE_NO_BACKTRACK
// its backtrack.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDims = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlice = 8192;  // states a CTA of the cluster variant holds
constexpr int kMaxCluster = 16;
constexpr int kGlobalThreads = 1024;

// The grid, by value in the kernels' parameters.
struct Grid {
  int n_dims;
  int n_states;
  int level[kMaxDims];
  int stride[kMaxDims];
  int offset[kMaxDims];  // bit offset of the dimension's field (level >= 2)
  unsigned long long guards;
};

// One step's packed weights and flat shift; shift < 0: fits nowhere.
struct Step {
  unsigned long long need;
  long long shift;
};

__device__ __forceinline__ unsigned long long pack_coords(const Grid& g, int s) {
  unsigned long long x = g.guards;
  for (int d = 0; d < g.n_dims; ++d) {
    const unsigned c = (static_cast<unsigned>(s) / static_cast<unsigned>(g.stride[d])) %
                       static_cast<unsigned>(g.level[d]);
    x += static_cast<unsigned long long>(c) << g.offset[d];
  }
  return x;
}

__device__ __forceinline__ bool fits(unsigned long long x, const Step& st,
                                     unsigned long long guards) {
  return st.shift >= 0 && ((x - st.need) & guards) == guards;
}

__global__ void steps_kernel(const int64_t* __restrict__ step_weights,  // (B, T, D)
                             const __grid_constant__ Grid g, Step* __restrict__ steps, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t* w = step_weights + static_cast<int64_t>(i) * g.n_dims;
  unsigned long long need = 0;
  long long shift = 0;
  bool live = true;
  for (int d = 0; d < g.n_dims; ++d) {
    const int64_t wd = w[d];
    if (wd < 0 || wd >= g.level[d]) {
      live = false;
    } else {
      need += static_cast<unsigned long long>(wd) << g.offset[d];
      shift += wd * g.stride[d];
    }
  }
  steps[i] = Step{need, live ? shift : -1};
}

__global__ void coords_kernel(const __grid_constant__ Grid g,
                              unsigned long long* __restrict__ coords) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < g.n_states) coords[s] = pack_coords(g, s);
}

// One thread walks the take bits of knapsack b back from its capacity state.
__device__ void backtrack(const uint32_t* take, const Step* steps, int64_t final_idx, int b,
                          int n_batch, int n_steps, int words, uint8_t* taken) {
  long long s = final_idx;
  for (int t = n_steps - 1; t >= 0; --t) {
    // The shift does not depend on s: its load is in flight with the word's.
    const long long shift = steps[static_cast<int64_t>(b) * n_steps + t].shift;
    const uint32_t word =
        __ldcg(take + (static_cast<int64_t>(t) * n_batch + b) * words + (s >> 5));
    const uint8_t bit = (word >> (s & 31)) & 1u;
    taken[static_cast<int64_t>(b) * n_steps + t] = bit;
    if (bit) s -= shift;
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Variant "cluster": grid (C, B), cluster (C, 1, 1); CTA r of cluster b owns
// states [r P, r P + P) of knapsack b; K = P / blockDim.x states a thread.
template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
knapsack_cluster(const T* __restrict__ step_values,  // (B, T)
                 const Step* __restrict__ steps,    // (B, T)
                 const int64_t* __restrict__ final_idx,  // (B,)
                 const __grid_constant__ Grid g, int n_batch, int n_steps, int slice_log2,
                 uint32_t* __restrict__ take,  // (T, B, words)
                 uint8_t* __restrict__ taken,  // (B, T)
                 T* __restrict__ best) {       // (B,)
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = 1 << slice_log2;
  T* prev = reinterpret_cast<T*>(smem_raw);
  T* cur = prev + P;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int S = g.n_states;
  const int words = (S + 31) >> 5;
  const int base = rank * P;

  unsigned long long x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = j * n_threads + tid;
    x[j] = base + i < S ? pack_coords(g, base + i) : 0ull;
    prev[i] = T(0);
  }
  // Every CTA of the cluster is running and its row is zero before any
  // reads another's shared memory.
  cluster.sync();

  const Step* my_steps = steps + static_cast<int64_t>(b) * n_steps;
  const T* my_values = step_values + static_cast<int64_t>(b) * n_steps;
  Step next = n_steps > 0 ? my_steps[0] : Step{0, -1};
  T next_v = n_steps > 0 ? my_values[0] : T(0);
  for (int t = 0; t < n_steps; ++t) {
    const Step st = next;
    const T v = next_v;
    if (t + 1 < n_steps) {
      next = my_steps[t + 1];
      next_v = my_values[t + 1];
    }
#ifndef KNAPSACK_PROBE_EMPTY_STEPS
    // In groups of up to four states a thread: their shifted reads are in
    // flight together, and the registers stay within 64 a thread.
    constexpr int G = K < 4 ? K : 4;
    uint32_t word[K];
#pragma unroll
    for (int j0 = 0; j0 < K; j0 += G) {
      T old[G], got[G];
      bool f[G];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int i = (j0 + jj) * n_threads + tid;
        old[jj] = prev[i];
        f[jj] = base + i < S && fits(x[j0 + jj], st, g.guards);
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        got[jj] = T(0);
        if (f[jj]) {
          const int src = base + (j0 + jj) * n_threads + tid - static_cast<int>(st.shift);
          got[jj] = *cluster.map_shared_rank(prev + (src & (P - 1)), src >> slice_log2);
        }
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const T cand = got[jj] + v;
        const bool tk = f[jj] && cand > old[jj];
        cur[(j0 + jj) * n_threads + tid] = tk ? cand : old[jj];
        word[j0 + jj] = __ballot_sync(0xffffffffu, tk);
      }
    }
#endif
    // The row's writes are released before the barrier: the CTA's threads
    // meet, then thread 0's fence at cluster scope releases all of them
    // (a release is cumulative) before its arrival, and the others arrive
    // relaxed: one fence a CTA costs less than a release by every thread.
    // The take words are stored while the other CTAs arrive (the next
    // fence orders them).
    __syncthreads();
    if (tid == 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
    cluster_arrive_relaxed();
#if !defined(KNAPSACK_PROBE_EMPTY_STEPS) && !defined(KNAPSACK_PROBE_NO_TAKE)
    if (lane == 0) {
      uint32_t* row = take + (static_cast<int64_t>(t) * n_batch + b) * words;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int w = (base + j * n_threads + tid) >> 5;
        if (w < words) row[w] = word[j];
      }
    }
#endif
    cluster_wait();
    T* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  // The last step's take words, stored after its arrival, are released here.
  cluster.sync();
  const int64_t fi = final_idx[b];
  if (tid == 0 && rank == static_cast<int>(fi >> slice_log2)) best[b] = prev[fi & (P - 1)];
#ifndef KNAPSACK_PROBE_NO_BACKTRACK
  if (tid == 0 && rank == 0)
    backtrack(take, steps, fi, b, n_batch, n_steps, words, taken);
#endif
}

// Variant "global": one CTA per knapsack, the row in global ping-pong buffers.
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads)
knapsack_global(const T* __restrict__ step_values, const Step* __restrict__ steps,
                const int64_t* __restrict__ final_idx, const unsigned long long* __restrict__ coords,
                const __grid_constant__ Grid g, int n_batch, int n_steps,
                T* __restrict__ scratch,  // (B, 2, S)
                uint32_t* __restrict__ take, uint8_t* __restrict__ taken, T* __restrict__ best) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = g.n_states;
  const int words = (S + 31) >> 5;
  T* prev = scratch + static_cast<int64_t>(b) * 2 * S;
  T* cur = prev + S;
  for (int s = tid; s < S; s += blockDim.x) prev[s] = T(0);
  __syncthreads();
  const Step* my_steps = steps + static_cast<int64_t>(b) * n_steps;
  for (int t = 0; t < n_steps; ++t) {
    const Step st = my_steps[t];
    const T v = step_values[static_cast<int64_t>(b) * n_steps + t];
    uint32_t* row = take + (static_cast<int64_t>(t) * n_batch + b) * words;
    // blockDim.x is a multiple of 32, so a warp's states are one word.
    for (int s0 = 0; s0 < S; s0 += blockDim.x) {
      const int s = s0 + tid;
      bool tk = false;
      if (s < S) {
        const T o = prev[s];
        T out = o;
        if (fits(coords[s], st, g.guards)) {
          const T cand = prev[s - st.shift] + v;
          if (cand > o) {
            out = cand;
            tk = true;
          }
        }
        cur[s] = out;
      }
      const uint32_t word = __ballot_sync(0xffffffffu, tk);
      if ((tid & 31) == 0 && s < S) row[s >> 5] = word;
    }
    // The next step reads `cur` at other threads' states and overwrites
    // `prev`: every thread must be done with this step first.
    __syncthreads();
    T* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  const int64_t fi = final_idx[b];
  if (tid == 0) {
    best[b] = prev[fi];
    backtrack(take, steps, fi, b, n_batch, n_steps, words, taken);
  }
}

template <typename T, int K>
int launch_cluster(const void* step_values, const Step* steps, const void* final_idx,
                   const Grid& g, int n_batch, int n_steps, int cluster, int slice_log2,
                   void* take, void* taken, void* best, cudaStream_t stream) {
  const int P = 1 << slice_log2;
  const int threads = P < kMaxThreads ? P : kMaxThreads;
  const size_t smem = 2 * static_cast<size_t>(P) * sizeof(T);
  auto kernel = knapsack_cluster<T, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_batch, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(step_values), steps,
                           static_cast<const int64_t*>(final_idx), g, n_batch, n_steps,
                           slice_log2, static_cast<uint32_t*>(take),
                           static_cast<uint8_t*>(taken), static_cast<T*>(best));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int variant, int cluster, int slice_log2, const void* step_values,
           const void* step_weights, const void* final_idx, const int* levels,
           const int* strides, const int* offsets, unsigned long long guards, int n_dims,
           int n_batch, int n_steps, long long n_states, void* steps_scratch, void* coords,
           void* scratch, void* take, void* taken, void* best, void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || n_batch < 1 || n_batch > 65535 || n_steps < 0 ||
      n_states < 1 || n_states >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Grid g = {};
  g.n_dims = n_dims;
  g.n_states = static_cast<int>(n_states);
  for (int d = 0; d < n_dims; ++d) {
    if (levels[d] < 1 || strides[d] < 1 || offsets[d] < 0 || offsets[d] > 63)
      return (int)cudaErrorInvalidValue;
    g.level[d] = levels[d];
    g.stride[d] = strides[d];
    g.offset[d] = offsets[d];
  }
  g.guards = guards;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step* steps = static_cast<Step*>(steps_scratch);
  const int n = n_batch * n_steps;
  if (n > 0) {
    steps_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const int64_t*>(step_weights), g,
                                                   steps, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (variant == 0) {  // cluster
    if (slice_log2 < 5 || slice_log2 > 30) return (int)cudaErrorInvalidValue;
    const long long P = 1ll << slice_log2;
    if (P > kMaxSlice || cluster < 1 || cluster > kMaxCluster ||
        (cluster - 1) * P >= n_states || cluster * P < n_states)
      return (int)cudaErrorInvalidValue;
    const int threads = P < kMaxThreads ? static_cast<int>(P) : kMaxThreads;
    switch (P / threads) {
      case 1: return launch_cluster<T, 1>(step_values, steps, final_idx, g, n_batch, n_steps,
                                          cluster, slice_log2, take, taken, best, st);
      case 2: return launch_cluster<T, 2>(step_values, steps, final_idx, g, n_batch, n_steps,
                                          cluster, slice_log2, take, taken, best, st);
      case 4: return launch_cluster<T, 4>(step_values, steps, final_idx, g, n_batch, n_steps,
                                          cluster, slice_log2, take, taken, best, st);
      case 8: return launch_cluster<T, 8>(step_values, steps, final_idx, g, n_batch, n_steps,
                                          cluster, slice_log2, take, taken, best, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != 1) return (int)cudaErrorInvalidValue;
  auto* table = static_cast<unsigned long long*>(coords);
  coords_kernel<<<(g.n_states + 255) / 256, 256, 0, st>>>(g, table);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knapsack_global<T><<<n_batch, kGlobalThreads, 0, st>>>(
      static_cast<const T*>(step_values), steps, static_cast<const int64_t*>(final_idx), table, g,
      n_batch, n_steps, static_cast<T*>(scratch), static_cast<uint32_t*>(take),
      static_cast<uint8_t*>(taken), static_cast<T*>(best));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0 ("cluster"): `cluster` CTAs a knapsack, slices of 2^slice_log2
// states; variant 1 ("global"): coords (S,) uint64 and scratch (B, 2, S)
// values.  levels, strides and offsets are host arrays of n_dims ints;
// steps_scratch (B, T) 16-byte entries; take (T, B, ceil(S / 32)) uint32,
// taken (B, T) uint8, best (B,).  Returns a CUDA error code (0 on success).
int knapsack_dp_f64(int variant, int cluster, int slice_log2, const void* step_values,
                    const void* step_weights, const void* final_idx, const int* levels,
                    const int* strides, const int* offsets, unsigned long long guards,
                    int n_dims, int n_batch, int n_steps, long long n_states,
                    void* steps_scratch, void* coords, void* scratch, void* take, void* taken,
                    void* best, void* stream) {
  return launch<double>(variant, cluster, slice_log2, step_values, step_weights, final_idx,
                        levels, strides, offsets, guards, n_dims, n_batch, n_steps, n_states,
                        steps_scratch, coords, scratch, take, taken, best, stream);
}

int knapsack_dp_f32(int variant, int cluster, int slice_log2, const void* step_values,
                    const void* step_weights, const void* final_idx, const int* levels,
                    const int* strides, const int* offsets, unsigned long long guards,
                    int n_dims, int n_batch, int n_steps, long long n_states,
                    void* steps_scratch, void* coords, void* scratch, void* take, void* taken,
                    void* best, void* stream) {
  return launch<float>(variant, cluster, slice_log2, step_values, step_weights, final_idx,
                       levels, strides, offsets, guards, n_dims, n_batch, n_steps, n_states,
                       steps_scratch, coords, scratch, take, taken, best, stream);
}

// The largest slice a CTA of the cluster variant holds, and the largest
// cluster: knapsack._MAX_SLICE and knapsack._MAX_CLUSTER must equal these.
int knapsack_max_slice() { return kMaxSlice; }
int knapsack_max_cluster() { return kMaxCluster; }

}  // extern "C"
