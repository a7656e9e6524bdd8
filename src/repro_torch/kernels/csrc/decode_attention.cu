// Flash-decode for Hopper (sm_90a): one query token per sequence against a
// (ring) KV cache, behind a plain C interface loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (body _kernel).  For batch row b and KV head g, the R
// query heads that share g attend over the cache's L slots; a slot is valid
// when 0 <= pos <= cur (and pos > cur - window with a window), read from
// the shared (L,) position buffer, so ring buffers decode with the same
// code.  Softmax state in float32, mask value -2e38, normaliser
// max(l, 1e-37), as in the TPU kernel.  `cur` arrives as a launch argument
// where the TPU kernel had a scalar prefetch.
//
// Bound on an H100 SXM at the served decode (gemma2-2b: B=4, L=2064,
// KV=4, R=2, D=256, bf16): the 33.8 MB of K and V read once, about 10 us
// at 3.35 TB/s; the arithmetic (4*B*KV*R*L*D = 34 MFLOP) is negligible:
// bytes-bound.
//
// Design.  The TPU kernel walks the cache in order on one core.  B*KV is
// only 16 at the served shape, so here the slots are split over CTAs
// (n_split per (b, g), chosen by the wrapper so that about two CTAs per
// SM cover the card: 264 on an H100's 132 SMs): grid (n_split, KV, B) of 128 threads.  Each CTA
// streams its chunk of slots in tiles of K and V copied with cp.async into
// shared memory, scores each (query head, slot) pair with one thread,
// runs the online softmax of each query head on one warp, and keeps the
// (R, D) accumulator in shared memory.  It writes its (max, sum,
// accumulator) to a float32 scratch; a second kernel, one thread per
// output element, merges the splits by log-sum-exp.  Slots past L are
// zero-filled and weigh nothing.
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int D>
size_t smem_bytes(int R) {
  constexpr int BL = tile_rows<T>();
  return static_cast<size_t>(2 * BL) * (D + kPad) * sizeof(T) +
         (static_cast<size_t>(2 * R * D + R * BL + 3 * R) + BL) * sizeof(float);
}

// Scratch layout per (b, g, split): R maxima, R sums, then the (R, D)
// accumulator: R * (D + 2) floats.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ pos, float* __restrict__ part, int L, int KV, int R,
                 int cur, int chunk, float scale, float softcap, int window) {
  constexpr int BL = tile_rows<T>();
  constexpr int LDS = D + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BL * LDS;
  float* Qs = reinterpret_cast<float*>(Vs + BL * LDS);  // (R, D)
  float* Acc = Qs + R * D;                              // (R, D)
  float* Ss = Acc + R * D;                              // (R, BL) scores, then p
  float* Ms = Ss + R * BL;                              // (R,) running max
  float* Ls = Ms + R;                                   // (R,) running sum
  float* As = Ls + R;                                   // (R,) this tile's rescale
  int* Pos = reinterpret_cast<int*>(As + R);            // (BL,)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rd = R * D;

  const T* q_row = q + (static_cast<size_t>(b) * KV + g) * rd;
  for (int i = threadIdx.x; i < rd; i += kThreads) {
    Qs[i] = to_float(q_row[i]);
    Acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  const size_t kv_stride = static_cast<size_t>(KV) * D;  // between slots
  const size_t base = static_cast<size_t>(b) * L * kv_stride + static_cast<size_t>(g) * D;
  const int l_begin = split * chunk;
  const int l_end = min(L, l_begin + chunk);

  for (int l0 = l_begin; l0 < l_end; l0 += BL) {
    __syncthreads();  // the previous tile is consumed (and Qs/Ms are set)
    load_tile<T, D>(Ks, k + base + l0 * kv_stride, kv_stride, BL, l_end - l0);
    load_tile<T, D>(Vs, v + base + l0 * kv_stride, kv_stride, BL, l_end - l0);
    for (int j = threadIdx.x; j < BL; j += kThreads) Pos[j] = l0 + j < l_end ? pos[l0 + j] : -1;
    cp_async_wait_all();
    __syncthreads();

    // One (query head, slot) score per thread and step.
    for (int idx = threadIdx.x; idx < R * BL; idx += kThreads) {
      const int r = idx / BL;
      const int j = idx % BL;
      const float* qr = Qs + r * D;
      const T* kr = Ks + j * LDS;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4)
        s += dot4(*reinterpret_cast<const float4*>(qr + d), load4(kr + d));
      float x = s * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int p = Pos[j];
      const bool ok = p >= 0 && p <= cur && (window <= 0 || p > cur - window);
      // Slots past the split get -inf, so that they weigh nothing even in
      // a split with no valid slot (where masked slots weigh exp(0) = 1 and
      // the result is the mean of v, as in the TPU kernel).
      Ss[idx] = l0 + j >= l_end ? -INFINITY : ok ? x : kNegInf;
    }
    __syncthreads();

    // Online softmax of each query head, one warp per head.
    for (int r = warp; r < R; r += kWarps) {
      float* sr = Ss + r * BL;
      float mx = kNegInf;
      for (int j = lane; j < BL; j += 32) mx = fmaxf(mx, sr[j]);
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < BL; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
        As[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v; each thread owns fixed (head, column) pairs.
    for (int i = threadIdx.x; i < rd; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const float* pr = Ss + r * BL;
      float a = Acc[i] * As[r];
#pragma unroll 8
      for (int j = 0; j < BL; ++j) a += pr[j] * to_float(Vs[j * LDS + d]);
      Acc[i] = a;
    }
  }
  __syncthreads();

  float* out = part + ((static_cast<size_t>(b) * KV + g) * gridDim.x + split) * (rd + 2 * R);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    out[r] = Ms[r];
    out[R + r] = Ls[r];
  }
  for (int i = threadIdx.x; i < rd; i += kThreads) out[2 * R + i] = Acc[i];
}

// Merge the n_split partial softmaxes by log-sum-exp: one thread per
// output element, grid (B * KV, R * D / kThreads), so that the merge's
// dependent loads spread over many SMs (R = 16 gives 4,096 elements per
// (b, g)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part, T* __restrict__ o, int R, int D,
                   int n_split) {
  const int rd = R * D;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= rd) return;
  const size_t stride = static_cast<size_t>(rd + 2 * R);
  const float* base = part + static_cast<size_t>(blockIdx.x) * n_split * stride;
  const int r = i / D;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, base[s * stride + r]);
  float sum = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ps = base + s * stride;
    const float w = expf(ps[r] - mx);
    sum += ps[R + r] * w;
    acc += ps[2 * R + i] * w;
  }
  store(o + static_cast<size_t>(blockIdx.x) * rd + i, acc / fmaxf(sum, kMinDenom));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* o, float* part,
           int B, int L, int KV, int R, int cur, int n_split, int chunk, float scale,
           float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(R);
  auto kernel = split_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos, part,
      L, KV, R, cur, chunk, scale, softcap, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 merge_grid(B * KV, (R * D + kThreads - 1) / kThreads);
  combine_kernel<T><<<merge_grid, kThreads, 0, stream>>>(part, static_cast<T*>(o), R, D,
                                                         n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* pos, void* o,
             void* scratch, int B, int L, int KV, int R, int D, int cur, int n_split, int chunk,
             float scale, float softcap, int window, void* stream) {
  if (B < 1 || L < 1 || KV < 1 || R < 1 || n_split < 1 || chunk < 1 ||
      chunk % tile_rows<T>() != 0 || static_cast<long long>(n_split) * chunk < L)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  float* part = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, p, o, part, B, L, KV, R, cur, n_split, chunk, scale, softcap,
                           window, st);
    case 128:
      return launch<T, 128>(q, k, v, p, o, part, B, L, KV, R, cur, n_split, chunk, scale,
                            softcap, window, st);
    case 256:
      return launch<T, 256>(q, k, v, p, o, part, B, L, KV, R, cur, n_split, chunk, scale,
                            softcap, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV, R, D), k and v (B, L, KV, D), pos (L,) int32, o (B, KV, R, D),
// scratch B*KV*n_split*R*(D+2) floats, all contiguous.  Split s covers
// slots [s*chunk, min(L, (s+1)*chunk)).  softcap <= 0 means none,
// window <= 0 means none.  Returns the CUDA error code of the launches.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, void* scratch, int B, int L,
                                    int KV, int R, int D, int cur, int n_split, int chunk,
                                    float scale, float softcap, int window, void* stream) {
  return dispatch<float>(q, k, v, pos, o, scratch, B, L, KV, R, D, cur, n_split, chunk, scale,
                         softcap, window, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* pos, void* o, void* scratch, int B, int L,
                                     int KV, int R, int D, int cur, int n_split, int chunk,
                                     float scale, float softcap, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, pos, o, scratch, B, L, KV, R, D, cur, n_split, chunk,
                                 scale, softcap, window, stream);
}
