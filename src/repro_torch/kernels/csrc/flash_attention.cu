// Causal flash attention with GQA, sliding window and logit softcap, for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/attention.py:flash_attention
// (body _kernel): o = softmax(mask(softcap(q k^T / sqrt(D)))) v over
// positions 0..S-1, query head h reading KV head h / (H / KV), with the
// online softmax (acc, m, l) in float32, the mask value -2e38 and the
// normaliser max(l, 1e-37) of the TPU kernel.
//
// Bound on an H100 SXM at the served prefill (gemma2-2b: B=4, S=2048,
// H=8, KV=4, D=256, causal): 4*B*H*D*S(S+1)/2 = 68.7 GFLOP, 69 us at the
// 989 TFLOP/s of bf16 tensor cores, against 100.7 MB of q, k, v and o,
// 30 us at 3.35 TB/s: compute-bound.
//
// Design.  The TPU kernel walks its (b, h, q block, kv block) grid in
// order and carries the softmax state in VMEM across kv steps.  Here one
// CTA of 128 threads owns one (b, h, 32-query block) and loops over the
// K/V tiles itself, from the first key the window can reach to the causal
// diagonal, skipping tiles the mask empties entirely; no state crosses
// CTAs.  Blocks are launched heaviest (latest queries) first.  The q block
// and each K/V tile are copied into shared memory with cp.async in the
// input type; scores, softmax and both products run as SIMT float32 FMAs
// (no tensor cores yet: that is later work, and it is why the kernel is far
// from its bound).  Each warp owns 8 query rows for the whole tile: its
// lanes split the tile's keys for q k^T, reduce row max and sum with
// shuffles, write p to shared memory, and split the head dimension for
// p v, so the accumulator (8 rows x D/32 columns a lane, 64 floats at
// D=256) stays in registers and only the K/V tile loads need the whole
// CTA to synchronise.  head_dim 256 is why the query block is 32 rows: a
// 64-row block would need 128 accumulator registers a thread.  Keys and
// queries past S (a ragged tail) are zero-filled and masked.
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kBlockQ = 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;

template <typename T, int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBlockQ + 2 * tile_rows<T>()) * (D + kPad) * sizeof(T) +
         static_cast<size_t>(kBlockQ) * (tile_rows<T>() + 4) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int KV, float scale, float softcap,
                 int window) {
  constexpr int BK = tile_rows<T>();
  constexpr int LDS = D + kPad;        // tile row stride (elements)
  constexpr int LDP = BK + 4;          // p row stride (floats)
  constexpr int CPL = BK / 32;         // score columns per lane
  constexpr int VEC = D >= 128 ? 4 : 2;
  constexpr int NCH = D / (32 * VEC);  // output chunks per lane
  static_assert(NCH >= 1 && CPL >= 1, "unsupported tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBlockQ * LDS;
  T* Vs = Ks + BK * LDS;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LDS);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const size_t q_stride = static_cast<size_t>(H) * D;    // between positions
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* q_base = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * D;
  const T* k_base = k + static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(g) * D;
  const T* v_base = v + static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(g) * D;

  load_tile<T, D>(Qs, q_base + q0 * q_stride, q_stride, kBlockQ, S - q0);

  float acc[kRowsPerWarp][NCH][VEC];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][c][e] = 0.f;
  }

  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = q_last / BK + 1;

  for (int t = k_first / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, D>(Ks, k_base + k0 * kv_stride, kv_stride, BK, S - k0);
    load_tile<T, D>(Vs, v_base + k0 * kv_stride, kv_stride, BK, S - k0);
    cp_async_wait_all();
    __syncthreads();

    // Scores of this warp's rows against the tile's keys.
    float s[kRowsPerWarp][CPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv4[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) kv4[c] = load4(Ks + (lane + 32 * c) * LDS + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = load4(Qs + (warp + kWarps * r) * LDS + d);
#pragma unroll
        for (int c = 0; c < CPL; ++c) s[r][c] += dot4(qv, kv4[c]);
      }
    }

    // Scale, softcap, mask, and the online softmax of each row.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int kpos = k0 + lane + 32 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos <= qpos && kpos < S && (window <= 0 || kpos > qpos - window);
        s[r][c] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[row * LDP + lane + 32 * c] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][c][e] *= alpha;
    }
    __syncwarp();

    // acc += p v: each lane owns VEC consecutive columns per chunk.
    for (int j = 0; j < BK; j += 4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p4[r] = *reinterpret_cast<const float4*>(Ps + (warp + kWarps * r) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* v_row = Vs + (j + jj) * LDS + lane * VEC;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 x = load4(v_row + c * 32 * VEC);
            vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
          } else {
            const float2 x = load2(v_row + c * 32 * VEC);
            vv[0] = x.x; vv[1] = x.y;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float p = component(p4[r], jj);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][c][e] += p * vv[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp + kWarps * r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], kMinDenom);
    T* o_row = o + static_cast<size_t>(b) * S * q_stride + qpos * q_stride +
               static_cast<size_t>(h) * D + lane * VEC;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) store(o_row + c * 32 * VEC + e, acc[r][c][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           float scale, float softcap, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto kernel = flash_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
             int KV, int D, float scale, float softcap, int window, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, softcap, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, softcap, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, scale, softcap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k and v (B, S, KV, D), o (B, S, H, D), all contiguous.
// softcap <= 0 means none, window <= 0 means none.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int KV, int D, float scale, float softcap,
                                   int window, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, KV, D, scale, softcap, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int S, int H, int KV, int D, float scale, float softcap,
                                    int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, scale, softcap, window, stream);
}
