// Mamba-2 SSD chunked scan for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:ssd_scan (body _kernel):
// per (batch b, head h) the recurrence h_t = exp(dt_t A) h_{t-1} +
// dt_t x_t B_t^T, y_t = h_t C_t with a float32 (P, N) state, computed chunk
// by chunk.  With cum the inclusive sum of dt A inside a chunk and total its
// last value, a chunk gives
//   y_i   = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j + e^{cum_i} C_i . h_in
//   h_out = e^{total} h_in + sum_j e^{total - cum_j} dt_j x_j B_j^T.
//
// Bound on an H100 SXM at mamba2-1.3b's served prefill (B=4, S=1024, H=64,
// P=64, N=128, bf16): x and y 33.6 MB each, h0 and h 8.4 MB each, dt 1 MB,
// B and C 2.1 MB: 87 MB, 26 us at 3.35 TB/s, against about 21.5 GFLOP,
// 22 us at the 989 TFLOP/s of bf16 tensor cores: bytes-bound.
//
// Design.  The TPU kernel walks (b, h, chunk) with chunks innermost and
// carries the state in VMEM.  Here one CTA of 256 threads owns one (b, h)
// and loops over its chunks itself, so nothing crosses CTAs; the last chunk
// may be partial (rows past S are zero-filled, and dt = 0 there adds
// nothing), so any S works.  Per chunk the x, B and C tiles sit in shared
// memory in the input type, B rows padded by 4 elements so that lanes
// reading the same columns of different rows hit distinct banks; the state
// stays in shared memory in float32, transposed to (N, P).  The Q x Q
// weights w_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j are built 32 rows at a
// time (32 x Q float32), which keeps the float32 tiles at Q = 128, P = 64,
// N = 128 at 217 KB, inside the 227 KB a block may have.  The three
// products (C B^T, w (x), and the state's outer products) are SIMT
// float32 FMAs with one operand broadcast from shared memory; a row block
// skips the keys past its last row.  No tensor cores and no reuse of
// C B^T across heads (B and C are shared by all heads, ngroups = 1): both
// are later work, and the reason the kernel is far from its bound.
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::dot4;
using attn::load4;
using attn::store;
using attn::to_float;

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of the Q x Q weights built at once

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Shared memory: x [Q][P], B [Q][N + 4], C [Q][N] in the input type; the
// state [N][P], one row block of weights [kRows][Q] and four vectors of Q
// (dt, cum, e^cum, dt e^{total - cum}) in float32.
template <typename T, int P, int N, int Q>
struct Layout {
  static constexpr int kLdB = N + 4;
  static constexpr size_t x_off = 0;
  static constexpr size_t b_off = align16(x_off + sizeof(T) * Q * P);
  static constexpr size_t c_off = align16(b_off + sizeof(T) * Q * kLdB);
  static constexpr size_t h_off = align16(c_off + sizeof(T) * Q * N);
  static constexpr size_t w_off = align16(h_off + sizeof(float) * N * P);
  static constexpr size_t v_off = align16(w_off + sizeof(float) * kRows * Q);
  static constexpr size_t bytes = v_off + sizeof(float) * 4 * Q;
};

template <typename T, int P, int N, int Q>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
               long long sBb, long long sBs, long long sCb, long long sCs, int S, int H) {
  using L = Layout<T, P, N, Q>;
  constexpr int LDB = L::kLdB;
  static_assert(Q % kRows == 0 && kThreads % Q == 0 && kThreads % P == 0, "tile shape");
  static_assert(L::bytes <= 232448, "shared memory");

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + L::x_off);
  T* bs = reinterpret_cast<T*>(smem + L::b_off);
  T* cs = reinterpret_cast<T*>(smem + L::c_off);
  float* hs = reinterpret_cast<float*>(smem + L::h_off);
  float* ws = reinterpret_cast<float*>(smem + L::w_off);
  float* dts = reinterpret_cast<float*>(smem + L::v_off);
  float* cum = dts + Q;
  float* ecum = cum + Q;
  float* sdec = ecum + Q;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a_h = A[h];
  const size_t state_base = (static_cast<size_t>(b) * H + h) * P * N;
  const long long row0 = static_cast<long long>(b) * S;  // first position of x, dt, y

  for (int idx = tid; idx < P * N; idx += kThreads)
    hs[(idx % N) * P + idx / N] = h0 ? h0[state_base + idx] : 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);  // valid rows of this chunk
    __syncthreads();                // every thread is done with the previous tiles
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P;
      xs[idx] = j < qv ? x[((row0 + s0 + j) * H + h) * P + idx % P] : zero<T>();
    }
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int j = idx / N, n = idx % N;
      const bool ok = j < qv;
      const long long pos = s0 + j;
      bs[j * LDB + n] = ok ? Bm[b * sBb + pos * sBs + n] : zero<T>();
      cs[idx] = ok ? Cm[b * sCb + pos * sCs + n] : zero<T>();
    }
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = j < qv ? dt[(row0 + s0 + j) * H + h] : 0.f;
    __syncthreads();

    // cum: inclusive sum of dt A, by warp 0 (Q / 32 consecutive rows a lane).
    if (tid < 32) {
      constexpr int E = Q / 32;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += dts[tid * E + e] * a_h;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) cum[tid * E + e] = v[e] + excl;
    }
    __syncthreads();
    const float total = cum[Q - 1];  // rows past qv add dt A = 0
    for (int j = tid; j < Q; j += kThreads) {
      ecum[j] = expf(cum[j]);
      sdec[j] = dts[j] * expf(total - cum[j]);
    }

    const int n_blocks = (qv + kRows - 1) / kRows;
    for (int rb = 0; rb < n_blocks; ++rb) {
      const int i0 = rb * kRows;
      __syncthreads();  // ws is free, and the vectors are written
      {
        // ws[r][j] = (C_i . B_j) e^{cum_i - cum_j} dt_j for j <= i = i0 + r.
        constexpr int R = kRows / (kThreads / Q);  // rows a thread
        const int j = tid % Q;
        const int r0 = (tid / Q) * R;
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        if (j < i0 + kRows) {  // warp-uniform: keys past the block's rows give 0
#pragma unroll 4
          for (int n = 0; n < N; n += 4) {
            const float4 bv = load4(bs + j * LDB + n);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += dot4(load4(cs + (i0 + r0 + r) * N + n), bv);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = i0 + r0 + r;
          ws[(r0 + r) * Q + j] = j <= i ? acc[r] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
      __syncthreads();
      {
        // y_i = sum_j ws[i][j] x_j + e^{cum_i} C_i . h_in, rows i0 .. i0 + 31.
        constexpr int R = kRows / (kThreads / P);
        const int p = tid % P;
        const int r0 = (tid / P) * R;
        float acc[R], acc_h[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = acc_h[r] = 0.f;
#pragma unroll 2
        for (int j = 0; j < i0 + kRows; j += 4) {
          float xv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = to_float(xs[(j + e) * P + p]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 w = *reinterpret_cast<const float4*>(ws + (r0 + r) * Q + j);
            acc[r] += w.x * xv[0] + w.y * xv[1] + w.z * xv[2] + w.w * xv[3];
          }
        }
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) hv[e] = hs[(n + e) * P + p];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 cv = load4(cs + (i0 + r0 + r) * N + n);
            acc_h[r] += cv.x * hv[0] + cv.y * hv[1] + cv.z * hv[2] + cv.w * hv[3];
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = i0 + r0 + r;
          if (i < qv) store(y + ((row0 + s0 + i) * H + h) * P + p, acc[r] + ecum[i] * acc_h[r]);
        }
      }
    }
    __syncthreads();  // every y row has read the entering state
    {
      // h_out = e^{total} h_in + sum_j (dt_j e^{total - cum_j} x_j) B_j^T;
      // each thread owns NT state entries of one column p.
      constexpr int NT = N / (kThreads / P);
      const int p = tid % P;
      const int n0 = (tid / P) * NT;
      const float decay = expf(total);
      float st[NT];
#pragma unroll
      for (int k = 0; k < NT; ++k) st[k] = hs[(n0 + k) * P + p] * decay;
      for (int j = 0; j < qv; ++j) {
        const float xv = to_float(xs[j * P + p]) * sdec[j];
#pragma unroll
        for (int k = 0; k < NT; k += 4) {
          const float4 bv = load4(bs + j * LDB + n0 + k);
          st[k] += xv * bv.x;
          st[k + 1] += xv * bv.y;
          st[k + 2] += xv * bv.z;
          st[k + 3] += xv * bv.w;
        }
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) hs[(n0 + k) * P + p] = st[k];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads)
    h_out[state_base + idx] = hs[(idx % N) * P + idx / N];
}

struct Args {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* h0;
  void* y;
  void* h_out;
  long long sBb, sBs, sCb, sCs;
  int B, S, H;
};

template <typename T, int P, int N, int Q>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, P, N, Q>::bytes;
  auto kernel = ssd_kernel<T, P, N, Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.H, a.B), kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm), static_cast<const T*>(a.Cm),
      static_cast<const float*>(a.h0), static_cast<T*>(a.y), static_cast<float*>(a.h_out),
      a.sBb, a.sBs, a.sCb, a.sCs, a.S, a.H);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int by_chunk(const Args& a, int Q, cudaStream_t st) {
  switch (Q) {
    case 32: return launch<T, P, N, 32>(a, st);
    case 64: return launch<T, P, N, 64>(a, st);
    case 128: return launch<T, P, N, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int P>
int by_state(const Args& a, int N, int Q, cudaStream_t st) {
  switch (N) {
    case 32: return by_chunk<T, P, 32>(a, Q, st);
    case 64: return by_chunk<T, P, 64>(a, Q, st);
    case 128: return by_chunk<T, P, 128>(a, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const Args& a, int P, int N, int Q, void* stream) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32: return by_state<T, 32>(a, N, Q, st);
    case 64: return by_state<T, 64>(a, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H) float32, A (H,) float32, h0 (B, H, P, N)
// float32 or null (zeros), y (B, S, H, P), h_out (B, H, P, N) float32, all
// contiguous; Bm and Cm (B, S, N) with element strides (sBb, sBs) and
// (sCb, sCs) and unit stride along N.  x, Bm, Cm and y share the type.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* h_out, long long sBb,
                            long long sBs, long long sCb, long long sCs, int B, int S, int H,
                            int P, int N, int Q, void* stream) {
  const Args a{x, dt, A, Bm, Cm, h0, y, h_out, sBb, sBs, sCb, sCs, B, S, H};
  return dispatch<float>(a, P, N, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* h0, void* y, void* h_out, long long sBb,
                             long long sBs, long long sCb, long long sCs, int B, int S, int H,
                             int P, int N, int Q, void* stream) {
  const Args a{x, dt, A, Bm, Cm, h0, y, h_out, sBb, sBs, sCb, sCs, B, S, H};
  return dispatch<__nv_bfloat16>(a, P, N, Q, stream);
}
