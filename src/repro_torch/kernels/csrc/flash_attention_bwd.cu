// The backward of causal flash attention (GQA, sliding window, logit
// softcap), for Hopper (sm_90a), behind a plain C interface loaded with
// ctypes.
//
// Replaces no Pallas kernel: the TPU package has no backward kernel (no
// custom_vjp under src/repro/kernels/), and its training step takes
// jax.grad of src/repro/models/attention.py:75 attention_train, whose
// blocked loop the Pallas kernel src/repro/kernels/attention.py:75
// computes.  This is that gradient, written for the card: given q, k, v,
// the forward's output o and its row logsumexp lse (natural log, float32
// (B, H, S), written by flash_attention.cu), and dO, it returns dq, dk, dv
// in the input type:
//
//   x = scale q_i . k_j;  s = cap tanh(x / cap) (no cap: s = x);
//   masked (j > i, or j <= i - window) s = -2e38, so p = 0 exactly;
//   p = exp(s - lse_i);  dP = dO_i . v_j;  D_i = dO_i . o_i;
//   dS = p (dP - D_i) (1 - tanh^2 under a cap);
//   dv_j = sum_i p dO_i;  dk_j = scale sum_i dS q_i;  dq_i = scale sum_j dS k_j,
//
// with GQA's dk and dv summed over the H / KV query heads of a group.
//
// Bound on an H100 SXM at internlm2-1.8b's training shape (B=2, S=4096,
// H=16, KV=8, D=128, causal): five products of about S^2 D operations a
// (b, h) under the causal mask, 3.44e11 operations, 0.347 ms at 989
// TFLOP/s of bf16 tensor cores, against some 100 MB of q, k, v, o, dO,
// lse, dq, dk and dv (0.03 ms at 3.35 TB/s): compute-bound.
//
// This first version is SIMT with float32 arithmetic for both input types
// (float32 FMAs on tiles held as float32 in shared memory), so the two
// types share one code path and the bf16 result is the float32 result
// rounded once.  It recomputes the scores in both passes (seven products,
// not five) and has no atomics, so it is deterministic.  Three passes:
//
// 1. dot: D_i = rowsum(dO o) in float32, a warp a (b, i, h) row.
// 2. dkdv: one CTA of 256 threads per (key block, KV head, b).  It keeps
//    its K and V tiles in shared memory and dk, dv in registers, and walks
//    the H / KV query heads of its group and, for each, only the query
//    blocks that can see its keys (`q_ranges[kb]`): per block, S =
//    q k^T and dP = dO v^T (each thread a 4 x 4, or 2 x 2, corner of the
//    score tile), p and dS into shared memory, then dv += p^T dO and
//    dk += dS^T q (each thread a few key rows by float4 column chunks).
// 3. dq: one CTA per (query block, H, b), heaviest (latest) blocks first,
//    over the key blocks it can see (`k_ranges[qb]`), dS stored
//    transposed so that dq += dS k reads it the same way.
//
// Tiles: BQ = BK = 64 rows at D = 64 and 128, 32 at D = 256; rows are
// padded to D + 4 floats, so lanes reading one column of 8 consecutive
// rows as float4 hit distinct banks.  Each kernel is built for as many
// CTAs an SM as their tiles leave shared memory for (Tiles<D>::kCtas: two
// at D = 64, one above): without that bound ptxas caps dq at D = 256 to
// 80 registers, for occupancy it cannot have, and spills.  The visible block ranges are not
// computed here: the caller (kernels/attention.py `_bwd_ranges`, whose
// CPU tests hold them to the mask by brute force) passes them in for the
// tiles it names, and a launch whose tiles are not these is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads over each tile
constexpr int kPadRow = 4;     // floats of padding a q/k/v/dO row

template <int D>
struct Tiles {
  static constexpr int BQ = D == 256 ? 32 : 64;  // query rows a tile
  static constexpr int BK = D == 256 ? 32 : 64;  // key rows a tile
  static constexpr int LD = D + kPadRow;         // row stride of q, k, v, dO tiles
  static constexpr int LDP = BK + 16;            // row stride of p, dS ([i][j])
  static constexpr int LDT = BQ + 2;             // row stride of dS^T ([j][i])
  static constexpr int RA = BQ / 16;             // score rows a thread
  static constexpr int RC = BK / 16;             // score columns a thread
  static constexpr int RN = D / 64;              // float4 column chunks a thread
  static constexpr int kCtas = D == 64 ? 2 : 1;   // CTAs an SM the shared memory holds
  static constexpr size_t kDkdvSmem =
      sizeof(float) * ((2 * BK + 2 * BQ) * LD + 2 * BQ * LDP + 2 * BQ);
  static constexpr size_t kDqSmem =
      sizeof(float) * ((2 * BQ + 2 * BK) * LD + BK * LDT + 2 * BQ);
};

// `rows` rows of D elements, `stride` elements apart from `src`, widened to
// float into a tile with rows D + kPadRow apart; rows at or past `valid`
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t stride, int rows,
                                          int valid) {
  constexpr int kUnits = D / 4;
  for (int idx = threadIdx.x; idx < rows * kUnits; idx += kThreads) {
    const int r = idx / kUnits, c = (idx % kUnits) * 4;
    const float4 x =
        r < valid ? attn::load4(src + r * stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (D + kPadRow) + c) = x;
  }
}

// acc[a][c] = sum_d X[row a] . Y[col c], rows tr + 16 a of X and tc + 16 c
// of Y, both tiles of D-float rows LD apart.
template <int RA, int RC, int D>
__device__ __forceinline__ void nt(float (&acc)[RA][RC], const float* X, const float* Y, int tr,
                                   int tc) {
  constexpr int LD = D + kPadRow;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 y[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c)
      y[c] = *reinterpret_cast<const float4*>(Y + (tc + 16 * c) * LD + d);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float4 x = *reinterpret_cast<const float4*>(X + (tr + 16 * a) * LD + d);
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[a][c] += attn::dot4(x, y[c]);
    }
  }
}

// acc[a][e][0..3] += sum_i A[i][tm + 16 a] B[i][4 tn + 64 e + 0..3] over K
// rows i: A's rows lda floats apart, B a tile of D-float rows LD apart.
template <int RM, int RN, int K, int D>
__device__ __forceinline__ void tn(float (&acc)[RM][RN][4], const float* A, int lda,
                                   const float* B, int tm, int tnn) {
  constexpr int LD = D + kPadRow;
#pragma unroll 4
  for (int i = 0; i < K; ++i) {
    float av[RM];
#pragma unroll
    for (int a = 0; a < RM; ++a) av[a] = A[i * lda + tm + 16 * a];
#pragma unroll
    for (int e = 0; e < RN; ++e) {
      const float4 bv = *reinterpret_cast<const float4*>(B + i * LD + 4 * tnn + 64 * e);
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        acc[a][e][0] += av[a] * bv.x;
        acc[a][e][1] += av[a] * bv.y;
        acc[a][e][2] += av[a] * bv.z;
        acc[a][e][3] += av[a] * bv.w;
      }
    }
  }
}

// p and dS of score (i, j) from its q.k and dO.v sums.
__device__ __forceinline__ void p_and_ds(float qk, float dov, int i, int j, int S, float lse,
                                         float delta, float scale, float softcap, int window,
                                         float& p, float& ds) {
  float x = qk * scale, th = 0.f;
  if (softcap > 0.f) {
    th = tanhf(x / softcap);
    x = softcap * th;
  }
  const bool ok = i < S && j < S && j <= i && (window <= 0 || j > i - window);
  p = expf((ok ? x : attn::kNegInf) - lse);  // exactly 0 where masked
  ds = p * (dov - delta);
  if (softcap > 0.f) ds *= 1.f - th * th;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                  int B, int S, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= static_cast<long long>(B) * S * H) return;
  const T* o_row = o + row * D;
  const T* d_row = dout + row * D;
  float sum = 0.f;
  for (int c = 4 * lane; c < D; c += 128)
    sum += attn::dot4(attn::load4(o_row + c), attn::load4(d_row + c));
  sum = attn::warp_sum(sum);
  if (lane == 0) {  // row = (b S + i) H + h  ->  delta[(b H + h) S + i]
    const long long h = row % H, bi = row / H, i = bi % S, b = bi / S;
    delta[(b * H + h) * S + i] = sum;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kCtas)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int2* __restrict__ q_ranges,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, float scale,
                   float softcap, int window) {
  using C = Tiles<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* Ls = dSs + BQ * LDP;
  float* Dl = Ls + BQ;

  const int kb = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * BK, rep = H / KV;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off =
      (static_cast<size_t>(b) * S + k0) * kv_stride + static_cast<size_t>(g) * D;
  load_rows<T, D>(Ks, k + kv_off, kv_stride, BK, S - k0);
  load_rows<T, D>(Vs, v + kv_off, kv_stride, BK, S - k0);

  float dk_acc[C::RC][C::RN][4], dv_acc[C::RC][C::RN][4];
#pragma unroll
  for (int a = 0; a < C::RC; ++a)
#pragma unroll
    for (int e = 0; e < C::RN; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) dk_acc[a][e][x] = dv_acc[a][e][x] = 0.f;

  const int2 qbs = q_ranges[kb];  // the query blocks [x, y) that see this key block
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qb = qbs.x; qb < qbs.y; ++qb) {
      const int i0 = qb * BQ;
      __syncthreads();  // every thread is done with the previous block's tiles
      const size_t q_off =
          (static_cast<size_t>(b) * S + i0) * q_stride + static_cast<size_t>(h) * D;
      load_rows<T, D>(Qs, q + q_off, q_stride, BQ, S - i0);
      load_rows<T, D>(dOs, dout + q_off, q_stride, BQ, S - i0);
      for (int t = threadIdx.x; t < BQ; t += kThreads) {
        const bool in = i0 + t < S;
        Ls[t] = in ? lse_h[i0 + t] : 0.f;
        Dl[t] = in ? delta_h[i0 + t] : 0.f;
      }
      __syncthreads();

      float s[C::RA][C::RC], dp[C::RA][C::RC];
      nt<C::RA, C::RC, D>(s, Qs, Ks, tr, tc);
      nt<C::RA, C::RC, D>(dp, dOs, Vs, tr, tc);
#pragma unroll
      for (int a = 0; a < C::RA; ++a)
#pragma unroll
        for (int c = 0; c < C::RC; ++c) {
          const int row = tr + 16 * a, col = tc + 16 * c;
          float p, ds;
          p_and_ds(s[a][c], dp[a][c], i0 + row, k0 + col, S, Ls[row], Dl[row], scale, softcap,
                   window, p, ds);
          Ps[row * LDP + col] = p;
          dSs[row * LDP + col] = ds;
        }
      __syncthreads();
      tn<C::RC, C::RN, BQ, D>(dv_acc, Ps, LDP, dOs, tr, tc);
      tn<C::RC, C::RN, BQ, D>(dk_acc, dSs, LDP, Qs, tr, tc);
    }
  }

#pragma unroll
  for (int a = 0; a < C::RC; ++a) {
    const int j = k0 + tr + 16 * a;
    if (j >= S) continue;
    const size_t off = (static_cast<size_t>(b) * S + j) * kv_stride + static_cast<size_t>(g) * D;
#pragma unroll
    for (int e = 0; e < C::RN; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 4 * tc + 64 * e + x;
        attn::store(dk + off + col, dk_acc[a][e][x] * scale);
        attn::store(dv + off + col, dv_acc[a][e][x]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kCtas)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int2* __restrict__ k_ranges,
                 T* __restrict__ dq, int S, int H, int KV, float scale, float softcap,
                 int window) {
  using C = Tiles<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDT = C::LDT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSt = Vs + BK * LD;
  float* Ls = dSt + BK * LDT;
  float* Dl = Ls + BQ;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV), i0 = qb * BQ;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * S + i0) * q_stride + static_cast<size_t>(h) * D;
  load_rows<T, D>(Qs, q + q_off, q_stride, BQ, S - i0);
  load_rows<T, D>(dOs, dout + q_off, q_stride, BQ, S - i0);
  const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * S;
  for (int t = threadIdx.x; t < BQ; t += kThreads) {
    const bool in = i0 + t < S;
    Ls[t] = in ? lse_h[i0 + t] : 0.f;
    Dl[t] = in ? delta_h[i0 + t] : 0.f;
  }

  float dq_acc[C::RA][C::RN][4];
#pragma unroll
  for (int a = 0; a < C::RA; ++a)
#pragma unroll
    for (int e = 0; e < C::RN; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) dq_acc[a][e][x] = 0.f;

  const int2 kbs = k_ranges[qb];  // the key blocks [x, y) this query block sees
  for (int kb = kbs.x; kb < kbs.y; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every thread is done with the previous key block
    const size_t kv_off =
        (static_cast<size_t>(b) * S + k0) * kv_stride + static_cast<size_t>(g) * D;
    load_rows<T, D>(Ks, k + kv_off, kv_stride, BK, S - k0);
    load_rows<T, D>(Vs, v + kv_off, kv_stride, BK, S - k0);
    __syncthreads();

    float s[C::RA][C::RC], dp[C::RA][C::RC];
    nt<C::RA, C::RC, D>(s, Qs, Ks, tr, tc);
    nt<C::RA, C::RC, D>(dp, dOs, Vs, tr, tc);
#pragma unroll
    for (int a = 0; a < C::RA; ++a)
#pragma unroll
      for (int c = 0; c < C::RC; ++c) {
        const int row = tr + 16 * a, col = tc + 16 * c;
        float p, ds;
        p_and_ds(s[a][c], dp[a][c], i0 + row, k0 + col, S, Ls[row], Dl[row], scale, softcap,
                 window, p, ds);
        dSt[col * LDT + row] = ds;
      }
    __syncthreads();
    tn<C::RA, C::RN, BK, D>(dq_acc, dSt, LDT, Ks, tr, tc);
  }

#pragma unroll
  for (int a = 0; a < C::RA; ++a) {
    const int i = i0 + tr + 16 * a;
    if (i >= S) continue;
    const size_t off = (static_cast<size_t>(b) * S + i) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int e = 0; e < C::RN; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        attn::store(dq + off + 4 * tc + 64 * e + x, dq_acc[a][e][x] * scale);
  }
}

bool bad_shape(int B, int S, int H, int KV) { return B < 1 || S < 1 || KV < 1 || H % KV != 0; }

template <typename T, int D>
int launch_dot(const void* o, const void* dout, float* delta, int B, int S, int H,
               cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S * H;
  const long long ctas = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_dot<T, D><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, S, H);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, const int* q_ranges, void* dk, void* dv, int B, int S, int H,
                int KV, int bq, int bk, float scale, float softcap, int window, cudaStream_t st) {
  using C = Tiles<D>;
  if (bq != C::BQ || bk != C::BK) return (int)cudaErrorInvalidValue;  // ranges for other tiles
  auto kernel = flash_bwd_dkdv<T, D>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)C::kDkdvSmem);
  if (rc != 0) return rc;
  const dim3 grid((S + C::BK - 1) / C::BK, KV, B);
  kernel<<<grid, kThreads, C::kDkdvSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, reinterpret_cast<const int2*>(q_ranges),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* k_ranges, void* dq, int B, int S, int H, int KV,
              int bq, int bk, float scale, float softcap, int window, cudaStream_t st) {
  using C = Tiles<D>;
  if (bq != C::BQ || bk != C::BK) return (int)cudaErrorInvalidValue;  // ranges for other tiles
  auto kernel = flash_bwd_dq<T, D>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)C::kDqSmem);
  if (rc != 0) return rc;
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, kThreads, C::kDqSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, reinterpret_cast<const int2*>(k_ranges),
      static_cast<T*>(dq), S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dot(const void* o, const void* dout, float* delta, int B, int S, int H, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dot<T, 64>(o, dout, delta, B, S, H, st);
    case 128: return launch_dot<T, 128>(o, dout, delta, B, S, H, st);
    case 256: return launch_dot<T, 256>(o, dout, delta, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
         const float* delta, const int* q_ranges, void* dk, void* dv, int B, int S, int H, int KV,
         int D, int bq, int bk, float scale, float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, bq, bk,
                                scale, softcap, window, st);
    case 128:
      return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, bq, bk,
                                 scale, softcap, window, st);
    case 256:
      return launch_dkdv<T, 256>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, bq, bk,
                                 scale, softcap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, const int* k_ranges, void* dq_, int B, int S, int H, int KV, int D,
       int bq, int bk, float scale, float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, bq, bk,
                              scale, softcap, window, st);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, bq, bk,
                               scale, softcap, window, st);
    case 256:
      return launch_dq<T, 256>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, bq, bk,
                               scale, softcap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The three passes, each a launch on `stream`: o and dO (B, S, H, D), q
// (B, S, H, D), k and v (B, S, KV, D), dq, dk, dv like q, k, v; lse and
// delta float32 (B, H, S); all contiguous and 16-byte aligned; D in {64,
// 128, 256}.  softcap <= 0 means none, window <= 0 means none.
// q_ranges holds, for each of the ceil(S / bk) key blocks, the query
// blocks [first, end) that see it; k_ranges, for each of the ceil(S / bq)
// query blocks, the key blocks [first, end) it sees (int32 pairs on the
// card), both for tiles of bq query rows and bk keys, which must be the
// kernel's own at D.  Each returns the CUDA error code of its launch (0 on
// success; cudaErrorInvalidValue for a shape or tiles it does not take).
// `*_f32` take float32 tensors, `*_bf16` bfloat16 ones; both compute in
// float32.
extern "C" int flash_bwd_dot_f32(const void* o, const void* dout, float* delta, int B, int S,
                                 int H, int D, void* stream) {
  return dot<float>(o, dout, delta, B, S, H, D, stream);
}
extern "C" int flash_bwd_dot_bf16(const void* o, const void* dout, float* delta, int B, int S,
                                  int H, int D, void* stream) {
  return dot<__nv_bfloat16>(o, dout, delta, B, S, H, D, stream);
}
extern "C" int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, const int* q_ranges,
                                  void* dk, void* dv, int B, int S, int H, int KV, int D, int bq,
                                  int bk, float scale, float softcap, int window, void* stream) {
  return dkdv<float>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, D, bq, bk, scale,
                     softcap, window, stream);
}
extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* q_ranges,
                                   void* dk, void* dv, int B, int S, int H, int KV, int D, int bq,
                                   int bk, float scale, float softcap, int window, void* stream) {
  return dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, D, bq, bk,
                             scale, softcap, window, stream);
}
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* k_ranges,
                                void* dq_, int B, int S, int H, int KV, int D, int bq, int bk,
                                float scale, float softcap, int window, void* stream) {
  return dq<float>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, D, bq, bk, scale,
                   softcap, window, stream);
}
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* k_ranges,
                                 void* dq_, int B, int S, int H, int KV, int D, int bq, int bk,
                                 float scale, float softcap, int window, void* stream) {
  return dq<__nv_bfloat16>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, D, bq, bk,
                           scale, softcap, window, stream);
}
