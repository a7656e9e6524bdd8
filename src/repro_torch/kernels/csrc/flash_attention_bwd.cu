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
// lse, dq, dk and dv (0.03 ms at 3.35 TB/s): compute-bound, so only the
// tensor cores come near it.
//
// Three passes, no atomics (deterministic), the same in both variants:
//
// 1. dot: D_i = rowsum(dO o) in float32, a warp a (b, i, h) row.
// 2. dkdv: one CTA per (key block, KV head, b) keeps its K and V tiles and
//    sums dk, dv over the H / KV query heads of its group and, for each,
//    only the query blocks that can see its keys (`q_ranges[kb]`).
// 3. dq: one CTA per (query block, head, b), heaviest (latest) blocks
//    first, over the key blocks it can see (`k_ranges[qb]`).
//
// The visible block ranges are not computed here: the caller
// (kernels/attention.py `_bwd_ranges`, whose CPU tests hold them to the
// mask by brute force) passes them in for the tiles it names, and a launch
// whose tiles are not the variant's own (`Tiles<D>`) is refused.  Both
// variants recompute the scores in both passes (seven products where five
// would do; fusing dq into dkdv needs atomics).  Two variants, picked by
// dtype alone (attention.py `_variant`):
//
// 1. wgmma (bf16; D = 64, 128, 256): two warpgroups of 128 threads a CTA;
//    thread 0 issues every load by TMA (3-D tensor maps (H*D, S, B) and
//    (KV*D, S, B), boxes of 64 columns with 128-byte swizzle, rows past S
//    zero-filled) through a ring of stages with full and empty mbarriers,
//    as flash_attention.cu does.  Tiles (query rows x keys): dkdv 64 x 128
//    and dq 128 x 64 at D = 64 and 128, so that each warpgroup owns 64 of
//    the rows it sums into; both 64 x 64 at D = 256.
//    - dkdv keeps K and V resident and streams q and dO blocks (4 stages
//      below D = 256, 2 at it).  Each warpgroup owns 64 keys: S^T = K q^T
//      and dP^T = V dO^T by wgmma m64n64 with both operands K-major in
//      shared memory; p^T and dS^T on the float32 accumulator fragments
//      (scale, accurate tanhf under the cap, the mask only on diagonal,
//      window-edge or ragged tiles, exp2 of s - lse in base 2); then dv +=
//      p^T dO and dk += dS^T q by wgmma with A in registers (the
//      accumulator-to-A fragment identity of hopper_common.cuh) and dO, q
//      the MN-major B operands.
//    - dq keeps q and dO resident and streams K and V blocks (4 stages
//      below D = 256, 2 at it).  Each warpgroup owns 64 of the block's 128
//      queries against all 64 keys of each K, V block (S = q K^T, dP = dO
//      V^T, dq += dS K with K as MN-major B), as in the forward.
//    - A warpgroup whose 64 rows see none of the tile's pairs skips it.
//    - p and dS are split into bf16 hi and lo, and each product by them is
//      two wgmma: one bf16 rounding of p or dS leaves a few hundred
//      elements a gradient outside the card tolerance (one bf16 ulp plus
//      1e-4 of the largest |grad|; tests/test_torch_attention_grad.py
//      emulates both), the split none.
//    - D = 256: dk and dv for 64 keys would take 256 float32 registers a
//      thread.  So both warpgroups take the block's 64 keys (queries, in
//      dq) and a 128-column half of dk and dv (dq) each; each computes the
//      scores for 32 of the 64 queries (keys, in dq) by wgmma m64n32,
//      writes its p and dS hi and lo into 128-byte-swizzled exchange tiles
//      (32 KB; dq's 16 KB), and both read all 64 from there as K-major A
//      operands.  Shared memory: K + V 64 KB, 2 stages of q + dO 128 KB,
//      exchange 32 KB: 225 KB of the 227.
//    - Every mbarrier wait traps after about 2^30 polls: a lost arrival or
//      a wrong byte count fails the launch instead of hanging the card.
// 2. simt (float32): float32 FMAs on tiles held in shared memory (TF32
//    would break the float32 limit).  dkdv: per block, S = q k^T and dP =
//    dO v^T (each thread a 4 x 4, or 2 x 2, corner of the score tile), p
//    and dS into shared memory, then dv += p^T dO and dk += dS^T q (each
//    thread a few key rows by float4 column chunks).  dq stores dS
//    transposed so that dq += dS k reads it the same way.  Tiles: BQ = BK
//    = 64 rows at D = 64 and 128, 32 at D = 256; rows are padded to D + 4
//    floats, so lanes reading one column of 8 consecutive rows as float4
//    hit distinct banks.  Each kernel is built for as many CTAs an SM as
//    their tiles leave shared memory for (Tiles<D>::kCtas: two at D = 64,
//    one above): without that bound ptxas caps dq at D = 256 to 80
//    registers, for occupancy it cannot have, and spills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

bool bad_shape(int B, int S, int H, int KV) { return B < 1 || S < 1 || KV < 1 || H % KV != 0; }

// ---------------------------------------------------------------- dot

constexpr int kDotThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kDotThreads)
    flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                  int B, int S, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (kDotThreads / 32) + warp;
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
int launch_dot(const void* o, const void* dout, float* delta, int B, int S, int H,
               cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S * H;
  const long long ctas = (rows + kDotThreads / 32 - 1) / (kDotThreads / 32);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_dot<T, D><<<static_cast<unsigned>(ctas), kDotThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, S, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- simt

namespace simt {


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

// `rows` rows of D floats, `stride` floats apart from `src`, into a tile
// with rows D + kPadRow apart; rows at or past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t stride, int rows,
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

template <int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kCtas)
    flash_bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int2* __restrict__ q_ranges, float* __restrict__ dk,
                        float* __restrict__ dv, int S, int H, int KV, float scale, float softcap,
                        int window) {
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
  load_rows<D>(Ks, k + kv_off, kv_stride, BK, S - k0);
  load_rows<D>(Vs, v + kv_off, kv_stride, BK, S - k0);

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
      load_rows<D>(Qs, q + q_off, q_stride, BQ, S - i0);
      load_rows<D>(dOs, dout + q_off, q_stride, BQ, S - i0);
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
        dk[off + col] = dk_acc[a][e][x] * scale;
        dv[off + col] = dv_acc[a][e][x];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kCtas)
    flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int2* __restrict__ k_ranges, float* __restrict__ dq, int S, int H,
                      int KV, float scale, float softcap, int window) {
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
  load_rows<D>(Qs, q + q_off, q_stride, BQ, S - i0);
  load_rows<D>(dOs, dout + q_off, q_stride, BQ, S - i0);
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
    load_rows<D>(Ks, k + kv_off, kv_stride, BK, S - k0);
    load_rows<D>(Vs, v + kv_off, kv_stride, BK, S - k0);
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
        dq[off + 4 * tc + 64 * e + x] = dq_acc[a][e][x] * scale;
  }
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, const int* q_ranges, void* dk, void* dv, int B, int S, int H,
                int KV, int bq, int bk, float scale, float softcap, int window, cudaStream_t st) {
  using C = Tiles<D>;
  if (bq != C::BQ || bk != C::BK) return (int)cudaErrorInvalidValue;  // ranges for other tiles
  auto kernel = flash_bwd_dkdv_simt<D>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)C::kDkdvSmem);
  if (rc != 0) return rc;
  const dim3 grid((S + C::BK - 1) / C::BK, KV, B);
  kernel<<<grid, kThreads, C::kDkdvSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, reinterpret_cast<const int2*>(q_ranges),
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* k_ranges, void* dq, int B, int S, int H, int KV,
              int bq, int bk, float scale, float softcap, int window, cudaStream_t st) {
  using C = Tiles<D>;
  if (bq != C::BQ || bk != C::BK) return (int)cudaErrorInvalidValue;  // ranges for other tiles
  auto kernel = flash_bwd_dq_simt<D>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)C::kDqSmem);
  if (rc != 0) return rc;
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, kThreads, C::kDqSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, reinterpret_cast<const int2*>(k_ranges),
      static_cast<float*>(dq), S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- wgmma

namespace wg {

constexpr int kThreads = 256;  // two warpgroups; thread 0 also issues every TMA load
constexpr int kWarps = kThreads / 32;
__device__ constexpr float kLog2e = 1.4426950408889634f;

// Bytes of a pass's 64-column (128-byte) TMA boxes of RQ q (or dO) rows
// and RK k (or v) rows, and of their tiles of D columns.
template <int D, int RQ, int RK>
struct Boxes {
  static constexpr int kQBox = RQ * 128, kKBox = RK * 128;
  static constexpr int kQBytes = D / 64 * kQBox, kKBytes = D / 64 * kKBox;
};

template <int D>
struct Tiles {
  static constexpr int BQ = 64;                        // dkdv: query rows a tile
  static constexpr int BK = D == 256 ? 64 : 128;       // dkdv: key rows a tile
  static constexpr int DQ_BQ = D == 256 ? 64 : 128;    // dq: query rows a tile
  static constexpr int DQ_BK = 64;                     // dq: key rows a tile
  using Dkdv = Boxes<D, BQ, BK>;
  using Dq = Boxes<D, DQ_BQ, DQ_BK>;
  // D = 256: both warpgroups take the same keys (dkdv) or queries (dq), a
  // half of the score tile's columns and a 128-column half of the
  // accumulated gradient each, and swap p and dS through shared memory.
  static constexpr bool kSplit = D == 256;
  static constexpr int kSN = kSplit ? 32 : 64;         // score columns a warpgroup
  static constexpr int kNA = kSplit ? 64 : D / 2;      // floats a thread of dk, dv or dq
  static constexpr int kBoxes = D / 64;                // 64-column (128-byte) boxes a row
  static constexpr int kXch = 64 * 128;                // a 64 x 64 bf16 exchange tile
  static constexpr int kDkdvStages = D == 256 ? 2 : 4;  // q/dO stages of dkdv's ring
  static constexpr int kDqStages = D == 256 ? 2 : 4;    // k/v stages of dq's ring
  static constexpr int kDkdvSmem = 2 * Dkdv::kKBytes + kDkdvStages * 2 * Dkdv::kQBytes +
                                   (kSplit ? 4 * kXch : 0) + 1024;
  static constexpr int kDqSmem =
      2 * Dq::kQBytes + kDqStages * 2 * Dq::kKBytes + (kSplit ? 2 * kXch : 0) + 1024;
};

__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n32k16_ss_kmaj(d, a, b, acc);
}
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n64k16_ss_kmaj(d, a, b, acc);
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n64k16_rs_mnmaj(d, a, b);
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n128k16_rs_mnmaj(d, a, b);
}

// The element (row, col) of a 64-row, 128-byte-swizzled bf16 tile whose
// rows hold 64 columns (a TMA box's layout): the 16-byte chunk col / 8 of
// row `row` sits at chunk (col / 8) ^ (row % 8).
__device__ __forceinline__ uint32_t* swizzled(uint8_t* tile, int row, int col) {
  return reinterpret_cast<uint32_t*>(tile + row * 128 + ((((col >> 3) ^ row) & 7) << 4) +
                                     (col & 7) * 2);
}

// A (query, key) pair the mask lets through.
__device__ __forceinline__ bool visible(int i, int j, int S, int window) {
  return j <= i && i < S && (window <= 0 || j > i - window);
}

// p and dS of one score from its q.k and dO.v sums, in place: base-2 lse,
// delta = D_i.
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float delta, float scale,
                                     float softcap, float inv_cap, bool ok) {
  const float x = s * scale;
  float th = 0.f, s2;
  if (softcap > 0.f) {
    th = tanhf(x * inv_cap);
    s2 = softcap * th * kLog2e;
  } else {
    s2 = x * kLog2e;
  }
  const float p = ok ? exp2f(s2 - lse2) : 0.f;  // exactly 0 where masked
  float ds = p * (dp - delta);
  if (softcap > 0.f) ds *= 1.f - th * th;
  s = p;
  dp = ds;
}

// The keys [kw0, kw0 + 63] and the queries [iq0, iq0 + n - 1] hold a pair the
// mask lets through.
__device__ __forceinline__ bool any_visible(int kw0, int iq0, int n, int S, int window) {
  const int i_last = min(iq0 + n, S) - 1, j_last = min(kw0 + 63, S - 1);
  return kw0 < S && i_last >= kw0 && (window <= 0 || iq0 - j_last < window);
}

// Some pair of the keys [kw0, kw0 + nk - 1] and queries [iq0, iq0 + nq - 1]
// is masked (diagonal, window edge, or past S): only these tiles test each
// element.
__device__ __forceinline__ bool on_edge(int kw0, int nk, int iq0, int nq, int S, int window) {
  return kw0 + nk - 1 > iq0 || iq0 + nq > S || kw0 + nk > S ||
         (window > 0 && iq0 + nq - 1 - kw0 >= window);
}

// dk and dv of one key block: one CTA per (key block, KV head, b), key
// blocks in order (block 0 is seen by the most queries), each over every
// (KV head, b).  K and V stay in shared memory; q and dO blocks of each
// query head of the group stream through the ring, only those that see
// the key block (`q_ranges`).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int2* __restrict__ q_ranges,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                         int H, int KV, float scale, float softcap, int window) {
  using namespace hopper;
  using T = Tiles<D>;
  using P = typename T::Dkdv;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::kDkdvStages, SN = T::kSN, NA = T::kNA;
  constexpr bool kSplit = T::kSplit;
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t smem_tiles[];
  // Swizzle atoms must start 1024-byte aligned in the shared window.
  uint8_t* smem = smem_tiles + ((1024u - (smem_addr(smem_tiles) & 1023u)) & 1023u);
  uint8_t* ks = smem;
  uint8_t* vs = ks + P::kKBytes;
  uint8_t* ring = vs + P::kKBytes;
  uint8_t* xch = ring + STAGES * 2 * P::kQBytes;  // D = 256: p hi, p lo, dS hi, dS lo

  const int n_kb = (S + BK - 1) / BK;
  const int heads = gridDim.x / n_kb;  // KV * B
  const int kb = static_cast<int>(blockIdx.x) / heads;
  const int g = blockIdx.x % heads % KV, b = blockIdx.x % heads / KV;
  const int k0 = kb * BK, rep = H / KV;
  const int2 qbs = q_ranges[kb];  // the query blocks [x, y) that see this key block
  const int nq = max(qbs.y - qbs.x, 0);
  const int n_iter = rep * nq;  // (query head, query block) pairs, head outer
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wgi = warp / 4;

  // Thread 0 loads q and dO block i into stage i % STAGES once the 8 warps
  // have released the block that stage held before.
  auto load_stage = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    uint8_t* stage = ring + s * 2 * P::kQBytes;
    const int h = g * rep + i / nq, i0 = (qbs.x + i % nq) * BQ;
    mbar_arrive_expect_tx(&full[s], 2 * P::kQBytes);
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(stage + j * P::kQBox, &qmap, &full[s], h * D + 64 * j, i0, b);
      tma_load_3d(stage + P::kQBytes + j * P::kQBox, &domap, &full[s], h * D + 64 * j, i0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);        // thread 0's arrive.expect_tx
      mbar_init(&empty[s], kWarps);  // one arrival per warp
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&kv_full, 2 * P::kKBytes);
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(ks + j * P::kKBox, &kmap, &kv_full, g * D + 64 * j, k0, b);
      tma_load_3d(vs + j * P::kKBox, &vmap, &kv_full, g * D + 64 * j, k0, b);
    }
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_stage(i);
  }
  __syncthreads();

  // This thread's fragment rows (keys) and column pairs (queries); see
  // hopper_common.cuh.  Split: both warpgroups hold the block's 64 keys,
  // warpgroup w the queries 32 w .. 32 w + 31; else warpgroup w holds the
  // keys 64 w .. 64 w + 63 against all 64 queries.
  const int frag_row = 16 * (warp % 4) + lane / 4;  // and frag_row + 8
  const int quad = lane % 4;
  const int kw0 = kSplit ? k0 : k0 + 64 * wgi;   // this warpgroup's first key
  const int qc0 = kSplit ? 32 * wgi : 0;         // its first query column
  const uint32_t a_off = kSplit ? 0 : wgi * 64 * 128;  // its K, V rows in each box
  const uint32_t b_off = qc0 * 128;                    // its q, dO rows in each box
  const bool capped = softcap > 0.f;
  const float inv_cap = capped ? 1.f / softcap : 0.f;

  float dk_acc[NA], dv_acc[NA], st[SN / 2], dpt[SN / 2];
#pragma unroll
  for (int x = 0; x < NA; ++x) dk_acc[x] = dv_acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < SN / 2; ++x) st[x] = dpt[x] = 0.f;

  mbar_wait(&kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    if (threadIdx.x == 0 && i >= 1 && i - 1 + STAGES < n_iter) load_stage(i - 1 + STAGES);
    __syncwarp();
    const int h = g * rep + i / nq, i0 = (qbs.x + i % nq) * BQ;
    const int iq0 = i0 + qc0;
    // lse (base 2) and D of this lane's pair of query columns: the fragment's
    // column pair 4 j + quad is read from lane 4 j + quad with shuffles.
    const size_t row_bh = (static_cast<size_t>(b) * H + h) * S;
    const int qp = iq0 + 2 * (lane % (SN / 2));
    const float lse_x = qp < S ? lse[row_bh + qp] * kLog2e : 0.f;
    const float lse_y = qp + 1 < S ? lse[row_bh + qp + 1] * kLog2e : 0.f;
    const float dl_x = qp < S ? delta[row_bh + qp] : 0.f;
    const float dl_y = qp + 1 < S ? delta[row_bh + qp + 1] : 0.f;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* qst = ring + s * 2 * P::kQBytes;
    const uint8_t* dost = qst + P::kQBytes;

    if (kSplit || any_visible(kw0, iq0, SN, S, window)) {
      // S^T = K q^T and dP^T = V dO^T over D: k16 step kk reads 32 bytes
      // along the swizzled rows of box kk / 4 of both operands.
      reg_fence(st);
      reg_fence(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int jb = kk / 4, off = (kk % 4) * 32;
        mma_ss(st, smem_desc_b128(ks + jb * P::kKBox + a_off + off, 16, 1024),
               smem_desc_b128(qst + jb * P::kQBox + b_off + off, 16, 1024), kk > 0);
        mma_ss(dpt, smem_desc_b128(vs + jb * P::kKBox + a_off + off, 16, 1024),
               smem_desc_b128(dost + jb * P::kQBox + b_off + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // p and dS in place; st[4 j + 2 hh + c] is key kw0 + frag_row + 8 hh,
      // query iq0 + 8 j + 2 quad + c.
      const bool edge = on_edge(kw0, 64, iq0, SN, S, window);
#pragma unroll
      for (int j = 0; j < SN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float l2 = __shfl_sync(0xffffffffu, c ? lse_y : lse_x, 4 * j + quad);
          const float dl = __shfl_sync(0xffffffffu, c ? dl_y : dl_x, 4 * j + quad);
          const int qi = iq0 + 8 * j + 2 * quad + c;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int idx = 4 * j + 2 * hh + c;
            const bool ok = !edge || visible(qi, kw0 + frag_row + 8 * hh, S, window);
            p_ds(st[idx], dpt[idx], l2, dl, scale, softcap, inv_cap, ok);
          }
        }

      if constexpr (kSplit) {
        // Both warpgroups' p^T and dS^T, hi and lo, into the exchange tiles
        // ([key][query], K-major A operands), then dv += p^T dO and dk +=
        // dS^T q over this warpgroup's 128 columns.
        __syncthreads();  // both warpgroups are done reading the previous block's tiles
#pragma unroll
        for (int j = 0; j < SN / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int idx = 4 * j + 2 * hh, row = frag_row + 8 * hh;
            const int col = qc0 + 8 * j + 2 * quad;
            uint32_t hi, lo;
            split_bf16x2(st[idx], st[idx + 1], hi, lo);
            *swizzled(xch, row, col) = hi;
            *swizzled(xch + T::kXch, row, col) = lo;
            split_bf16x2(dpt[idx], dpt[idx + 1], hi, lo);
            *swizzled(xch + 2 * T::kXch, row, col) = hi;
            *swizzled(xch + 3 * T::kXch, row, col) = lo;
          }
        fence_proxy_async();
        __syncthreads();
        reg_fence(dk_acc);
        reg_fence(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < BQ / 16; ++t) {
          const uint64_t bdo =
              smem_desc_b128(dost + 2 * wgi * P::kQBox + t * 16 * 128, P::kQBox, 1024);
          const uint64_t bq =
              smem_desc_b128(qst + 2 * wgi * P::kQBox + t * 16 * 128, P::kQBox, 1024);
          wgmma_m64n128k16_bf16_kmaj_mnmaj(dv_acc, smem_desc_b128(xch + t * 32, 16, 1024), bdo);
          wgmma_m64n128k16_bf16_kmaj_mnmaj(
              dv_acc, smem_desc_b128(xch + T::kXch + t * 32, 16, 1024), bdo);
          wgmma_m64n128k16_bf16_kmaj_mnmaj(
              dk_acc, smem_desc_b128(xch + 2 * T::kXch + t * 32, 16, 1024), bq);
          wgmma_m64n128k16_bf16_kmaj_mnmaj(
              dk_acc, smem_desc_b128(xch + 3 * T::kXch + t * 32, 16, 1024), bq);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dk_acc);
        reg_fence(dv_acc);
      } else {
        // p^T and dS^T as hi and lo register A operands (the accumulator's
        // floats 8 t .. 8 t + 7 are k16 step t's fragment), then dv += p^T
        // dO and dk += dS^T q: k16 step t reads 16 query rows (2 KB) down
        // each 64-column box of dO and q, the D columns spanning D / 64 boxes.
        uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int idx = 8 * t + 2 * a;
            split_bf16x2(st[idx], st[idx + 1], p_hi[t][a], p_lo[t][a]);
            split_bf16x2(dpt[idx], dpt[idx + 1], ds_hi[t][a], ds_lo[t][a]);
          }
        reg_fence(dk_acc);
        reg_fence(dv_acc);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          reg_fence(p_hi[t]);
          reg_fence(p_lo[t]);
          reg_fence(ds_hi[t]);
          reg_fence(ds_lo[t]);
        }
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t bdo = smem_desc_b128(dost + t * 16 * 128, P::kQBox, 1024);
          const uint64_t bq = smem_desc_b128(qst + t * 16 * 128, P::kQBox, 1024);
          mma_rs(dv_acc, p_hi[t], bdo);
          mma_rs(dv_acc, p_lo[t], bdo);
          mma_rs(dk_acc, ds_hi[t], bq);
          mma_rs(dk_acc, ds_lo[t], bq);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dk_acc);
        reg_fence(dv_acc);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          reg_fence(p_hi[t]);
          reg_fence(p_lo[t]);
          reg_fence(ds_hi[t]);
          reg_fence(ds_lo[t]);
        }
      }
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // dk_acc[4 j + 2 hh + c] is key kw0 + frag_row + 8 hh, column col0 + 8 j
  // + 2 quad + c.
  const int col0 = kSplit ? 128 * wgi : 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw0 + frag_row + 8 * hh;
    if (key >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + key) * KV + g) * D + col0 + 2 * quad;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
    }
  }
}

// dq of one query block: one CTA per (query block, head, b), heaviest
// (latest) blocks first across every (head, b).  q and dO stay in shared
// memory; the K and V blocks it sees (`k_ranges`) stream through the ring.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int2* __restrict__ k_ranges,
                       __nv_bfloat16* __restrict__ dq, int S, int H, int KV, float scale,
                       float softcap, int window) {
  using namespace hopper;
  using T = Tiles<D>;
  using P = typename T::Dq;
  constexpr int BQ = T::DQ_BQ, BK = T::DQ_BK, STAGES = T::kDqStages, SN = T::kSN, NA = T::kNA;
  constexpr bool kSplit = T::kSplit;
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t smem_tiles[];
  uint8_t* smem = smem_tiles + ((1024u - (smem_addr(smem_tiles) & 1023u)) & 1023u);
  uint8_t* qs = smem;
  uint8_t* dos = qs + P::kQBytes;
  uint8_t* ring = dos + P::kQBytes;
  uint8_t* xch = ring + STAGES * 2 * P::kKBytes;  // D = 256: dS hi, dS lo

  const int n_qb = (S + BQ - 1) / BQ;
  const int heads = gridDim.x / n_qb;  // H * B
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = blockIdx.x % heads % H, b = blockIdx.x % heads / H;
  const int g = h / (H / KV), i0 = qb * BQ;
  const int2 kbs = k_ranges[qb];  // the key blocks [x, y) this query block sees
  const int n_iter = max(kbs.y - kbs.x, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wgi = warp / 4;

  auto load_stage = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    uint8_t* stage = ring + s * 2 * P::kKBytes;
    const int k0 = (kbs.x + i) * BK;
    mbar_arrive_expect_tx(&full[s], 2 * P::kKBytes);
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(stage + j * P::kKBox, &kmap, &full[s], g * D + 64 * j, k0, b);
      tma_load_3d(stage + P::kKBytes + j * P::kKBox, &vmap, &full[s], g * D + 64 * j, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&q_full, 2 * P::kQBytes);
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(qs + j * P::kQBox, &qmap, &q_full, h * D + 64 * j, i0, b);
      tma_load_3d(dos + j * P::kQBox, &domap, &q_full, h * D + 64 * j, i0, b);
    }
    for (int i = 0; i < min(STAGES, n_iter); ++i) load_stage(i);
  }
  __syncthreads();

  // This thread's fragment rows (queries) and column pairs (keys).  Split:
  // both warpgroups hold the block's 64 queries, warpgroup w the keys 32 w
  // .. 32 w + 31 of each key block; else warpgroup w holds the queries 64 w
  // .. 64 w + 63 against all 64 keys.
  const int frag_row = 16 * (warp % 4) + lane / 4;  // and frag_row + 8
  const int quad = lane % 4;
  const int qr0 = kSplit ? 0 : 64 * wgi;  // this warpgroup's first query row of the tile
  const int kc0 = kSplit ? 32 * wgi : 0;  // its first key column of each key block
  const int iq0 = i0 + qr0;
  const bool capped = softcap > 0.f;
  const float inv_cap = capped ? 1.f / softcap : 0.f;
  const size_t row_bh = (static_cast<size_t>(b) * H + h) * S;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = iq0 + frag_row + 8 * hh;
    lse2[hh] = i < S ? lse[row_bh + i] * kLog2e : 0.f;
    dl[hh] = i < S ? delta[row_bh + i] : 0.f;
  }

  float dq_acc[NA], sc[SN / 2], dp[SN / 2];
#pragma unroll
  for (int x = 0; x < NA; ++x) dq_acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < SN / 2; ++x) sc[x] = dp[x] = 0.f;

  mbar_wait(&q_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    if (threadIdx.x == 0 && i >= 1 && i - 1 + STAGES < n_iter) load_stage(i - 1 + STAGES);
    __syncwarp();
    const int kw0 = (kbs.x + i) * BK + kc0;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* kst = ring + s * 2 * P::kKBytes;
    const uint8_t* vst = kst + P::kKBytes;

    if (kSplit || any_visible(kw0, iq0, 64, S, window)) {
      // S = q K^T and dP = dO V^T over D for this warpgroup's 64 queries
      // and SN keys.
      reg_fence(sc);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int jb = kk / 4, off = (kk % 4) * 32;
        mma_ss(sc, smem_desc_b128(qs + jb * P::kQBox + qr0 * 128 + off, 16, 1024),
               smem_desc_b128(kst + jb * P::kKBox + kc0 * 128 + off, 16, 1024), kk > 0);
        mma_ss(dp, smem_desc_b128(dos + jb * P::kQBox + qr0 * 128 + off, 16, 1024),
               smem_desc_b128(vst + jb * P::kKBox + kc0 * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      reg_fence(dp);

      // dS in place of dP; sc[4 j + 2 hh + c] is query iq0 + frag_row + 8 hh,
      // key kw0 + 8 j + 2 quad + c.
      const bool edge = on_edge(kw0, SN, iq0, 64, S, window);
#pragma unroll
      for (int j = 0; j < SN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * hh + c;
            const bool ok = !edge || visible(iq0 + frag_row + 8 * hh, kw0 + 8 * j + 2 * quad + c,
                                             S, window);
            p_ds(sc[idx], dp[idx], lse2[hh], dl[hh], scale, softcap, inv_cap, ok);
          }

      if constexpr (kSplit) {
        // Both warpgroups' dS, hi and lo, into the exchange tiles ([query]
        // [key], K-major A operands), then dq += dS K over this
        // warpgroup's 128 columns: k16 step t reads 16 key rows down K's
        // boxes 2 w and 2 w + 1.
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SN / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int idx = 4 * j + 2 * hh;
            uint32_t hi, lo;
            split_bf16x2(dp[idx], dp[idx + 1], hi, lo);
            *swizzled(xch, frag_row + 8 * hh, kc0 + 8 * j + 2 * quad) = hi;
            *swizzled(xch + T::kXch, frag_row + 8 * hh, kc0 + 8 * j + 2 * quad) = lo;
          }
        fence_proxy_async();
        __syncthreads();
        reg_fence(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < BK / 16; ++t) {
          const uint64_t bk =
              smem_desc_b128(kst + 2 * wgi * P::kKBox + t * 16 * 128, P::kKBox, 1024);
          wgmma_m64n128k16_bf16_kmaj_mnmaj(dq_acc, smem_desc_b128(xch + t * 32, 16, 1024), bk);
          wgmma_m64n128k16_bf16_kmaj_mnmaj(
              dq_acc, smem_desc_b128(xch + T::kXch + t * 32, 16, 1024), bk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq_acc);
      } else {
        // dS as hi and lo register A operands, then dq += dS K: k16 step t
        // reads the keys 16 t .. 16 t + 15 (2 KB) down each box of K.
        uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int idx = 8 * t + 2 * a;
            split_bf16x2(dp[idx], dp[idx + 1], ds_hi[t][a], ds_lo[t][a]);
          }
        reg_fence(dq_acc);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          reg_fence(ds_hi[t]);
          reg_fence(ds_lo[t]);
        }
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t bk = smem_desc_b128(kst + 16 * t * 128, P::kKBox, 1024);
          mma_rs(dq_acc, ds_hi[t], bk);
          mma_rs(dq_acc, ds_lo[t], bk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq_acc);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          reg_fence(ds_hi[t]);
          reg_fence(ds_lo[t]);
        }
      }
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dq_acc[4 j + 2 hh + c] is query iq0 + frag_row + 8 hh, column col0 + 8 j
  // + 2 quad + c.
  const int col0 = kSplit ? 128 * wgi : 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = iq0 + frag_row + 8 * hh;
    if (i >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + i) * H + h) * D + col0 + 2 * quad;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * j) = __floats2bfloat162_rn(
          dq_acc[4 * j + 2 * hh] * scale, dq_acc[4 * j + 2 * hh + 1] * scale);
  }
}

// The tensor maps of a pass: q and dO (H*D, S, B) in boxes of 64 columns x
// `rq` rows, k and v (KV*D, S, B) in boxes of 64 columns x `rk` rows,
// 128-byte swizzle, rows past S zero-filled.
int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* dout, const void* k,
                const void* v, int B, int S, int H, int KV, int D, int rq, int rk) {
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(H) * D, static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[2] = {static_cast<cuuint64_t>(H) * D * 2,
                                  static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t qbox[3] = {64, static_cast<cuuint32_t>(rq), 1};
  const cuuint64_t kvdims[3] = {static_cast<cuuint64_t>(KV) * D, static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t kvstrides[2] = {static_cast<cuuint64_t>(KV) * D * 2,
                                   static_cast<cuuint64_t>(S) * KV * D * 2};
  const cuuint32_t kvbox[3] = {64, static_cast<cuuint32_t>(rk), 1};
  const void* bases[4] = {q, dout, k, v};
  for (int m = 0; m < 4; ++m) {
    const int rc = hopper::encode_bf16_b128(&maps[m], const_cast<void*>(bases[m]), 3,
                                            m < 2 ? qdims : kvdims, m < 2 ? qstrides : kvstrides,
                                            m < 2 ? qbox : kvbox);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace wg

template <int D>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* q_ranges, void* dk,
                      void* dv, int B, int S, int H, int KV, int bq, int bk, float scale,
                      float softcap, int window, cudaStream_t st) {
  using T = wg::Tiles<D>;
  if (bq != T::BQ || bk != T::BK) return (int)cudaErrorInvalidValue;  // ranges for other tiles
  const long long ctas = (static_cast<long long>(S) + T::BK - 1) / T::BK * KV * B;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int rc = wg::encode_maps(maps, q, dout, k, v, B, S, H, KV, D, T::BQ, T::BK);
  if (rc != 0) return rc;
  auto kernel = wg::flash_bwd_dkdv_wgmma<D>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::kDkdvSmem);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(ctas), wg::kThreads, T::kDkdvSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, reinterpret_cast<const int2*>(q_ranges),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, KV, scale,
      softcap, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, const int* k_ranges, void* dq, int B,
                    int S, int H, int KV, int bq, int bk, float scale, float softcap, int window,
                    cudaStream_t st) {
  using T = wg::Tiles<D>;
  if (bq != T::DQ_BQ || bk != T::DQ_BK) return (int)cudaErrorInvalidValue;  // other tiles
  const long long ctas = (static_cast<long long>(S) + T::DQ_BQ - 1) / T::DQ_BQ * H * B;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int rc = wg::encode_maps(maps, q, dout, k, v, B, S, H, KV, D, T::DQ_BQ, T::DQ_BK);
  if (rc != 0) return rc;
  auto kernel = wg::flash_bwd_dq_wgmma<D>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::kDqSmem);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(ctas), wg::kThreads, T::kDqSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, reinterpret_cast<const int2*>(k_ranges),
      static_cast<__nv_bfloat16*>(dq), S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

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

}  // namespace

// The three passes, each a launch on `stream`: o and dO (B, S, H, D), q
// (B, S, H, D), k and v (B, S, KV, D), dq, dk, dv like q, k, v; lse and
// delta float32 (B, H, S); all contiguous and 16-byte aligned; D in {64,
// 128, 256}.  softcap <= 0 means none, window <= 0 means none.
// q_ranges holds, for each of the ceil(S / bk) key blocks, the query
// blocks [first, end) that see it; k_ranges, for each of the ceil(S / bq)
// query blocks, the key blocks [first, end) it sees (int32 pairs on the
// card), both for tiles of bq query rows and bk keys, which must be the
// variant's own at D.  Each returns the CUDA error code of its launch (0 on
// success; cudaErrorInvalidValue for a shape or tiles it does not take).
// `*_f32` take float32 tensors (the simt variant), `*_bf16` bfloat16 ones
// (the wgmma variant); both compute in float32.
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
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define CASE(DD)                                                                             \
  case DD:                                                                                   \
    return simt::launch_dkdv<DD>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, bq, \
                                 bk, scale, softcap, window, st);
    CASE(64) CASE(128) CASE(256)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* q_ranges,
                                   void* dk, void* dv, int B, int S, int H, int KV, int D, int bq,
                                   int bk, float scale, float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define CASE(DD)                                                                                \
  case DD:                                                                                      \
    return launch_dkdv_wgmma<DD>(q, k, v, dout, lse, delta, q_ranges, dk, dv, B, S, H, KV, bq, \
                                 bk, scale, softcap, window, st);
    CASE(64) CASE(128) CASE(256)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* k_ranges,
                                void* dq_, int B, int S, int H, int KV, int D, int bq, int bk,
                                float scale, float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define CASE(DD)                                                                              \
  case DD:                                                                                    \
    return simt::launch_dq<DD>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, bq, bk, \
                               scale, softcap, window, st);
    CASE(64) CASE(128) CASE(256)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* k_ranges,
                                 void* dq_, int B, int S, int H, int KV, int D, int bq, int bk,
                                 float scale, float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define CASE(DD)                                                                               \
  case DD:                                                                                     \
    return launch_dq_wgmma<DD>(q, k, v, dout, lse, delta, k_ranges, dq_, B, S, H, KV, bq, bk, \
                               scale, softcap, window, st);
    CASE(64) CASE(128) CASE(256)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
