// The backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes.
//
// No Pallas kernel computes it: the reference trains through jax.grad of the
// XLA-level chunked SSD (src/repro/models/ssm.py:34 ssd_chunked, reached from
// mamba2_train, :196), whose forward the TPU kernel src/repro/kernels/ssd.py:72
// ssd_scan computes.  Training has no entering state and drops the final one.
//
// The gradients.  Per (batch b, head h) and chunk c, with cum the inclusive
// sum of dt A inside the chunk, total its last value, dec_ij = e^{cum_i -
// cum_j} (i >= j), s_j = dt_j e^{total - cum_j}, h_in the state entering the
// chunk and G = dL/d(state leaving it):
//   dW_ij = dy_i . x_j,  M_ij = dW_ij dec_ij dt_j,  W_ij = (C_i . B_j) dec_ij dt_j
//   dx_j  = sum_{i>=j} W_ij dy_i + s_j G B_j
//   dB_j  = sum_{i>=j} M_ij C_i + s_j x_j^T G          (summed over heads)
//   dC_i  = sum_{j<=i} M_ij B_j + e^{cum_i} dy_i^T h_in (summed over heads)
//   dcum_k = sum_j Z_kj - sum_i Z_ik + e^{cum_k} dy_k . (h_in C_k) - s_k r_k
//            (+ <G, h_out> at the chunk's last row), Z = M o CB, r_k = x_k^T G B_k
//   d(dt)_t = A da_t + sum_i dW_it CB_it dec_it + e^{total - cum_t} r_t,
//   dA = sum_t dt_t da_t, with da_t = sum_{k>=t} dcum_k inside the chunk;
// and from chunk to chunk, backwards, G_{c-1} = e^{total_c} G_c +
// sum_i e^{cum_i} dy_i C_i^T.  ssd.py:ssd_scan_backward_plain holds the same
// formulas in plain torch.
//
// Bound on an H100 SXM at mamba2-1.3b's training call (B 2, S 4096, H 64,
// P 64, N 128, chunk 128, bf16): x, dy and dx 67 MB each, dt and d(dt) 2 MB
// each, B, C, dB and dC 2 MB each: 211 MB, 63 us at 3.35 TB/s; some 62 GFLOP
// of block products (the causal halves of dy x^T, C B^T and the three
// products by them, and the six by the states), 63 us at the 989 TFLOP/s of
// bf16 tensor cores: both bounds alike.
//
// Design.  One CTA of eight warps per (b, h), as the forward, so nothing
// crosses CTAs inside the chunk walk:
//   pass 1 walks the chunks forward and writes the state entering each one
//     to a float32 scratch (B, H, chunks, P, N), from which pass 2 reads it
//     back (the same CTA's writes, made visible by its barriers);
//   pass 2 walks them backwards with G in shared memory.  B and C are shared
//     by all H heads (ngroups = 1), so a CTA writes its head's dB and dC as
//     float32 partials (B, H, S, N), and dA's as one float per (b, h); a
//     second launch sums them over the heads (and dA over the batch) in a
//     fixed order.  No atomics: a call repeats bit for bit.  At the training
//     shape the scratch is 134 MB of states and 268 MB for each partial.
// Two variants, picked by dtype alone (ssd.py:_variant):
// 1. mma (bf16): the chunk's x, dy, B and C tiles in shared memory (rows
//    padded by 16 bytes for ldmatrix), every product on mma.sync m16n8k16
//    with float32 accumulators.  Warp w owns the 16 positions 16 w .. in two
//    sweeps: as the column block j (dx_j, dB_j and the column sums of Z,
//    looping over the row blocks i >= j) and as the row block i (dC_i and the
//    row sums of Z, looping over j <= i).  dy x^T and C B^T are recomputed
//    per 16 x 16 block in each sweep (bf16 in, float32 out: exact products)
//    and M and W built from them in registers straight into A fragments, as
//    the forward builds its weights.  The float32 operand of every other
//    product (M, W, G, h_in, e^{cum} o dy, s o x) is split into bf16 hi =
//    bf16(a) and lo = bf16(a - hi), both multiplied in, as the forward does:
//    one rounding to bf16 would cost some 8 bits of each product.  About
//    209 KB of shared memory at P = 64, N = 128, chunk 128: one CTA an SM.
// 2. simt (float32): the same passes with float32 FMAs; x, dy, G and h_in in
//    shared memory, B and C read through L1, the chunk's weights built 32
//    rows at a time, each thread adding every row block's share of its own
//    dx and dB entries to the outputs (TF32 would break the float32 limits).
// Making it fast (wgmma, a chunk-parallel split, fusing the partial sums) is
// later work.
#include <stdint.h>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;

// Per-position vectors of a chunk in shared memory, kVecs of Q floats each.
enum Vec { kDt, kCum, kEcum, kSv, kEtot, kColzp, kRv, kRowz, kUv, kVecs };

// By warp 0: cum (inclusive sum of dt A), e^{cum}, e^{total - cum} and
// s = dt e^{total - cum} of a chunk, Q / 32 consecutive rows a lane (rows
// past the chunk's end have dt = 0 and add nothing).
template <int Q>
__device__ __forceinline__ void scan_chunk(float* v, float a_h, int lane) {
  constexpr int E = Q / 32;
  const float* dts = v + kDt * Q;
  float c[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += dts[lane * E + e] * a_h;
    c[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane * E + e;
    const float cum = c[e] + excl;
    const float etot = expf(total - cum);
    v[kCum * Q + k] = cum;
    v[kEcum * Q + k] = expf(cum);
    v[kEtot * Q + k] = etot;
    v[kSv * Q + k] = dts[k] * etot;
  }
}

// By warp 0, once the sweeps have filled the chunk's vectors: dcum, then
// da_t = sum_{k >= t} dcum_k (a suffix sum inside the chunk), d(dt) of its
// valid rows (row k at ddt[k * H]) and this lane's share of dA.
template <int Q>
__device__ __forceinline__ void finish_chunk(const float* v, float dtotal, float a_h, int qv,
                                             float* ddt, int H, int lane, float& da_acc) {
  constexpr int E = Q / 32;
  float suf[E];
  float run = 0.f;
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    const int k = lane * E + e;
    float dc = v[kRowz * Q + k] - v[kDt * Q + k] * v[kColzp * Q + k] + v[kUv * Q + k] -
               v[kSv * Q + k] * v[kRv * Q + k];
    if (k == Q - 1) dc += dtotal;
    run += dc;
    suf[e] = run;
  }
  float incl = run;  // the sum over this lane's rows and every later lane's
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += t;
  }
  float later = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) later = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane * E + e;
    const float da = suf[e] + later;
    if (k < qv)
      ddt[static_cast<size_t>(k) * H] =
          a_h * da + v[kColzp * Q + k] + v[kEtot * Q + k] * v[kRv * Q + k];
    da_acc += v[kDt * Q + k] * da;
  }
}

// Sums x over the block in a fixed order (warps by shuffles, then warp by
// warp through `red`); every thread gets the sum.  Two barriers: the first
// waits for every read of `red` by the call before.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = attn::warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------- simt

namespace simt {

constexpr int kR = 32;  // rows of the chunk's weights built at once

// Shared memory, float32: x and dy [Q][P], the state (pass 1) or G (pass 2)
// and h_in [P][N], three row blocks of weights [kR][Q] (M, W and Z / dt;
// before them G B_j [Q][P]), the vectors and a reduction scratch.
template <int P, int N, int Q>
struct Layout {
  static constexpr size_t buf_floats = 3 * kR * Q > Q * P ? 3 * kR * Q : Q * P;
  static constexpr size_t x_off = 0;
  static constexpr size_t dy_off = x_off + sizeof(float) * Q * P;
  static constexpr size_t g_off = dy_off + sizeof(float) * Q * P;
  static constexpr size_t h_off = g_off + sizeof(float) * P * N;
  static constexpr size_t buf_off = h_off + sizeof(float) * P * N;
  static constexpr size_t v_off = buf_off + sizeof(float) * buf_floats;
  static constexpr size_t red_off = v_off + sizeof(float) * kVecs * Q;
  static constexpr size_t bytes = red_off + sizeof(float) * kWarps;
};

template <int P, int N, int Q>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_simt(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dy,
                 float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
                 float* __restrict__ dcp, float* __restrict__ dap, float* hch, long long sBb,
                 long long sBs, long long sCb, long long sCs, int S, int H) {
  using L = Layout<P, N, Q>;
  static_assert(L::bytes <= 232448, "shared memory");
  static_assert(kThreads % Q == 0 && kThreads % P == 0 && kThreads % N == 0, "tile shape");
  static_assert(kR * 8 == kThreads && Q % kR == 0, "row block");
  constexpr int XPT = Q * P / kThreads;  // (j, p) entries of dx a thread
  constexpr int BPT = Q * N / kThreads;  // (j, n) entries of dB a thread
  constexpr int SPT = P * N / kThreads;  // state entries a thread

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + L::x_off);
  float* dys = reinterpret_cast<float*>(smem + L::dy_off);
  float* gs = reinterpret_cast<float*>(smem + L::g_off);
  float* hs = reinterpret_cast<float*>(smem + L::h_off);
  float* mb = reinterpret_cast<float*>(smem + L::buf_off);
  float* wb = mb + kR * Q;
  float* zb = wb + kR * Q;
  float* gbuf = mb;  // G B_j, before the row blocks
  float* v = reinterpret_cast<float*>(smem + L::v_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  float* dts = v + kDt * Q;
  const float* cum = v + kCum * Q;
  const float* ecum = v + kEcum * Q;
  const float* sv = v + kSv * Q;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float a_h = A[h];
  const long long row0 = static_cast<long long>(b) * S;
  const int n_chunks = (S + Q - 1) / Q;
  float* hb = hch + bh * n_chunks * P * N;
  auto Bv = [&](int s0, int j, int n) { return __ldg(Bm + b * sBb + (s0 + j) * sBs + n); };
  auto Cv = [&](int s0, int i, int n) { return __ldg(Cm + b * sCb + (s0 + i) * sCs + n); };
  auto load_tile = [&](float* tile, const float* src, int s0, int qv) {
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P;
      tile[idx] = j < qv ? src[((row0 + s0 + j) * H + h) * P + idx % P] : 0.f;
    }
  };
  auto load_dt = [&](int s0, int qv) {
    for (int j = tid; j < Q; j += kThreads) dts[j] = j < qv ? dt[(row0 + s0 + j) * H + h] : 0.f;
  };

  // ---- pass 1: the state entering each chunk, to the scratch.
  for (int idx = tid; idx < P * N; idx += kThreads) gs[idx] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    __syncthreads();  // the state is updated; the tiles are free
    for (int idx = tid; idx < P * N; idx += kThreads) hb[static_cast<size_t>(c) * P * N + idx] = gs[idx];
    load_tile(xs, x, s0, qv);
    load_dt(s0, qv);
    __syncthreads();
    if (tid < 32) scan_chunk<Q>(v, a_h, lane);
    __syncthreads();
    const float decay = expf(cum[Q - 1]);
#pragma unroll 1
    for (int k = 0; k < SPT; ++k) {
      const int idx = tid + k * kThreads;
      const int p = idx / N, n = idx % N;
      float acc = gs[idx] * decay;
      for (int j = 0; j < qv; ++j) acc += sv[j] * xs[j * P + p] * Bv(s0, j, n);
      gs[idx] = acc;
    }
  }

  // ---- pass 2: the chunks backwards.
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) gs[idx] = 0.f;
  float dtotal = 0.f, da_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    const float* hin = hb + static_cast<size_t>(c) * P * N;
    __syncthreads();
    load_tile(xs, x, s0, qv);
    load_tile(dys, dy, s0, qv);
    load_dt(s0, qv);
    for (int idx = tid; idx < P * N; idx += kThreads) hs[idx] = hin[idx];
    for (int idx = tid; idx < Q; idx += kThreads)
      v[kColzp * Q + idx] = v[kRv * Q + idx] = v[kRowz * Q + idx] = v[kUv * Q + idx] = 0.f;
    __syncthreads();
    if (tid < 32) scan_chunk<Q>(v, a_h, lane);
    __syncthreads();

    // The states' terms first: dx_j = s_j G B_j and dB_j = s_j x_j^T G,
    // written to the outputs, which the row blocks below then add to (each
    // thread reads and writes only its own entries); r_j = x_j^T G B_j.
#pragma unroll 1
    for (int k = 0; k < XPT; ++k) {
      const int idx = tid + k * kThreads;
      const int j = idx / P, p = idx % P;
      float g = 0.f;
      if (j < qv) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) g += gs[p * N + n] * Bv(s0, j, n);
        dx[((row0 + s0 + j) * H + h) * P + p] = sv[j] * g;
      }
      gbuf[idx] = g;
    }
#pragma unroll 1
    for (int k = 0; k < BPT; ++k) {
      const int idx = tid + k * kThreads;
      const int j = idx / N, n = idx % N;
      if (j >= qv) continue;
      float t = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) t += xs[j * P + p] * gs[p * N + n];
      dbp[(bh * S + s0 + j) * N + n] = sv[j] * t;
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) {
      float r = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) r += xs[j * P + p] * gbuf[j * P + p];
      v[kRv * Q + j] = r;
    }
    __syncthreads();  // gbuf is free

#pragma unroll 1
    for (int i0 = 0; i0 < qv; i0 += kR) {
      // M, W and Z / dt of rows i0 .. i0 + kR - 1, every column j <= i.
#pragma unroll 1
      for (int idx = tid; idx < kR * Q; idx += kThreads) {
        const int r = idx / Q, j = idx % Q;
        const int i = i0 + r;
        float m = 0.f, w = 0.f, zp = 0.f;
        if (i < qv && j <= i) {
          float dw = 0.f, cb = 0.f;
#pragma unroll 4
          for (int p = 0; p < P; ++p) dw += dys[i * P + p] * xs[j * P + p];
#pragma unroll 4
          for (int n = 0; n < N; ++n) cb += Cv(s0, i, n) * Bv(s0, j, n);
          const float dec = expf(cum[i] - cum[j]);
          m = dw * dec * dts[j];
          w = cb * dec * dts[j];
          zp = dw * cb * dec;
        }
        mb[idx] = m;
        wb[idx] = w;
        zb[idx] = zp;
      }
      __syncthreads();
      {
        // dC of row i = i0 + r (eight lanes a row): M B + e^{cum_i} dy_i h_in;
        // the row sums of Z and e^{cum_i} dy_i . (h_in C_i).
        const int r = tid / 8, l8 = tid % 8;
        const int i = i0 + r;
        float rz = 0.f, uu = 0.f;
        for (int j = l8; j < Q; j += 8) rz += zb[r * Q + j] * dts[j];
        if (i < qv) {  // 8-lane groups: a warp holds four rows
#pragma unroll 1
          for (int n = l8; n < N; n += 8) {
            float inter = 0.f, intra = 0.f;
#pragma unroll 4
            for (int p = 0; p < P; ++p) inter += dys[i * P + p] * hs[p * N + n];
            inter *= ecum[i];
            for (int j = 0; j <= i; ++j) intra += mb[r * Q + j] * Bv(s0, j, n);
            dcp[(bh * S + s0 + i) * N + n] = intra + inter;
            uu += inter * Cv(s0, i, n);
          }
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          rz += __shfl_xor_sync(0xffffffffu, rz, off);
          uu += __shfl_xor_sync(0xffffffffu, uu, off);
        }
        if (l8 == 0) {
          v[kRowz * Q + i] = rz;
          v[kUv * Q + i] = uu;
        }
      }
      // The columns: dx_j += W^T dy, dB_j += M^T C, and Z's column sums / dt.
      const int rows = min(kR, qv - i0);
#pragma unroll 1
      for (int k = 0; k < XPT; ++k) {
        const int idx = tid + k * kThreads;
        const int j = idx / P, p = idx % P;
        if (j >= qv) continue;
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += wb[r * Q + j] * dys[(i0 + r) * P + p];
        dx[((row0 + s0 + j) * H + h) * P + p] += acc;
      }
#pragma unroll 1
      for (int k = 0; k < BPT; ++k) {
        const int idx = tid + k * kThreads;
        const int j = idx / N, n = idx % N;
        if (j >= qv) continue;
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += mb[r * Q + j] * Cv(s0, i0 + r, n);
        dbp[(bh * S + s0 + j) * N + n] += acc;
      }
      for (int j = tid; j < Q; j += kThreads) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += zb[r * Q + j];
        v[kColzp * Q + j] += acc;
      }
      __syncthreads();  // the weights are free
    }
    __syncthreads();
    if (tid < 32)
      finish_chunk<Q>(v, dtotal, a_h, qv, ddt + (row0 + s0) * H + h, H, lane, da_acc);
    // G <- e^{total} G + sum_i e^{cum_i} dy_i C_i^T, and <G, h_in> for the
    // chunk before (the state leaving it is this chunk's h_in).
    const float decay = expf(cum[Q - 1]);
    float part = 0.f;
#pragma unroll 1
    for (int k = 0; k < SPT; ++k) {
      const int idx = tid + k * kThreads;
      const int p = idx / N, n = idx % N;
      float acc = gs[idx] * decay;
      for (int i = 0; i < qv; ++i) acc += ecum[i] * dys[i * P + p] * Cv(s0, i, n);
      gs[idx] = acc;
      part += acc * hs[idx];
    }
    dtotal = block_sum(part, red);
  }
  if (tid < 32) {
    da_acc = attn::warp_sum(da_acc);
    if (lane == 0) dap[bh] = da_acc;
  }
}

}  // namespace simt

// ---------------------------------------------------------------- mma

namespace tc {

using bf16 = __nv_bfloat16;

// `rows` rows of `cols` bf16, row r at src + r * stride, into a shared tile
// with rows `ld` elements apart; rows at or past `valid` are zero-filled.
// With `aligned` (16-byte aligned rows) by cp.async in the current commit
// group, else element by element.
__device__ __forceinline__ void load_rows(bf16* tile, int ld, const bf16* src, long long stride,
                                          int rows, int cols, int valid, bool aligned) {
  const int chunks = cols / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * 8;
    const bool ok = r < valid;
    const bf16* from = src + (ok ? r : 0) * stride + c;
    if (aligned) {
      mma::cp_async16(tile + r * ld + c, from, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) tile[r * ld + c + e] = ok ? from[e] : __float2bfloat16(0.f);
    }
  }
}

// A float32 (P x N) matrix, `from` (row-major, rows N apart), as bf16 hi and
// lo halves in shared tiles with rows `ld` apart.
__device__ __forceinline__ void split_tile(const float* from, bf16* hi, bf16* lo, int P, int N,
                                           int ld) {
  for (int idx = threadIdx.x; idx < P * N / 2; idx += kThreads) {
    const int p = (2 * idx) / N, n = (2 * idx) % N;
    const float2 f = *reinterpret_cast<const float2*>(from + 2 * idx);
    uint32_t h2, l2;
    mma::split2(f.x, f.y, h2, l2);
    *reinterpret_cast<uint32_t*>(hi + p * ld + n) = h2;
    *reinterpret_cast<uint32_t*>(lo + p * ld + n) = l2;
  }
}

// Shared memory: x and dy [Q][P + 8], B and C [Q][N + 8] bf16; h_in's and
// G's hi and lo halves [P][N + 8] bf16; the state (pass 1) or G (pass 2)
// [P][N] float32; the vectors and a reduction scratch.
template <int P, int N, int Q>
struct Layout {
  static constexpr int LDX = P + 8;
  static constexpr int LDN = N + 8;
  static constexpr size_t x_off = 0;
  static constexpr size_t dy_off = x_off + sizeof(bf16) * Q * LDX;
  static constexpr size_t b_off = dy_off + sizeof(bf16) * Q * LDX;
  static constexpr size_t c_off = b_off + sizeof(bf16) * Q * LDN;
  static constexpr size_t hhi_off = c_off + sizeof(bf16) * Q * LDN;
  static constexpr size_t hlo_off = hhi_off + sizeof(bf16) * P * LDN;
  static constexpr size_t ghi_off = hlo_off + sizeof(bf16) * P * LDN;
  static constexpr size_t glo_off = ghi_off + sizeof(bf16) * P * LDN;
  static constexpr size_t gf_off = glo_off + sizeof(bf16) * P * LDN;
  static constexpr size_t v_off = gf_off + sizeof(float) * P * N;
  static constexpr size_t red_off = v_off + sizeof(float) * kVecs * Q;
  static constexpr size_t bytes = red_off + sizeof(float) * kWarps;
};

// gf (P x N float32) <- decay gf + (scale o A)^T Bt over the chunk's first
// k_steps 16-row blocks: A (Q x P, rows lda apart) and Bt (Q x N, rows ldb
// apart) bf16 tiles whose rows are positions, scale a Q-vector.  Warp w owns
// the 16 x 32 blocks u = w, w + 8, ... of gf, in the accumulators of mma
// fragments; scale o A is split into bf16 hi + lo.  With `dotm` (a P x N
// float32 matrix in global memory), returns this thread's share of
// <gf_new, dotm>.
template <int P, int N, int LDA, int LDB>
__device__ __forceinline__ float state_update(float* gf, const bf16* a_tile, const float* scale,
                                              const bf16* b_tile, float decay, int k_steps,
                                              const float* dotm) {
  constexpr int MT_S = P / 16;
  constexpr int UNITS = MT_S * (N / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  float dot = 0.f;
  for (int u = warp; u < UNITS; u += kWarps) {
    const int m0 = (u % MT_S) * 16, n0 = (u / MT_S) * 32;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] = gf[(m0 + gq + 8 * (e >> 1)) * N + n0 + nt * 8 + 2 * cq + (e & 1)] * decay;
    for (int kt = 0; kt < k_steps; ++kt) {
      const int j0 = kt * 16;
      uint32_t ax[4], ahi[4], alo[4];
      mma::ldsm_x4_t(ax, a_tile + (j0 + mma::a_kmajor_row(lane)) * LDA + m0 +
                             mma::a_kmajor_col(lane));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 2 * cq + 8 * (e >> 1);
        const float2 av = mma::unpack_bf16(ax[e]);
        mma::split2(av.x * scale[j], av.y * scale[j + 1], ahi[e], alo[e]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        mma::ldsm_x4_t(bb, b_tile + (j0 + mma::b_kmajor_row(lane)) * LDB + n0 + np * 16 +
                               mma::b_kmajor_col(lane));
        mma::mma_bf16(acc[2 * np], ahi, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * np], alo, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * np + 1], ahi, bb[2], bb[3]);
        mma::mma_bf16(acc[2 * np + 1], alo, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (m0 + gq + 8 * (e >> 1)) * N + n0 + nt * 8 + 2 * cq + (e & 1);
        gf[idx] = acc[nt][e];
        if (dotm != nullptr) dot += acc[nt][e] * dotm[idx];
      }
  }
  return dot;
}

// Sums over the four lanes of a quad (the lanes holding one fragment row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One 16 x 16 block of a product of two shared bf16 tiles whose rows are
// positions: acc[t] (the n8 halves) += A rows a0 .. a0 + 15 times the rows
// b0 .. b0 + 15 of Bt, transposed, over K columns.
template <int K, int LD>
__device__ __forceinline__ void block_product(float (&acc)[2][4], const bf16* a_tile, int a0,
                                              const bf16* b_tile, int b0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4], bb[4];
    mma::ldsm_x4(a, a_tile + (a0 + mma::a_rowmajor_row(lane)) * LD + kk +
                        mma::a_rowmajor_col(lane));
    mma::ldsm_x4(bb, b_tile + (b0 + mma::b_nmajor_row(lane)) * LD + kk +
                         mma::b_nmajor_col(lane));
    mma::mma_bf16(acc[0], a, bb[0], bb[1]);
    mma::mma_bf16(acc[1], a, bb[2], bb[3]);
  }
}

// acc (16 x C) += A (the hi and lo A fragments of a 16 x 16 block) times
// rows r0 .. r0 + 15 of a shared bf16 tile (C columns, rows LD apart).
template <int C, int LD>
__device__ __forceinline__ void times_rows(float (&acc)[C / 8][4], const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4], const bf16* tile, int r0,
                                           int lane) {
#pragma unroll
  for (int np = 0; np < C / 16; ++np) {
    uint32_t bb[4];
    mma::ldsm_x4_t(bb, tile + (r0 + mma::b_kmajor_row(lane)) * LD + np * 16 +
                           mma::b_kmajor_col(lane));
    mma::mma_bf16(acc[2 * np], hi, bb[0], bb[1]);
    mma::mma_bf16(acc[2 * np], lo, bb[0], bb[1]);
    mma::mma_bf16(acc[2 * np + 1], hi, bb[2], bb[3]);
    mma::mma_bf16(acc[2 * np + 1], lo, bb[2], bb[3]);
  }
}

// acc (16 x C) += rows a0 .. a0 + 15 of a shared bf16 tile (K columns) times
// a K x C matrix given as hi and lo bf16 tiles: stored [K][C] (`kmajor`) or
// [C][K], rows LDM apart.
template <int K, int C, int LDA, int LDM, bool kmajor>
__device__ __forceinline__ void times_split(float (&acc)[C / 8][4], const bf16* a_tile, int a0,
                                            const bf16* mhi, const bf16* mlo, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    mma::ldsm_x4(a, a_tile + (a0 + mma::a_rowmajor_row(lane)) * LDA + kk +
                        mma::a_rowmajor_col(lane));
#pragma unroll
    for (int np = 0; np < C / 16; ++np) {
      uint32_t bh[4], bl[4];
      if (kmajor) {
        const int off = (kk + mma::b_kmajor_row(lane)) * LDM + np * 16 + mma::b_kmajor_col(lane);
        mma::ldsm_x4_t(bh, mhi + off);
        mma::ldsm_x4_t(bl, mlo + off);
      } else {
        const int off = (np * 16 + mma::b_nmajor_row(lane)) * LDM + kk + mma::b_nmajor_col(lane);
        mma::ldsm_x4(bh, mhi + off);
        mma::ldsm_x4(bl, mlo + off);
      }
      mma::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
      mma::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
      mma::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
      mma::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
    }
  }
}

// The dot of each of a warp's two fragment rows (r0 + gq, r0 + gq + 8) of
// acc (16 x C) with the same rows of a shared bf16 tile, summed over the quad.
template <int C, int LD>
__device__ __forceinline__ void row_dots(float (&out)[2], const float (&acc)[C / 8][4],
                                         const bf16* tile, int r0, int lane) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.f;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const float2 t = mma::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(tile + (r0 + gq + 8 * hh) * LD + nt * 8 + 2 * cq));
      s += acc[nt][2 * hh] * t.x + acc[nt][2 * hh + 1] * t.y;
    }
    out[hh] = quad_sum(s);
  }
}

template <int C>
__device__ __forceinline__ void scale_rows(float (&acc)[C / 8][4], float s0, float s1) {
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    acc[nt][0] *= s0;
    acc[nt][1] *= s0;
    acc[nt][2] *= s1;
    acc[nt][3] *= s1;
  }
}

template <int P, int N, int Q>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const bf16* __restrict__ dy, bf16* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ dbp, float* __restrict__ dcp,
                float* __restrict__ dap, float* hch, long long sBb, long long sBs, long long sCb,
                long long sCs, int S, int H, int aligned) {
  using Lay = Layout<P, N, Q>;
  constexpr int LDX = Lay::LDX, LDN = Lay::LDN;
  constexpr int MT = Q / 16;  // 16-row blocks of a chunk, one a warp
  static_assert(Lay::bytes <= 232448, "shared memory");
  static_assert(MT <= kWarps && P % 16 == 0 && N % 32 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + Lay::x_off);
  bf16* dys = reinterpret_cast<bf16*>(smem + Lay::dy_off);
  bf16* bs = reinterpret_cast<bf16*>(smem + Lay::b_off);
  bf16* cs = reinterpret_cast<bf16*>(smem + Lay::c_off);
  bf16* hhi = reinterpret_cast<bf16*>(smem + Lay::hhi_off);
  bf16* hlo = reinterpret_cast<bf16*>(smem + Lay::hlo_off);
  bf16* ghi = reinterpret_cast<bf16*>(smem + Lay::ghi_off);
  bf16* glo = reinterpret_cast<bf16*>(smem + Lay::glo_off);
  float* gf = reinterpret_cast<float*>(smem + Lay::gf_off);
  float* v = reinterpret_cast<float*>(smem + Lay::v_off);
  float* red = reinterpret_cast<float*>(smem + Lay::red_off);
  float* dts = v + kDt * Q;
  const float* cum = v + kCum * Q;
  const float* ecum = v + kEcum * Q;
  const float* sv = v + kSv * Q;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float a_h = A[h];
  const long long row0 = static_cast<long long>(b) * S;
  const int n_chunks = (S + Q - 1) / Q;
  float* hb = hch + bh * n_chunks * P * N;
  const long long sX = static_cast<long long>(H) * P;
  auto load_dt = [&](int s0, int qv) {
    for (int j = tid; j < Q; j += kThreads) dts[j] = j < qv ? dt[(row0 + s0 + j) * H + h] : 0.f;
  };

  // ---- pass 1: the state entering each chunk, to the scratch.
  for (int idx = tid; idx < P * N; idx += kThreads) gf[idx] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    __syncthreads();  // the state is updated; the tiles are free
    for (int idx = tid; idx < P * N / 4; idx += kThreads)
      reinterpret_cast<float4*>(hb + static_cast<size_t>(c) * P * N)[idx] =
          reinterpret_cast<const float4*>(gf)[idx];
    load_rows(xs, LDX, x + ((row0 + s0) * H + h) * P, sX, Q, P, qv, aligned);
    load_rows(bs, LDN, Bm + b * sBb + s0 * sBs, sBs, Q, N, qv, aligned);
    load_dt(s0, qv);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) scan_chunk<Q>(v, a_h, lane);
    __syncthreads();
    state_update<P, N, LDX, LDN>(gf, xs, sv, bs, expf(cum[Q - 1]), (qv + 15) / 16, nullptr);
  }

  // ---- pass 2: the chunks backwards.
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) gf[idx] = 0.f;
  float dtotal = 0.f, da_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    const float* hin = hb + static_cast<size_t>(c) * P * N;
    __syncthreads();  // G is updated; the tiles are free
    load_rows(xs, LDX, x + ((row0 + s0) * H + h) * P, sX, Q, P, qv, aligned);
    load_rows(dys, LDX, dy + ((row0 + s0) * H + h) * P, sX, Q, P, qv, aligned);
    load_rows(bs, LDN, Bm + b * sBb + s0 * sBs, sBs, Q, N, qv, aligned);
    load_rows(cs, LDN, Cm + b * sCb + s0 * sCs, sCs, Q, N, qv, aligned);
    mma::cp_async_commit();
    load_dt(s0, qv);
    split_tile(hin, hhi, hlo, P, N, LDN);
    split_tile(gf, ghi, glo, P, N, LDN);
    for (int idx = tid; idx < Q; idx += kThreads)
      v[kColzp * Q + idx] = v[kRv * Q + idx] = v[kRowz * Q + idx] = v[kUv * Q + idx] = 0.f;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) scan_chunk<Q>(v, a_h, lane);
    __syncthreads();

    // Column sweep: warp w owns positions j0 .. j0 + 15 as the j of dx_j,
    // dB_j, r_j and Z's column sums.
    if (warp < MT && warp * 16 < qv) {
      const int j0 = warp * 16;
      float accb[N / 8][4] = {}, accx[P / 8][4] = {};
      // s_j x_j^T G, r_j = x_j^T G B_j; s_j G B_j.
      times_split<P, N, LDX, LDN, true>(accb, xs, j0, ghi, glo, lane);
      float r[2];
      row_dots<N, LDN>(r, accb, bs, j0, lane);
      const float s_lo = sv[j0 + gq], s_hi = sv[j0 + gq + 8];
      scale_rows<N>(accb, s_lo, s_hi);
      times_split<N, P, LDN, LDN, false>(accx, bs, j0, ghi, glo, lane);
      scale_rows<P>(accx, s_lo, s_hi);
      float zp[2] = {0.f, 0.f};
      for (int it = warp; it < MT; ++it) {
        const int i0 = it * 16;
        if (i0 >= qv) break;
        // (dy x^T)^T and (C B^T)^T on block (j, i): x_j . dy_i and B_j . C_i.
        float dwt[2][4] = {}, cbt[2][4] = {};
        block_product<P, LDX>(dwt, xs, j0, dys, i0, lane);
        block_product<N, LDN>(cbt, bs, j0, cs, i0, lane);
        uint32_t mhi[4], mlo[4], whi[4], wlo[4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = j0 + gq + 8 * hh;
            float m2[2], w2[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int i = i0 + 8 * t + 2 * cq + q;
              float m = 0.f, w = 0.f;
              if (i >= j) {
                const float dec = expf(cum[i] - cum[j]);
                const float dw = dwt[t][2 * hh + q], cb = cbt[t][2 * hh + q];
                m = dw * dec * dts[j];
                w = cb * dec * dts[j];
                zp[hh] += dw * cb * dec;
              }
              m2[q] = m;
              w2[q] = w;
            }
            mma::split2(m2[0], m2[1], mhi[hh + 2 * t], mlo[hh + 2 * t]);
            mma::split2(w2[0], w2[1], whi[hh + 2 * t], wlo[hh + 2 * t]);
          }
        times_rows<N, LDN>(accb, mhi, mlo, cs, i0, lane);
        times_rows<P, LDX>(accx, whi, wlo, dys, i0, lane);
      }
      zp[0] = quad_sum(zp[0]);
      zp[1] = quad_sum(zp[1]);
      if (cq == 0) {
        v[kColzp * Q + j0 + gq] = zp[0];
        v[kColzp * Q + j0 + gq + 8] = zp[1];
        v[kRv * Q + j0 + gq] = r[0];
        v[kRv * Q + j0 + gq + 8] = r[1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = j0 + gq + 8 * hh;
        if (j >= qv) continue;
        bf16* xr = dx + ((row0 + s0 + j) * H + h) * P + 2 * cq;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(xr + nt * 8) =
              __floats2bfloat162_rn(accx[nt][2 * hh], accx[nt][2 * hh + 1]);
        float* br = dbp + (bh * S + s0 + j) * N + 2 * cq;
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt)
          *reinterpret_cast<float2*>(br + nt * 8) = make_float2(accb[nt][2 * hh], accb[nt][2 * hh + 1]);
      }
    }

    // Row sweep: warp w owns positions i0 .. i0 + 15 as the i of dC_i and
    // Z's row sums.
    if (warp < MT && warp * 16 < qv) {
      const int i0 = warp * 16;
      float accc[N / 8][4] = {};
      // e^{cum_i} dy_i h_in, and its dot with C_i.
      times_split<P, N, LDX, LDN, true>(accc, dys, i0, hhi, hlo, lane);
      scale_rows<N>(accc, ecum[i0 + gq], ecum[i0 + gq + 8]);
      float u[2];
      row_dots<N, LDN>(u, accc, cs, i0, lane);
      float rz[2] = {0.f, 0.f};
      for (int jt = 0; jt <= warp; ++jt) {
        const int j0 = jt * 16;
        float dw[2][4] = {}, cb[2][4] = {};
        block_product<P, LDX>(dw, dys, i0, xs, j0, lane);
        block_product<N, LDN>(cb, cs, i0, bs, j0, lane);
        uint32_t mhi[4], mlo[4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = i0 + gq + 8 * hh;
            float m2[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int j = j0 + 8 * t + 2 * cq + q;
              float m = 0.f;
              if (j <= i) {
                m = dw[t][2 * hh + q] * expf(cum[i] - cum[j]) * dts[j];
                rz[hh] += m * cb[t][2 * hh + q];
              }
              m2[q] = m;
            }
            mma::split2(m2[0], m2[1], mhi[hh + 2 * t], mlo[hh + 2 * t]);
          }
        times_rows<N, LDN>(accc, mhi, mlo, bs, j0, lane);
      }
      rz[0] = quad_sum(rz[0]);
      rz[1] = quad_sum(rz[1]);
      if (cq == 0) {
        v[kRowz * Q + i0 + gq] = rz[0];
        v[kRowz * Q + i0 + gq + 8] = rz[1];
        v[kUv * Q + i0 + gq] = u[0];
        v[kUv * Q + i0 + gq + 8] = u[1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + gq + 8 * hh;
        if (i >= qv) continue;
        float* cr = dcp + (bh * S + s0 + i) * N + 2 * cq;
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt)
          *reinterpret_cast<float2*>(cr + nt * 8) = make_float2(accc[nt][2 * hh], accc[nt][2 * hh + 1]);
      }
    }
    __syncthreads();
    if (warp == 0)
      finish_chunk<Q>(v, dtotal, a_h, qv, ddt + (row0 + s0) * H + h, H, lane, da_acc);
    // G <- e^{total} G + (e^{cum} o dy)^T C, and <G, h_in> for the chunk
    // before (the state leaving it is this chunk's h_in).
    const float part = state_update<P, N, LDX, LDN>(gf, dys, ecum, cs, expf(cum[Q - 1]),
                                                   (qv + 15) / 16, hin);
    dtotal = block_sum(part, red);
  }
  if (warp == 0) {
    da_acc = attn::warp_sum(da_acc);
    if (lane == 0) dap[bh] = da_acc;
  }
}

}  // namespace tc

// Sums the heads' partials of dB and dC (B, H, S, N) into (B, S, N) and
// dA's (B, H) over the batch, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
                   const float* __restrict__ dap, T* __restrict__ dB, T* __restrict__ dC,
                   float* __restrict__ dA, int B, int S, int H, int N) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < static_cast<long long>(B) * S * N) {
    const long long n = idx % N;
    const long long bs = idx / N;
    const long long s = bs % S, b = bs / S;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t off = ((b * H + h) * S + s) * N + n;
      sb += dbp[off];
      sc += dcp[off];
    }
    attn::store(dB + idx, sb);
    attn::store(dC + idx, sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float a = 0.f;
      for (int b = 0; b < B; ++b) a += dap[b * H + h];
      dA[h] = a;
    }
}

struct Args {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  void* dx;
  void* ddt;
  void* dbp;
  void* dcp;
  void* dap;
  void* hch;
  void* dB;
  void* dC;
  void* dA;
  long long sBb, sBs, sCb, sCs;
  int B, S, H, aligned;
  cudaEvent_t mid;
};

template <typename T>
int launch_reduce(const Args& a, int N, cudaStream_t stream) {
  cudaError_t err;
  if (a.mid != nullptr && (err = cudaEventRecord(a.mid, stream)) != cudaSuccess) return (int)err;
  const long long total = static_cast<long long>(a.B) * a.S * N;
  const int blocks = static_cast<int>((total + 255) / 256);
  ssd_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(a.dbp), static_cast<const float*>(a.dcp),
      static_cast<const float*>(a.dap), static_cast<T*>(a.dB), static_cast<T*>(a.dC),
      static_cast<float*>(a.dA), a.B, a.S, a.H, N);
  return (int)cudaGetLastError();
}

template <int P, int N, int Q>
int launch_simt(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = simt::Layout<P, N, Q>::bytes;
  auto kernel = simt::ssd_bwd_simt<P, N, Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.H, a.B), kThreads, smem, stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.Bm),
      static_cast<const float*>(a.Cm), static_cast<const float*>(a.dy),
      static_cast<float*>(a.dx), static_cast<float*>(a.ddt), static_cast<float*>(a.dbp),
      static_cast<float*>(a.dcp), static_cast<float*>(a.dap), static_cast<float*>(a.hch), a.sBb,
      a.sBs, a.sCb, a.sCs, a.S, a.H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_reduce<float>(a, N, stream);
}

template <int P, int N, int Q>
int launch_mma(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = tc::Layout<P, N, Q>::bytes;
  auto kernel = tc::ssd_bwd_mma<P, N, Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.H, a.B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const bf16*>(a.Bm),
      static_cast<const bf16*>(a.Cm), static_cast<const bf16*>(a.dy), static_cast<bf16*>(a.dx),
      static_cast<float*>(a.ddt), static_cast<float*>(a.dbp), static_cast<float*>(a.dcp),
      static_cast<float*>(a.dap), static_cast<float*>(a.hch), a.sBb, a.sBs, a.sCb, a.sCs, a.S,
      a.H, a.aligned);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_reduce<bf16>(a, N, stream);
}

template <bool kMma, int P, int N>
int by_chunk(const Args& a, int Q, cudaStream_t st) {
  switch (Q) {
    case 32: return kMma ? launch_mma<P, N, 32>(a, st) : launch_simt<P, N, 32>(a, st);
    case 64: return kMma ? launch_mma<P, N, 64>(a, st) : launch_simt<P, N, 64>(a, st);
    case 128: return kMma ? launch_mma<P, N, 128>(a, st) : launch_simt<P, N, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kMma, int P>
int by_state(const Args& a, int N, int Q, cudaStream_t st) {
  switch (N) {
    case 32: return by_chunk<kMma, P, 32>(a, Q, st);
    case 64: return by_chunk<kMma, P, 64>(a, Q, st);
    case 128: return by_chunk<kMma, P, 128>(a, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kMma>
int dispatch(const Args& a, int P, int N, int Q, void* stream) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32: return by_state<kMma, 32>(a, N, Q, st);
    case 64: return by_state<kMma, 64>(a, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x and dy (B, S, H, P), dt (B, S, H) float32, A (H,) float32, contiguous;
// Bm and Cm (B, S, N) with element strides (sBb, sBs) and (sCb, sCs) and unit
// stride along N.  Writes dx (B, S, H, P), d(dt) (B, S, H) float32, dB and dC
// (B, S, N) contiguous and dA (H,) float32; x, Bm, Cm, dy, dx, dB and dC share
// the type.  Scratch, float32: dbp and dcp B * H * S * N floats each, dap
// B * H, hch B * H * ceil(S / Q) * P * N.  `mid`, a cudaEvent_t or null, is
// recorded between the per-head pass and the sum over the heads.  Returns
// the CUDA error code of the launches (0 on success).
extern "C" int ssd_bwd_f32(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* dy, void* dx, void* ddt, void* dbp,
                           void* dcp, void* dap, void* hch, void* dB, void* dC, void* dA,
                           long long sBb, long long sBs, long long sCb, long long sCs, int B,
                           int S, int H, int P, int N, int Q, void* mid, void* stream) {
  const Args a{x,   dt,  A,   Bm,  Cm,  dy,  dx,  ddt, dbp, dcp, dap, hch,
               dB,  dC,  dA,  sBb, sBs, sCb, sCs, B,   S,   H,   0,   static_cast<cudaEvent_t>(mid)};
  return dispatch<false>(a, P, N, Q, stream);
}

// As ssd_bwd_f32, in bf16, with `aligned` nonzero when x, dy, Bm and Cm
// start 16-byte aligned and sBb, sBs, sCb, sCs are multiples of 8 (their rows
// are then copied 16 bytes at a time).
extern "C" int ssd_bwd_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, void* dx, void* ddt, void* dbp,
                            void* dcp, void* dap, void* hch, void* dB, void* dC, void* dA,
                            long long sBb, long long sBs, long long sCb, long long sCs, int B,
                            int S, int H, int P, int N, int Q, int aligned, void* mid,
                            void* stream) {
  const Args a{x,   dt,  A,   Bm,  Cm,  dy,  dx,  ddt, dbp,     dcp, dap,
               hch, dB,  dC,  dA,  sBb, sBs, sCb, sCs, B,       S,   H,
               aligned, static_cast<cudaEvent_t>(mid)};
  return dispatch<true>(a, P, N, Q, stream);
}
