// Mamba-2 SSD chunked scan for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:72 ssd_scan (body
// _kernel): per (batch b, head h) the recurrence h_t = exp(dt_t A) h_{t-1} +
// dt_t x_t B_t^T, y_t = h_t C_t with a float32 (P, N) state, computed chunk
// by chunk.  With cum the inclusive sum of dt A inside a chunk and total its
// last value, a chunk gives
//   y_i   = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j + e^{cum_i} C_i . h_in
//   h_out = e^{total} h_in + sum_j e^{total - cum_j} dt_j x_j B_j^T.
//
// Bound on an H100 SXM at mamba2-1.3b's served prefill (B=4, S=1024, H=64,
// P=64, N=128, chunk 128, bf16, with h0): x and y 33.6 MB each, h0 and h
// 8.4 MB each, dt 1 MB, B and C 2.1 MB: 87 MB, 26 us at 3.35 TB/s, against
// about 21.5 GFLOP, 22 us at the 989 TFLOP/s of bf16 tensor cores:
// bytes-bound, but only just, so the block products must run on the tensor
// cores.  The TPU kernel walks (b, h, chunk) with chunks innermost and
// carries the state in VMEM.  Here one CTA owns one (b, h) and loops over
// its chunks itself, so nothing crosses CTAs; the last chunk may be partial
// (rows past S are zero-filled and have dt = 0, so they add nothing), and
// any S works.  Two variants, picked by dtype alone (ssd.py:_variant):
//
// 1. mma (bf16; mamba2-1.3b's served prefill), two kernels:
//    - ssd_cb, one CTA per (b, chunk, 16-row block): C B^T once for all
//      heads (B and C are shared by every head, ngroups = 1), only its
//      causal 16 x 16 blocks, into a float32 scratch (1.2 MB at the served
//      call), on mma.sync (bf16 in, float32 out: exact products).
//    - ssd_mma, one CTA of eight warps per (b, h) (256 CTAs at the served
//      shape; 213 KB of shared memory at P = 64, N = 128, chunk 128, so one
//      CTA an SM): the chunk's x, B, C and dt arrive by cp.async into a
//      ring of two stages, so chunk c + 1's loads overlap chunk c's
//      products.  Rows are padded by 16 bytes, so ldmatrix reads them
//      without bank conflicts.  The three products run on mma.sync
//      m16n8k16 with float32 accumulators:
//        y_intra = w x, w = CB o e^{cum_i - cum_j} o dt_j, causal: each warp
//          builds its 16-row block of w straight into A fragments from the
//          scratch and the chunk's cum and dt.  Building w, not its
//          product, was most of the pass's time on an H100 (PERF.md): so
//          the scratch is stored in fragment order and each warp fetches
//          its blocks from L2 at the top of the chunk, two 16-byte loads a
//          block; and off the diagonal the decay is a row factor times a
//          column factor, tables built once a chunk, so that only the
//          diagonal blocks take exponentials of their own;
//        e^{cum_i} C h_in, with h_in the state entering the chunk;
//        h_out = e^{total} h_in + (s o x)^T B, s_j = dt_j e^{total - cum_j}.
//      B, C and x are bf16 already; the float32 operand of each product
//      (w, h_in, s o x) is split into bf16 hi = bf16(a) and lo =
//      bf16(a - hi), and both are multiplied in: one rounding to bf16
//      would put outputs outside the card tolerance (atol 2e-4, rtol 1e-3;
//      tests/test_torch_ssd.py emulates both).  The state stays in the
//      accumulator registers of its mma fragments from chunk to chunk
//      (32 floats a thread at P = 64, N = 128); each chunk writes its hi
//      and lo halves to shared memory for C h_in.  Warp w owns rows 16 w ..
//      16 w + 15 of y and two 16 x 32 blocks of the state.  A split of the
//      chunks over CTAs (a chunk-state pass, a state-passing pass and an
//      output pass, as Mamba-2's reference kernels do) would fill the card
//      better than 256 CTAs on 132 SMs but moves the state through device
//      memory twice more; it is later work, to be taken only if measured to
//      win.
// 2. simt (float32; phase 8's float32 mamba2): one CTA of 256 threads per
//    (b, h); per chunk the x, B and C tiles sit in shared memory, B rows
//    padded by 4 elements; the state stays in shared memory in float32,
//    transposed to (N, P).  The Q x Q weights are built 32 rows at a time
//    (32 x Q float32), which keeps the tiles at Q = 128, P = 64, N = 128 at
//    217 KB.  The three products are float32 FMAs (TF32 would break the
//    float32 limits) with one operand broadcast from shared memory; a row
//    block skips the keys past its last row.
#include <stdint.h>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

// ---------------------------------------------------------------- simt

namespace simt {

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
    ssd_simt(const T* __restrict__ x, const float* __restrict__ dt,
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

}  // namespace simt

// ---------------------------------------------------------------- mma

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

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

// ssd_cb: C_c B_c^T of chunk c of batch row b, its causal 16 x 16 blocks
// (column block kt <= row block mt) only, one CTA per row block: rows
// 16 mt .. of C against rows 0 .. 16 (mt + 1) of B, warp w the column
// block w.  The scratch holds, per (b, c), the blocks at cb_block(mt, kt),
// each in the order of an mma.sync accumulator pair: lane l's 8 floats
// (its fragments of columns 0-7, then 8-15) at 8 l, so that the per-head
// pass reads lane l's A fragment of w in two coalesced 16-byte loads.
__host__ __device__ constexpr int cb_blocks(int q) { return (q / 16) * (q / 16 + 1) / 2; }
__device__ __forceinline__ int cb_block(int mt, int kt) { return mt * (mt + 1) / 2 + kt; }
template <int N, int Q>
struct CbLayout {
  static constexpr int LDN = N + 8;
  static constexpr size_t bytes = sizeof(bf16) * (Q + 16) * LDN;
};

template <int N, int Q>
__global__ void __launch_bounds__(kThreads)
    ssd_cb(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ cb,
           long long sBb, long long sBs, long long sCb, long long sCs, int S, int aligned) {
  constexpr int LDN = CbLayout<N, Q>::LDN;
  static_assert(Q / 16 <= kWarps, "a warp a column block");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* cs = bs + Q * LDN;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int mt = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = c * Q;
  const int qv = min(Q, S - s0);
  if (mt * 16 >= qv) return;  // rows past S: the per-head pass reads none
  load_rows(bs, LDN, Bm + b * sBb + s0 * sBs, sBs, 16 * (mt + 1), N, qv, aligned);
  load_rows(cs, LDN, Cm + b * sCb + (s0 + mt * 16) * sCs, sCs, 16, N, qv - mt * 16, aligned);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  const int np = warp;  // 16 columns j
  if (np > mt) return;
  float acc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < N; kk += 16) {
    uint32_t a[4], bb[4];
    mma::ldsm_x4(a, cs + mma::a_rowmajor_row(lane) * LDN + kk + mma::a_rowmajor_col(lane));
    mma::ldsm_x4(bb, bs + (np * 16 + mma::b_nmajor_row(lane)) * LDN + kk +
                         mma::b_nmajor_col(lane));
    mma::mma_bf16(acc[0], a, bb[0], bb[1]);
    mma::mma_bf16(acc[1], a, bb[2], bb[3]);
  }
  float* out = cb + ((static_cast<size_t>(b) * gridDim.x + c) * cb_blocks(Q) +
                     cb_block(mt, np)) * 256 + lane * 8;
  *reinterpret_cast<float4*>(out) = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  *reinterpret_cast<float4*>(out + 4) = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
}

// ssd_mma's shared memory: two stages of {x [Q][P + 8], B [Q][N + 8],
// C [Q][N + 8] bf16, dt [Q] float32}, the entering state's hi and lo halves
// [P][N + 8] bf16, cum, s (dt e^{total - cum}) and the column factors
// [Q] float32, and the row factors [Q][Q / 16] float32.
template <int P, int N, int Q>
struct Layout {
  static constexpr int LDX = P + 8;
  static constexpr int LDN = N + 8;
  static constexpr size_t x_off = 0;
  static constexpr size_t b_off = x_off + sizeof(bf16) * Q * LDX;
  static constexpr size_t c_off = b_off + sizeof(bf16) * Q * LDN;
  static constexpr size_t dt_off = c_off + sizeof(bf16) * Q * LDN;
  static constexpr size_t stage = align16(dt_off + sizeof(float) * Q);
  static constexpr size_t h_off = 2 * stage;
  static constexpr size_t v_off = h_off + 2 * sizeof(bf16) * P * LDN;
  static constexpr size_t bytes = v_off + 3 * sizeof(float) * Q + sizeof(float) * Q * (Q / 16);
};

template <int P, int N, int Q>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, const float* __restrict__ cb,
            const float* __restrict__ h0, bf16* __restrict__ y, float* __restrict__ h_out,
            long long sBb, long long sBs, long long sCb, long long sCs, int S, int H,
            int aligned) {
  using Lay = Layout<P, N, Q>;
  constexpr int LDX = Lay::LDX, LDN = Lay::LDN;
  constexpr int MT_S = P / 16;                  // state row blocks
  constexpr int UNITS = MT_S * (N / 32);        // 16 x 32 state blocks
  constexpr int SU = (UNITS + kWarps - 1) / kWarps;  // blocks a warp
  constexpr int NY = P / 8;                     // n8 fragments of a y row block
  constexpr int MT_Y = Q / 16;                  // y row blocks, one a warp
  static_assert(Lay::bytes <= 232448, "shared memory");
  static_assert(Q / 16 <= kWarps && kWarps % MT_S == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* h_hi = reinterpret_cast<bf16*>(smem + Lay::h_off);
  bf16* h_lo = h_hi + P * LDN;
  float* cum = reinterpret_cast<float*>(smem + Lay::v_off);
  float* sv = cum + Q;
  float* colf = sv + Q;     // e^{cum_e - cum_j} dt_j, e the last row of j's block
  float* rowf = colf + Q;   // [i][kt]: e^{cum_i - cum_e}, e the last row of block kt

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a_h = A[h];
  const size_t state_base = (static_cast<size_t>(b) * H + h) * P * N;
  const long long row0 = static_cast<long long>(b) * S;  // first position of x, dt, y
  const int n_chunks = (S + Q - 1) / Q;
  const int m_s = warp % MT_S;  // this warp's state row block

  auto stage_ptr = [&](int c, size_t off) { return smem + (c & 1) * Lay::stage + off; };
  auto load_chunk = [&](int c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    load_rows(reinterpret_cast<bf16*>(stage_ptr(c, Lay::x_off)), LDX,
              x + ((row0 + s0) * H + h) * P, static_cast<long long>(H) * P, Q, P, qv, aligned);
    load_rows(reinterpret_cast<bf16*>(stage_ptr(c, Lay::b_off)), LDN, Bm + b * sBb + s0 * sBs,
              sBs, Q, N, qv, aligned);
    load_rows(reinterpret_cast<bf16*>(stage_ptr(c, Lay::c_off)), LDN, Cm + b * sCb + s0 * sCs,
              sCs, Q, N, qv, aligned);
    float* dts = reinterpret_cast<float*>(stage_ptr(c, Lay::dt_off));
    for (int j = tid; j < Q; j += kThreads) {
      const bool ok = j < qv;
      mma::cp_async4(dts + j, dt + (row0 + s0 + (ok ? j : 0)) * H + h, ok);
    }
  };

  // The state: block u = warp + 8 t is rows 16 (u % MT_S) .., columns
  // 32 (u / MT_S) ..; st[t][nt] its n8 fragment nt.
  float st[SU][4][4];
#pragma unroll
  for (int t = 0; t < SU; ++t)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = warp + kWarps * t;
        const int p = m_s * 16 + gq + 8 * (e >> 1);
        const int n = (u / MT_S) * 32 + nt * 8 + 2 * cq + (e & 1);
        st[t][nt][e] = h0 != nullptr && u < UNITS ? h0[state_base + p * N + n] : 0.f;
      }

  load_chunk(0);
  mma::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    mma::cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c - 1 is consumed
    if (c + 1 < n_chunks) load_chunk(c + 1);
    mma::cp_async_commit();
    const bf16* xs = reinterpret_cast<const bf16*>(stage_ptr(c, Lay::x_off));
    const bf16* bs = reinterpret_cast<const bf16*>(stage_ptr(c, Lay::b_off));
    const bf16* cs = reinterpret_cast<const bf16*>(stage_ptr(c, Lay::c_off));
    const float* dts = reinterpret_cast<const float*>(stage_ptr(c, Lay::dt_off));

    // This warp's blocks of C·Bᵀ (column blocks kt <= mt, from L2), fetched
    // now so that the scan and the inter-chunk product hide their latency:
    // cbv[kt][0] holds columns 2 cq, 2 cq + 1 of rows i0 + gq and i0 + gq +
    // 8, cbv[kt][1] the same at columns + 8 (the ssd_cb order).
    const int mt = warp;
    const int i0 = mt * 16;
    float4 cbv[MT_Y][2];
    if (i0 < qv) {
      const float* cbc = cb + ((static_cast<size_t>(b) * n_chunks + c) * cb_blocks(Q) +
                               cb_block(mt, 0)) * 256 + lane * 8;
#pragma unroll
      for (int kt = 0; kt < MT_Y; ++kt)
        if (kt <= mt) {
          cbv[kt][0] = *reinterpret_cast<const float4*>(cbc + kt * 256);
          cbv[kt][1] = *reinterpret_cast<const float4*>(cbc + kt * 256 + 4);
        }
    }

    // cum (inclusive sum of dt A) and s = dt e^{total - cum}, by warp 0,
    // Q / 32 consecutive rows a lane; the entering state's halves, by all.
    if (warp == 0) {
      constexpr int E = Q / 32;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += dts[lane * E + e] * a_h;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float total = __shfl_sync(0xffffffffu, incl, 31);  // rows past qv add 0
#pragma unroll
      for (int e = 0; e < E; ++e) {
        cum[lane * E + e] = v[e] + excl;
        sv[lane * E + e] = dts[lane * E + e] * expf(total - (v[e] + excl));
      }
    }
#pragma unroll
    for (int t = 0; t < SU; ++t) {
      const int u = warp + kWarps * t;
      if (u >= UNITS) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (m_s * 16 + gq + 8 * hh) * LDN + (u / MT_S) * 32 + nt * 8 + 2 * cq;
          uint32_t hi, lo;
          mma::split2(st[t][nt][2 * hh], st[t][nt][2 * hh + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(h_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(h_lo + off) = lo;
        }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    // The decay from column j to row i > j's block splits at the last row e
    // of j's block: e^{cum_i - cum_j} = e^{cum_i - cum_e} e^{cum_e - cum_j},
    // both factors at most 1, so only the diagonal blocks take their own
    // exponentials.
    for (int j = tid; j < Q; j += kThreads) colf[j] = expf(cum[j | 15] - cum[j]) * dts[j];
    for (int idx = tid; idx < Q * (Q / 16); idx += kThreads) {
      const int i = idx / (Q / 16), kt = idx % (Q / 16);
      rowf[idx] = kt < i / 16 ? expf(cum[i] - cum[kt * 16 + 15]) : 0.f;
    }
    __syncthreads();

    // y, rows i0 .. i0 + 15 of this warp: e^{cum_i} C_i h_in + sum_j w_ij x_j.
    if (i0 < qv) {
      float acc[NY][4];
#pragma unroll
      for (int n = 0; n < NY; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N; kk += 16) {
        uint32_t a[4];
        mma::ldsm_x4(a, cs + (i0 + mma::a_rowmajor_row(lane)) * LDN + kk +
                            mma::a_rowmajor_col(lane));
#pragma unroll
        for (int n = 0; n < NY; n += 2) {
          const int off = (n * 8 + mma::b_nmajor_row(lane)) * LDN + kk + mma::b_nmajor_col(lane);
          uint32_t bh[4], bl[4];
          mma::ldsm_x4(bh, h_hi + off);
          mma::ldsm_x4(bl, h_lo + off);
          mma::mma_bf16(acc[n], a, bh[0], bh[1]);
          mma::mma_bf16(acc[n], a, bl[0], bl[1]);
          mma::mma_bf16(acc[n + 1], a, bh[2], bh[3]);
          mma::mma_bf16(acc[n + 1], a, bl[2], bl[3]);
        }
      }
      const float cum_r[2] = {cum[i0 + gq], cum[i0 + gq + 8]};
      const float e0 = expf(cum_r[0]), e1 = expf(cum_r[1]);
#pragma unroll
      for (int n = 0; n < NY; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
#pragma unroll
      for (int kt = 0; kt < MT_Y; ++kt) {
        if (kt > mt) break;
        // w at (row i0 + gq + 8 (e & 1), columns j, j + 1), j = 16 kt + 2 cq
        // + 8 (e >> 1): the A fragment's register e.
        uint32_t whi[4], wlo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gq + 8 * (e & 1);
          const int j = kt * 16 + 2 * cq + 8 * (e >> 1);
          const float4 v = cbv[kt][e >> 1];
          const float c0 = e & 1 ? v.z : v.x, c1 = e & 1 ? v.w : v.y;
          float w0, w1;
          if (kt < mt) {
            const float r = rowf[i * MT_Y + kt];
            w0 = c0 * r * colf[j];
            w1 = c1 * r * colf[j + 1];
          } else {
            const float ci = cum_r[e & 1];
            w0 = j <= i ? c0 * expf(ci - cum[j]) * dts[j] : 0.f;
            w1 = j + 1 <= i ? c1 * expf(ci - cum[j + 1]) * dts[j + 1] : 0.f;
          }
          mma::split2(w0, w1, whi[e], wlo[e]);
        }
#pragma unroll
        for (int n = 0; n < NY; n += 2) {
          uint32_t bx[4];
          mma::ldsm_x4_t(bx, xs + (kt * 16 + mma::b_kmajor_row(lane)) * LDX + n * 8 +
                                 mma::b_kmajor_col(lane));
          mma::mma_bf16(acc[n], whi, bx[0], bx[1]);
          mma::mma_bf16(acc[n], wlo, bx[0], bx[1]);
          mma::mma_bf16(acc[n + 1], whi, bx[2], bx[3]);
          mma::mma_bf16(acc[n + 1], wlo, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + gq + 8 * hh;
        if (i >= qv) continue;
        bf16* yr = y + ((row0 + s0 + i) * H + h) * P + 2 * cq;
#pragma unroll
        for (int n = 0; n < NY; ++n)
          *reinterpret_cast<__nv_bfloat162*>(yr + n * 8) =
              __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
      }
    }

    // h_out = e^{total} h_in + (s o x)^T B over the chunk's valid rows.
    if (warp < UNITS) {
      const float decay = expf(total);
#pragma unroll
      for (int t = 0; t < SU; ++t)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[t][nt][e] *= decay;
      const int k_steps = (qv + 15) / 16;
#pragma unroll
      for (int kt = 0; kt < Q / 16; ++kt) {
        if (kt >= k_steps) break;
        const int j0 = kt * 16;
        uint32_t ax[4], ahi[4], alo[4];
        mma::ldsm_x4_t(ax, xs + (j0 + mma::a_kmajor_row(lane)) * LDX + m_s * 16 +
                               mma::a_kmajor_col(lane));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 2 * cq + 8 * (e >> 1);
          const float2 xv = mma::unpack_bf16(ax[e]);
          mma::split2(xv.x * sv[j], xv.y * sv[j + 1], ahi[e], alo[e]);
        }
#pragma unroll
        for (int t = 0; t < SU; ++t) {
          const int u = warp + kWarps * t;
          if (u >= UNITS) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            mma::ldsm_x4_t(bb, bs + (j0 + mma::b_kmajor_row(lane)) * LDN + (u / MT_S) * 32 +
                                   np * 16 + mma::b_kmajor_col(lane));
            mma::mma_bf16(st[t][2 * np], ahi, bb[0], bb[1]);
            mma::mma_bf16(st[t][2 * np], alo, bb[0], bb[1]);
            mma::mma_bf16(st[t][2 * np + 1], ahi, bb[2], bb[3]);
            mma::mma_bf16(st[t][2 * np + 1], alo, bb[2], bb[3]);
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int t = 0; t < SU; ++t) {
    const int u = warp + kWarps * t;
    if (u >= UNITS) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = m_s * 16 + gq + 8 * hh;
        const int n = (u / MT_S) * 32 + nt * 8 + 2 * cq;
        *reinterpret_cast<float2*>(h_out + state_base + p * N + n) =
            make_float2(st[t][nt][2 * hh], st[t][nt][2 * hh + 1]);
      }
  }
}

}  // namespace tc

struct Args {
  const void* x;
  const void* dt;
  const void* A;
  const void* Bm;
  const void* Cm;
  const void* h0;
  void* y;
  void* h_out;
  void* cb;
  long long sBb, sBs, sCb, sCs;
  int B, S, H, aligned;
  cudaEvent_t mid;
};

template <int P, int N, int Q>
int launch_simt(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = simt::Layout<float, P, N, Q>::bytes;
  auto kernel = simt::ssd_simt<float, P, N, Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.mid != nullptr && (err = cudaEventRecord(a.mid, stream)) != cudaSuccess) return (int)err;
  kernel<<<dim3(a.H, a.B), simt::kThreads, smem, stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.Bm),
      static_cast<const float*>(a.Cm), static_cast<const float*>(a.h0),
      static_cast<float*>(a.y), static_cast<float*>(a.h_out), a.sBb, a.sBs, a.sCb, a.sCs, a.S,
      a.H);
  return (int)cudaGetLastError();
}

template <int P, int N, int Q>
int launch_mma(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t cb_smem = tc::CbLayout<N, Q>::bytes;
  constexpr size_t smem = tc::Layout<P, N, Q>::bytes;
  auto cb_kernel = tc::ssd_cb<N, Q>;
  auto kernel = tc::ssd_mma<P, N, Q>;
  cudaError_t err =
      cudaFuncSetAttribute(cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (a.S + Q - 1) / Q;
  cb_kernel<<<dim3(n_chunks, a.B, Q / 16), tc::kThreads, cb_smem, stream>>>(
      static_cast<const bf16*>(a.Bm), static_cast<const bf16*>(a.Cm), static_cast<float*>(a.cb),
      a.sBb, a.sBs, a.sCb, a.sCs, a.S, a.aligned);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.mid != nullptr && (err = cudaEventRecord(a.mid, stream)) != cudaSuccess) return (int)err;
  kernel<<<dim3(a.H, a.B), tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const bf16*>(a.Bm),
      static_cast<const bf16*>(a.Cm), static_cast<const float*>(a.cb),
      static_cast<const float*>(a.h0), static_cast<bf16*>(a.y), static_cast<float*>(a.h_out),
      a.sBb, a.sBs, a.sCb, a.sCs, a.S, a.H, a.aligned);
  return (int)cudaGetLastError();
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
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32: return by_state<kMma, 32>(a, N, Q, st);
    case 64: return by_state<kMma, 64>(a, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H) float32, A (H,) float32, h0 (B, H, P, N)
// float32 or null (zeros), y (B, S, H, P), h_out (B, H, P, N) float32, all
// contiguous; Bm and Cm (B, S, N) with element strides (sBb, sBs) and
// (sCb, sCs) and unit stride along N.  x, Bm, Cm and y share the type.
// `mid`, a cudaEvent_t or null, is recorded before the per-head pass (for
// bf16, after the C B^T pass).  Returns the CUDA error code of the launches
// (0 on success).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* h_out, long long sBb,
                            long long sBs, long long sCb, long long sCs, int B, int S, int H,
                            int P, int N, int Q, void* mid, void* stream) {
  const Args a{x, dt, A, Bm, Cm, h0, y, h_out, nullptr, sBb, sBs, sCb, sCs, B, S, H, 0,
               static_cast<cudaEvent_t>(mid)};
  return dispatch<false>(a, P, N, Q, stream);
}

// As ssd_scan_f32, in bf16, with `cb` a float32 scratch of B * n_chunks *
// cb_blocks(Q) * 256 floats (n_chunks = ceil(S / Q)) and `aligned` nonzero
// when x, Bm and
// Cm start 16-byte aligned and sBb, sBs, sCb, sCs are multiples of 8 (their
// rows are then copied 16 bytes at a time).
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* h0, void* y, void* h_out, void* cb,
                             long long sBb, long long sBs, long long sCb, long long sCs, int B,
                             int S, int H, int P, int N, int Q, int aligned, void* mid,
                             void* stream) {
  const Args a{x, dt, A, Bm, Cm, h0, y, h_out, cb, sBb, sBs, sCb, sCs, B, S, H, aligned,
               static_cast<cudaEvent_t>(mid)};
  return dispatch<true>(a, P, N, Q, stream);
}
