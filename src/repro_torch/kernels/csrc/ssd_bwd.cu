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
// and from chunk to chunk h_in_{c+1} = e^{total_c} h_in_c + S_c with S_c =
// sum_j s_j x_j B_j^T, and backwards G_{c-1} = e^{total_c} G_c + T_c with
// T_c = sum_i e^{cum_i} dy_i C_i^T.  <G, h_out> = e^{total} <G, h_in> +
// sum_j s_j r_j.  ssd.py:ssd_scan_backward_plain holds the formulas in plain
// torch; ssd.py:ssd_scan_backward_phases holds the split's phases (chunk
// states, pass, grads, finish; the walk fuses the first two).
//
// Bound on an H100 SXM at mamba2-1.3b's training call (B 2, S 4096, H 64,
// P 64, N 128, chunk 128, bf16): x, dy and dx 67 MB each, dt and d(dt) 2 MB
// each, B, C, dB and dC 2 MB each: 211 MB, 63 us at 3.35 TB/s; some 62 GFLOP
// of block products, 63 us at the 989 TFLOP/s of bf16 tensor cores.
//
// The bf16 variant (mma): the chunk-parallel split of Mamba-2's own
// backward, in three launches.
//   1. walk (grid H x B x 2, two CTAs an SM, mma.sync m16n8k16): per (b, h),
//      the forward walk over the chunks keeps the (P, N) state in
//      registers, writes the state entering each chunk, h_in_c, and adds
//      the chunk's (s o x)^T B on the tensor cores; the backward walk does
//      the same for G_c from (e^{cum} o dy)^T C.  Each state goes out as
//      bf16 hi and lo planes (134 MB each at the training shape), staged in
//      shared memory and written whole lines at a time; the next chunk's
//      tiles arrive by cp.async during the current one.  No chunk states
//      round trip through device memory before the walk.
//   2. grads (wgmma): every chunk-local gradient from h_in and G, in
//      parallel over (b, chunk, slice of 64 positions), each CTA walking
//      the heads in order with dB and dC of its rows in registers across
//      them: the heads' sum is taken on chip in a fixed order, with no
//      partials and no atomics.  Two warpgroups, each the m64 tile of the
//      slice's rows over its half of the state's columns.  A operands from
//      shared memory (x, dy, B and C rows) or from registers (M and W,
//      built from the accumulators of x dy^T and the CTA's C B^T, formed
//      once for all heads); B operands from 128-byte-swizzled shared tiles
//      (G, h_in, C, B and dy rows as MN-major, dy and x rows as K-major).
//      dx's strip alternates its k16 steps between the warpgroups (its G
//      term splits by state column); the two partials meet in shared memory
//      once a head.  The next head's G and h_in planes, x, dy and dt arrive
//      by cp.async during the strips (B and C may be strided views of any
//      alignment, which TMA does not take).
//   3. finish (H CTAs): per head, over the batch and the chunks in order,
//      d(total), the suffix sums inside each chunk, d(dt) and dA.
// Every float32 operand of a product (M, W, G, h_in, s o x, e^{cum} o dy)
// is split into bf16 hi = bf16(a) and lo = bf16(a - hi), both multiplied
// in with float32 accumulators: one rounding to bf16 costs some 8 bits of
// each product and leaves the limit.
//
// What holds it (PERF.md section 6): at mamba2-1.3b's training call the
// grads launch takes some 0.9 ms of the call's 1.15, against a 0.07 ms
// bound for the whole call.  Building each pair of k16 steps' weights while
// the previous pair's products run did not shorten it, and the same split
// on mma.sync took 0.83 ms: neither the products' rate nor their latency
// holds it.  Not measured apart: every CTA reads a head's G and h_in planes
// (64 KB, once for each slice of the chunk) and its x and dy (32 KB), some
// 0.8 GB a call; four block barriers a head with one CTA an SM; the
// weights' elementwise work on the warps that issue the products.
//
// The float32 variant (simt), float32 FMAs (TF32 would break the float32
// limits): one CTA of eight warps per (b, h) walks the chunks forward,
// writing the state entering each to a float32 scratch, then backwards with
// G in shared memory, x, dy, G and h_in in shared memory, B and C read
// through L1, the chunk's weights built 32 rows at a time; dB and dC go out
// as float32 per-head partials (B, H, S, N) and dA's as one float per (b,
// h), which a second launch sums over the heads (and dA over the batch) in
// a fixed order.  No atomics in either variant: a call repeats bit for bit.
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;  // finish: one warp a (b, chunk) at a time

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

// The per-position parts of d(cum) and d(dt) that need no other chunk's rows
// (ssd.py:bwd_chunk_grads_plain), at `at` of the (B, H, S) outputs.
__device__ __forceinline__ void store_rows(float* dcump, float* ddtp, float* srp, size_t at,
                                           float dt, float sv, float etot, float colz,
                                           float rowz, float u, float r) {
  dcump[at] = rowz - dt * colz + u - sv * r;
  ddtp[at] = colz + etot * r;
  srp[at] = sv * r;
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
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;
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

// ---------------------------------------------------------------- finish

// grid (H): per head, warp w takes the (b, chunk) pairs w, w + 32, ... in
// order, lane l the rows l E .. l E + E - 1 of the chunk: d(total) =
// e^{total} <G, h_in> + sum_k s_k r_k (<G, h_in> as `parts` partial dots
// (B, H, chunks, parts), summed in order), da_t = sum_{k >= t} dcum_k +
// d(total), d(dt) = A da + ddt_part, and dA = sum dt da, summed warp by warp
// in order.
template <int Q>
__global__ void __launch_bounds__(kFinishThreads)
    ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ dcump, const float* __restrict__ ddtp,
                   const float* __restrict__ srp, const float* __restrict__ dot,
                   const float* __restrict__ edec, float* __restrict__ ddt,
                   float* __restrict__ dA, int B, int S, int H, int parts) {
  constexpr int E = Q / 32;
  constexpr int W = kFinishThreads / 32;
  __shared__ float red[W];
  const int h = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (S + Q - 1) / Q;
  const float a_h = A[h];
  float da_acc = 0.f;
  for (int bc = warp; bc < B * nc; bc += W) {
    const int b = bc / nc, c = bc % nc;
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);
    const size_t base = (static_cast<size_t>(b) * S + s0) * H + h;  // in (B, S, H)
    const size_t rows = (static_cast<size_t>(b) * H + h) * S + s0;    // in (B, H, S)
    float part[E];
    float srs = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;
      part[e] = k < qv ? dcump[rows + k] : 0.f;
      srs += k < qv ? srp[rows + k] : 0.f;
    }
    srs = attn::warp_sum(srs);
    const size_t bhc = (static_cast<size_t>(b) * H + h) * nc + c;
    float gh = 0.f;
    for (int q = 0; q < parts; ++q) gh += dot[bhc * parts + q];
    const float dtotal = edec[bhc] * gh + srs;
    float suf[E];
    float run = 0.f;
#pragma unroll
    for (int e = E - 1; e >= 0; --e) {
      run += part[e];
      suf[e] = run;
    }
    float incl = run;  // this lane's rows and every later lane's
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
      if (k < qv) {
        const size_t at = base + static_cast<size_t>(k) * H;
        const float da = suf[e] + later + dtotal;
        ddt[at] = a_h * da + ddtp[rows + k];
        da_acc += dt[at] * da;
      }
    }
  }
  da_acc = attn::warp_sum(da_acc);
  if (lane == 0) red[warp] = da_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += red[w];
    dA[h] = s;
  }
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
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
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

// Sums over the four lanes of a quad (the lanes holding one fragment row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- walk

// A CTA walks one (b, h) over its chunks in one direction, the state (P x
// N float32) in registers.  Shared memory: the chunk's A and Bt tiles (x
// and B forward, dy and C backward) [2][Q][P + 8] and [2][Q][N + 8] bf16,
// dt [2][Q] (this chunk's and the next's), and the vectors.
template <int P, int N, int Q>
struct WalkLayout {
  static constexpr int LDX = P + 8;
  static constexpr int LDN = N + 8;
  static constexpr size_t a_off = 0;
  static constexpr size_t b_off = a_off + 2 * sizeof(bf16) * Q * LDX;
  static constexpr size_t dt_off = b_off + 2 * sizeof(bf16) * Q * LDN;
  static constexpr size_t v_off = dt_off + 2 * sizeof(float) * Q;
  static constexpr size_t bytes = v_off + sizeof(float) * kVecs * Q;
};

// Q values of dt (positions s0 .., head h; rows past `qv` 0) into `dts` by
// 4-byte cp.async in the current commit group.
__device__ __forceinline__ void load_dt(float* dts, const float* dt, long long at, int H, int Q,
                                        int qv) {
  for (int j = threadIdx.x; j < Q; j += blockDim.x) {
    if (j < qv)
      mma::cp_async4(dts + j, dt + at + static_cast<long long>(j) * H, true);
    else
      dts[j] = 0.f;
  }
}

// grid (H, B, 2), blockIdx.z the direction, eight warps, two CTAs an SM.
// Forward: the state entering each chunk, h_in_c, then h_in_{c+1} =
// e^{total_c} h_in_c + (s o x)^T B; backward: the gradient leaving each
// chunk, G_c, then G_{c-1} = e^{total_c} G_c + (e^{cum} o dy)^T C.  Warp w
// owns the 16 x 32 blocks w and w + 8 of the state; the state is decayed
// and the chunk's product (the scaled A split into bf16 hi + lo) added into
// it on the tensor cores.  Each h_in_c or G_c is written as the grads
// launch reads it: a (P, N) plane of bf16 hi halves, then one of lo halves;
// where the two planes fit the chunk's B tile they are staged there after
// its product and written whole lines at a time (scattered 4-byte stores
// from the fragments cost more than the walk's arithmetic).  The forward
// CTAs write e^{total_c}.
template <int P, int N, int Q>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_walk_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                     float* __restrict__ hst, float* __restrict__ gst, float* __restrict__ edec,
                     long long sBb, long long sBs, long long sCb, long long sCs, int S, int H,
                     int aligned) {
  using Lay = WalkLayout<P, N, Q>;
  constexpr int LDX = Lay::LDX, LDN = Lay::LDN;
  constexpr int MT_S = P / 16;
  constexpr int UNITS = MT_S * (N / 32);
  constexpr int kU = (UNITS + kWarps - 1) / kWarps;
  static_assert(P % 16 == 0 && N % 32 == 0, "tile shape");
  static_assert(kWarps % MT_S == 0, "a warp's blocks share their rows");
  static_assert(2 * Lay::bytes <= 232448, "two CTAs an SM");
  // The state's two bf16 planes fit a chunk's B tile (staged there after the
  // chunk's product), with rows of at least eight 16-byte chunks.
  constexpr bool kStage = 4 * P * N <= 2 * Q * LDN && N >= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* abuf = reinterpret_cast<bf16*>(smem + Lay::a_off);
  bf16* bbuf = reinterpret_cast<bf16*>(smem + Lay::b_off);
  float* dtbuf = reinterpret_cast<float*>(smem + Lay::dt_off);
  float* v = reinterpret_cast<float*>(smem + Lay::v_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const bool back = blockIdx.z == 1;
  const int nc = (S + Q - 1) / Q;
  const long long row0 = static_cast<long long>(b) * S;
  const long long sX = static_cast<long long>(H) * P;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const bf16* a_src = back ? dy : x;
  const bf16* b_src = back ? Cm + b * sCb : Bm + b * sBb;
  const long long sb = back ? sCs : sBs;
  float* out = back ? gst : hst;
  const float* scale = v + (back ? kEcum : kSv) * Q;
  const float a_h = A[h];

  auto prefetch = [&](int c, int buf) {
    const int s0 = c * Q, qv = min(Q, S - s0);
    load_rows(abuf + buf * Q * LDX, LDX, a_src + ((row0 + s0) * H + h) * P, sX, Q, P, qv,
              aligned);
    load_rows(bbuf + buf * Q * LDN, LDN, b_src + s0 * sb, sb, Q, N, qv, aligned);
    load_dt(dtbuf + buf * Q, dt, (row0 + s0) * H + h, H, Q, qv);
  };
  float st[kU][4][4] = {};  // the state, warp w's blocks w, w + 8
  // The state as a (P, N) plane of bf16 hi halves, then one of lo halves.
  // Staged (kStage) in shared memory, the 16-byte chunks of a row rotated by
  // the row (no bank conflicts), then copied out 16 bytes a thread, whole
  // lines a warp; else stored from the fragments, two columns a thread.
  auto stage = [&](char* sm) {
#pragma unroll
    for (int vv = 0; vv < kU; ++vv) {
      const int u = warp + vv * kWarps;
      if (u >= UNITS) continue;
      const int m0 = (u % MT_S) * 16, n0 = (u / MT_S) * 32;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + gq + 8 * hh, col = n0 + nt * 8 + 2 * cq;
          uint32_t hi, lo;
          mma::split2(st[vv][nt][2 * hh], st[vv][nt][2 * hh + 1], hi, lo);
          const int at = row * N * 2 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
          *reinterpret_cast<uint32_t*>(sm + at) = hi;
          *reinterpret_cast<uint32_t*>(sm + P * N * 2 + at) = lo;
        }
    }
  };
  auto copy_out = [&](char* o, const char* sm) {
    for (int i = tid; i < P * N / 4; i += kThreads) {  // 16-byte chunks of both planes
      const int z = i / (P * N / 8), w = i % (P * N / 8);
      const int row = w / (N / 8), ch = w % (N / 8);
      const uint4 val = *reinterpret_cast<const uint4*>(
          sm + z * P * N * 2 + row * N * 2 + ((ch ^ (row & 7)) << 4));
      *reinterpret_cast<uint4*>(o + 16 * i) = val;
    }
  };
  auto store_direct = [&](char* o) {
    bf16* o_hi = reinterpret_cast<bf16*>(o);
    bf16* o_lo = o_hi + P * N;
#pragma unroll
    for (int vv = 0; vv < kU; ++vv) {
      const int u = warp + vv * kWarps;
      if (u >= UNITS) continue;
      const int m0 = (u % MT_S) * 16, n0 = (u / MT_S) * 32;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = (m0 + gq + 8 * hh) * N + n0 + nt * 8 + 2 * cq;
          uint32_t hi, lo;
          mma::split2(st[vv][nt][2 * hh], st[vv][nt][2 * hh + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(o_hi + e) = hi;
          *reinterpret_cast<uint32_t*>(o_lo + e) = lo;
        }
    }
  };
  {  // the walk's first chunk: a zero state
    uint4* o = reinterpret_cast<uint4*>(out + (bh * nc + (back ? nc - 1 : 0)) * P * N);
    for (int i = tid; i < P * N / 4; i += kThreads) o[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  prefetch(back ? nc - 1 : 0, 0);
  mma::cp_async_commit();

  for (int k = 0; k < nc; ++k) {
    const int c = back ? nc - 1 - k : k;
    const int buf = k & 1;
    const int s0 = c * Q, qv = min(Q, S - s0);
    mma::cp_async_wait<0>();
    __syncthreads();  // this chunk's tiles have landed; the last chunk's are free
    if (k + 1 < nc) prefetch(back ? c - 1 : c + 1, buf ^ 1);
    mma::cp_async_commit();
    if (warp == 0) {
      for (int j = lane; j < Q; j += 32) v[kDt * Q + j] = dtbuf[buf * Q + j];
      __syncwarp();
      scan_chunk<Q>(v, a_h, lane);
    }
    __syncthreads();  // the vectors are ready
    if (!back && tid == 0) edec[bh * nc + c] = expf(v[kCum * Q + Q - 1]);
    // The state decays across the chunk, then takes the chunk's product in
    // place (no second set of accumulators).
    const float decay = expf(v[kCum * Q + Q - 1]);
#pragma unroll
    for (int vv = 0; vv < kU; ++vv)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[vv][nt][e] *= decay;
    const bf16* a_tile = abuf + buf * Q * LDX;
    const bf16* b_tile = bbuf + buf * Q * LDN;
    // Every k-step, unrolled (rows past the chunk's end are zero): the
    // compiler overlaps a step's loads and splits with the last one's mma.
    // A warp's blocks share their rows (m0), so a k-step's scaled A rows
    // are split once for all of them.
#pragma unroll
    for (int kt = 0; kt < Q / 16; ++kt) {
      const int j0 = kt * 16;
      const int m0 = (warp % MT_S) * 16;
      if (warp >= UNITS) break;
      uint32_t ax[4], ahi[4], alo[4];
      mma::ldsm_x4_t(ax, a_tile + (j0 + mma::a_kmajor_row(lane)) * LDX + m0 +
                             mma::a_kmajor_col(lane));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 2 * cq + 8 * (e >> 1);
        const float2 av = mma::unpack_bf16(ax[e]);
        mma::split2(av.x * scale[j], av.y * scale[j + 1], ahi[e], alo[e]);
      }
#pragma unroll
      for (int vv = 0; vv < kU; ++vv) {
        const int u = warp + vv * kWarps;
        if (u >= UNITS) continue;
        const int n0 = (u / MT_S) * 32;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          mma::ldsm_x4_t(bb, b_tile + (j0 + mma::b_kmajor_row(lane)) * LDN + n0 + np * 16 +
                                 mma::b_kmajor_col(lane));
          mma::mma_bf16(st[vv][2 * np], ahi, bb[0], bb[1]);
          mma::mma_bf16(st[vv][2 * np + 1], ahi, bb[2], bb[3]);
          mma::mma_bf16(st[vv][2 * np], alo, bb[0], bb[1]);
          mma::mma_bf16(st[vv][2 * np + 1], alo, bb[2], bb[3]);
        }
      }
    }
    if (k + 1 < nc) {  // the state entering (leaving) the next chunk of the walk
      const int cn = back ? c - 1 : c + 1;
      char* o = reinterpret_cast<char*>(out + (bh * nc + cn) * P * N);
      if (kStage) {
        __syncthreads();  // the chunk's tiles are free
        stage(reinterpret_cast<char*>(bbuf + buf * Q * LDN));
        __syncthreads();
        copy_out(o, reinterpret_cast<const char*>(bbuf + buf * Q * LDN));
      } else {
        store_direct(o);
      }
    }
  }
}

// ---- grads

// A CTA owns R = min(chunk, 64) positions [r0, r0 + R) of a chunk and two
// warpgroups: warpgroup g is the m64 tile of those rows (rows past R or the
// chunk's end are zero) over box g of the state's columns.  Tiles of bf16
// are boxes of 64 columns, 128-byte swizzled (the 16-byte chunk c of row r
// at chunk c ^ (r % 8)), 64 rows or more: x and dy [QT][P] in one box; B,
// C, G and h_in [.][N] in two, column n in box n / (N / 2) (columns past
// N / 2 of a box are zero).  Shared memory: B rows [0, r0 + 64) then C
// rows [r0, QT), each in two boxes; x and dy of this head and the next;
// G's and h_in's hi and lo planes (64 rows, two boxes each); C B^T, float
// [QT][LDJ]: rows [0, QT - r0) C_i . B_j as [i - r0][j - r0] (j in the
// slice), then rows [QT - r0, QT) as [QT - r0 + j][i - r0] (j before it);
// dt of this head and the next; the vectors; the per-row parts (colz,
// rowz, and r and u by warpgroup); a reduction scratch.  After a head's
// strips its x and dy tiles take dx's exchange.
template <int P, int N, int Q>
struct GradsLayout {
  static constexpr int R = Q < 64 ? Q : 64;
  static constexpr int QT = Q < 64 ? 64 : Q;  // tile rows: an m64 tile past a short chunk
  static constexpr int NB = N / 2;            // the state columns of a box
  static constexpr int LDJ = 68;              // C B^T rows, padded against bank conflicts
  static constexpr int BOX = 64 * 128;        // a G or h_in plane's box
  static constexpr size_t bc_off = 0;
  static constexpr size_t xdy_off = bc_off + size_t(QT + 64) * 256;
  static constexpr size_t gh_off = xdy_off + size_t(4) * QT * 128;
  static constexpr size_t cb_off = gh_off + size_t(8) * BOX;
  static constexpr size_t dt_off = cb_off + sizeof(float) * QT * LDJ;
  static constexpr size_t v_off = dt_off + 2 * sizeof(float) * Q;
  static constexpr size_t parts_off = v_off + sizeof(float) * 5 * Q;
  static constexpr size_t red_off = parts_off + sizeof(float) * 6 * 64;
  static constexpr size_t bytes = red_off + sizeof(float) * kWarps;
  static constexpr size_t launch_bytes = bytes + 1024;  // room to align the tiles
  static_assert(2 * QT * 128 >= 64 * 64 * sizeof(float), "dx's exchange fits a head's x and dy");
};

// Byte offset of bf16 (row, col) in a swizzled box of 64 columns.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Rows [0, rows) of `cols` bf16 (a multiple of 8), row r at src + r *
// stride, into swizzled boxes `box_bytes` apart, column n to box n / nb
// (column n % nb of it); rows at or past `valid` zero-filled.  With
// `aligned` by cp.async in the current commit group, else element by
// element.
__device__ __forceinline__ void load_boxes(uint8_t* tile, int box_bytes, int nb, const bf16* src,
                                           long long stride, int rows, int cols, int valid,
                                           bool aligned) {
  const int chunks = cols / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * 8;
    const bool ok = r < valid;
    const bf16* from = src + (ok ? r : 0) * stride + c;
    uint8_t* to = tile + (c / nb) * box_bytes + swz(r, c % nb);
    if (aligned) {
      mma::cp_async16(to, from, ok);
    } else {
      bf16* t = reinterpret_cast<bf16*>(to);
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = ok ? from[e] : __float2bfloat16(0.f);
    }
  }
}

// Descriptors of a swizzled tile for wgmma: K-major (k16 step kk of a box
// at 32 kk bytes along its rows) and MN-major (k16 step at 16 rows, boxes
// `box_bytes` apart).
__device__ __forceinline__ uint64_t kmajor(const uint8_t* rows, int kk) {
  return hopper::smem_desc_b128(rows + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* rows, int box_bytes) {
  return hopper::smem_desc_b128(rows, box_bytes, 1024);
}

template <int M>
__device__ __forceinline__ void zero(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = 0.f;
}

// The wgmma fragment of a warpgroup's m64 tile: thread (warp w % 4, lane l)
// holds rows 16 (w % 4) + l / 4 + 8 hh of columns 8 j + 2 (l % 4) + e at
// d[4 j + 2 hh + e].  For the k16 step t of an accumulator that is the A
// operand of the next product, its floats 8 t .. 8 t + 7.

// The M^T and W^T fragments (hi and lo A operands: rows j, k = positions i
// of step i0) from dwt = (x_j . dy_i) (the step's eight floats) and C B^T,
// and this thread's share of Z's column sums.  The warp's own rows' cum_j
// and dt_j come in registers (cj, dj); dec = e^{cum_i - cum_j} by the fast
// exponential (some 2 ulp), the products it weights being split anyway.
__device__ __forceinline__ void column_weights(const float* dwt, const float* cbm, int r0,
                                               int j0, int i0, int qv, const float* cum,
                                               const float (&cj)[2], const float (&dj)[2],
                                               int lane, bool want_w, uint32_t (&mhi)[4],
                                               uint32_t (&mlo)[4], uint32_t (&whi)[4],
                                               uint32_t (&wlo)[4], float (&zp)[2]) {
  constexpr int LDJ = 68;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float2 ci = *reinterpret_cast<const float2*>(cum + i0 + 8 * t + 2 * cq);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + gq + 8 * hh;
      float m2[2], w2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = i0 + 8 * t + 2 * cq + q;
        float m = 0.f, w = 0.f;
        if (i >= j && j < qv) {
          const float dec = __expf((q ? ci.y : ci.x) - cj[hh]);
          const float dw = dwt[4 * t + 2 * hh + q];
          const float cb = cbm[(i - r0) * LDJ + j - r0];
          const float ddt = dec * dj[hh];
          m = dw * ddt;
          w = cb * ddt;
          zp[hh] += dw * cb * dec;
        }
        m2[q] = m;
        w2[q] = w;
      }
      hopper::split_bf16x2(m2[0], m2[1], mhi[hh + 2 * t], mlo[hh + 2 * t]);
      if (want_w) hopper::split_bf16x2(w2[0], w2[1], whi[hh + 2 * t], wlo[hh + 2 * t]);
    }
  }
}

// The M fragments (rows i, k = positions j of step j0) from dw = (dy_i .
// x_j), and this thread's share of Z's row sums (times dt_j); the warp's
// own rows' cum_i in registers (ci).  C B^T (i, j) is in the slice's part
// for j >= r0, else in the part of the rows before it (`ct` rows on).
__device__ __forceinline__ void row_weights(const float* dw, const float* cbm, int r0, int ct,
                                            int i0, int j0, int qv, const float* cum,
                                            const float* dts, const float (&ci)[2], int lane,
                                            uint32_t (&mhi)[4], uint32_t (&mlo)[4],
                                            float (&rz)[2]) {
  constexpr int LDJ = 68;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int jb = j0 + 8 * t + 2 * cq;
    const float2 cj = *reinterpret_cast<const float2*>(cum + jb);
    const float2 dj = *reinterpret_cast<const float2*>(dts + jb);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + gq + 8 * hh;
      float m2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = jb + q;
        float m = 0.f;
        if (j <= i && i < qv) {
          m = dw[4 * t + 2 * hh + q] * __expf(ci[hh] - (q ? cj.y : cj.x)) * (q ? dj.y : dj.x);
          const float cb = j >= r0 ? cbm[(i - r0) * LDJ + j - r0] : cbm[(ct + j) * LDJ + i - r0];
          rz[hh] += m * cb;
        }
        m2[q] = m;
      }
      hopper::split_bf16x2(m2[0], m2[1], mhi[hh + 2 * t], mlo[hh + 2 * t]);
    }
  }
}

// Row sums over a box of `acc` (64 columns) times the same rows of a
// swizzled bf16 box (row `row0` on for this warp's rows), over the quad.
__device__ __forceinline__ void box_row_dots(float (&out)[2], const float (&acc)[32],
                                             const uint8_t* box, int row0, int lane) {
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + gq + 8 * hh;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 t =
          mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(box + swz(row, 8 * j + 2 * cq)));
      s += acc[4 * j + 2 * hh] * t.x + acc[4 * j + 2 * hh + 1] * t.y;
    }
    out[hh] = quad_sum(s);
  }
}

__device__ __forceinline__ void scale_rows(float (&acc)[32], float s0, float s1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= s0;
    acc[4 * j + 1] *= s0;
    acc[4 * j + 2] *= s1;
    acc[4 * j + 3] *= s1;
  }
}

// grid (slices, chunks, B), two warpgroups.  The CTA first forms C B^T on
// the slice's part of the chunk, then walks the heads in order for its
// positions [r0, r0 + R): dx of its rows, their parts of d(cum) and d(dt),
// its share of <G, h_in> (P / slices rows of the state a slice), and dB
// and dC of its rows summed over the heads in registers.  A head: the
// states' products (x_j^T G, s_j G B_j, e^{cum_i} dy_i h_in) first, then,
// while the next head's tiles arrive, the column strip (dx_j and dB_j over
// i >= j, two k16 steps of x dy^T at a time) and the row strip (dC_i over
// j <= i).
template <int P, int N, int Q>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_grads_wgmma(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                        const float* __restrict__ hst, const float* __restrict__ gst,
                        bf16* __restrict__ dx, bf16* __restrict__ dB, bf16* __restrict__ dC,
                        float* __restrict__ dcump, float* __restrict__ ddtp,
                        float* __restrict__ srp, float* __restrict__ dot, long long sBb,
                        long long sBs, long long sCb, long long sCs, int S, int H, int aligned) {
  using Lay = GradsLayout<P, N, Q>;
  constexpr int R = Lay::R, QT = Lay::QT, NB = Lay::NB, LDJ = Lay::LDJ, BOX = Lay::BOX;
  constexpr int SLICES = Q / R;
  static_assert(Lay::launch_bytes <= 232448, "shared memory");
  static_assert(P % 16 == 0 && P <= 64 && NB % 16 == 0 && NB <= 64 && Q % 32 == 0 &&
                    P % SLICES == 0,
                "tile shape");

  extern __shared__ uint8_t smem_raw[];
  // Swizzle atoms start 1024-byte aligned in the shared window.
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // the warpgroup: its box of the state's columns
  const int gq = lane >> 2, cq = lane & 3;
  const int slice = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int s0 = c * Q;
  const int qv = min(Q, S - s0);
  const int r0 = slice * R;
  if (r0 >= qv) return;
  const int BT = r0 + 64, CT = QT - r0;  // rows of the B and C tiles

  uint8_t* bt = smem + Lay::bc_off;       // B rows [0, BT)
  uint8_t* ctl = bt + 2 * BT * 128;       // C rows [r0, QT)
  uint8_t* xdy = smem + Lay::xdy_off;     // buffer k: x, then dy, QT rows each
  uint8_t* gh = smem + Lay::gh_off;       // G hi, G lo, h_in hi, h_in lo
  float* cbm = reinterpret_cast<float*>(smem + Lay::cb_off);
  float* dtbuf = reinterpret_cast<float*>(smem + Lay::dt_off);
  float* v = reinterpret_cast<float*>(smem + Lay::v_off);
  float* colz = reinterpret_cast<float*>(smem + Lay::parts_off);
  float* rowz = colz + 64;
  float* rpart = rowz + 64;  // [2][64]
  float* upart = rpart + 128;
  float* red = reinterpret_cast<float*>(smem + Lay::red_off);
  const float* dts = v + kDt * Q;
  const float* cum = v + kCum * Q;
  const float* ecum = v + kEcum * Q;
  const float* sv = v + kSv * Q;
  const float* etot = v + kEtot * Q;

  const long long row0 = static_cast<long long>(b) * S;
  const long long sX = static_cast<long long>(H) * P;
  // This slice's rows of the state for <G, h_in>; a slice past the valid
  // rows returned above, so the last chunk's short slices fold theirs in.
  const int n_slices = min(SLICES, (qv + R - 1) / R);
  const int dot_p0 = slice * P / n_slices, dot_p1 = (slice + 1) * P / n_slices;

  const int lr = 16 * (warp & 3);  // this warp's rows within the tile
  const int j0 = r0 + lr;          // ... within the chunk, as j and as i
  const int row_a = j0 + gq, row_b = j0 + gq + 8;
  float accb[32], accc[32];  // dB and dC of this warpgroup's box, summed over the heads
  zero(accb);
  zero(accc);

  // Every tile starts zero: the columns past a box's share and the rows
  // past P stay so.
  for (int i = tid; i < static_cast<int>(Lay::cb_off / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto prefetch = [&](int h, int buf) {
    uint8_t* xt = xdy + buf * 2 * QT * 128;
    load_boxes(xt, 0, 64, x + ((row0 + s0) * H + h) * P, sX, QT, P, qv, aligned);
    load_boxes(xt + QT * 128, 0, 64, dy + ((row0 + s0) * H + h) * P, sX, QT, P, qv, aligned);
    load_dt(dtbuf + buf * Q, dt, (row0 + s0) * H + h, H, Q, qv);
    const size_t st = ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
    // The walk's planes of bf16 hi then lo halves of G and h_in.
    const bf16* g_hi = reinterpret_cast<const bf16*>(gst + st);
    const bf16* h_hi = reinterpret_cast<const bf16*>(hst + st);
    load_boxes(gh, BOX, NB, g_hi, N, P, N, P, true);
    load_boxes(gh + 2 * BOX, BOX, NB, g_hi + P * N, N, P, N, P, true);
    load_boxes(gh + 4 * BOX, BOX, NB, h_hi, N, P, N, P, true);
    load_boxes(gh + 6 * BOX, BOX, NB, h_hi + P * N, N, P, N, P, true);
  };
  load_boxes(bt, BT * 128, NB, Bm + b * sBb + s0 * sBs, sBs, BT, N, qv, aligned);
  load_boxes(ctl, CT * 128, NB, Cm + b * sCb + (s0 + r0) * sCs, sCs, CT, N, qv - r0, aligned);
  mma::cp_async_commit();
  prefetch(0, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  hopper::fence_proxy_async();
  __syncthreads();  // B and C have landed

  {  // C B^T: chunks of 64 columns, the slice's part then the rows before it
    for (int ch = wg; ch < QT / 64; ch += 2) {
      const bool own = ch < CT / 64;
      const uint8_t* at = own ? bt + r0 * 128 : ctl;
      const uint8_t* bq = own ? ctl + ch * 64 * 128 : bt + (ch - CT / 64) * 64 * 128;
      const int a_box = own ? BT * 128 : CT * 128, b_box = own ? CT * 128 : BT * 128;
      float acc[32];
      zero(acc);
      hopper::reg_fence(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < 2; ++bx)
#pragma unroll
        for (int kk = 0; kk < NB / 16; ++kk)
          hopper::wgmma_m64n64k16_ss_kmaj(acc, kmajor(at + bx * a_box, kk),
                                          kmajor(bq + bx * b_box, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      // acc: rows (A) lr + gq + 8 hh, columns (B) 8 jj + 2 cq + e of the chunk.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ar = lr + gq + 8 * hh, bc = ch * 64 + 8 * jj + 2 * cq + e;
            cbm[bc * LDJ + ar] = acc[4 * jj + 2 * hh + e];
          }
    }
  }

  for (int h = 0, k = 0; h < H; ++h, ++k) {
    const int buf = k & 1;
    const uint8_t* xt = xdy + buf * 2 * QT * 128;
    const uint8_t* dyt = xt + QT * 128;
    const size_t bh = static_cast<size_t>(b) * H + h;
    mma::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();  // this head's tiles have landed; the last head's parts are read
    if (warp == 0) {
      for (int j = lane; j < Q; j += 32) v[kDt * Q + j] = dtbuf[buf * Q + j];
      __syncwarp();
      scan_chunk<Q>(v, A[h], lane);
    }
    {  // this slice's share of <G, h_in>, from the hi + lo halves
      float part = 0.f;
      for (int e = tid; e < (dot_p1 - dot_p0) * 16; e += kThreads) {
        const int p = dot_p0 + e / 16, bx = (e / 8) & 1, ch = e & 7;
        const int off = bx * BOX + p * 128 + ch * 16;
        const uint4 g1 = *reinterpret_cast<const uint4*>(gh + off);
        const uint4 g2 = *reinterpret_cast<const uint4*>(gh + 2 * BOX + off);
        const uint4 h1 = *reinterpret_cast<const uint4*>(gh + 4 * BOX + off);
        const uint4 h2 = *reinterpret_cast<const uint4*>(gh + 6 * BOX + off);
        const uint32_t* a1 = reinterpret_cast<const uint32_t*>(&g1);
        const uint32_t* a2 = reinterpret_cast<const uint32_t*>(&g2);
        const uint32_t* b1 = reinterpret_cast<const uint32_t*>(&h1);
        const uint32_t* b2 = reinterpret_cast<const uint32_t*>(&h2);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 ga = mma::unpack_bf16(a1[w]), gb = mma::unpack_bf16(a2[w]);
          const float2 ha = mma::unpack_bf16(b1[w]), hb = mma::unpack_bf16(b2[w]);
          part += (ga.x + gb.x) * (ha.x + hb.x) + (ga.y + gb.y) * (ha.y + hb.y);
        }
      }
      part = attn::warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();  // the vectors are ready
    const float s_a = row_a < qv ? sv[row_a] : 0.f, s_b = row_b < qv ? sv[row_b] : 0.f;

    // ---- the states' products over this warpgroup's box of columns.
    const uint8_t* g_hi = gh + wg * BOX;
    const uint8_t* g_lo = g_hi + 2 * BOX;
    const uint8_t* h_hi = g_hi + 4 * BOX;
    const uint8_t* h_lo = g_hi + 6 * BOX;
    const uint8_t* b_box = bt + wg * BT * 128;   // B rows, this box
    const uint8_t* c_box = ctl + wg * CT * 128;  // C rows from r0, this box
    float accx[32];  // dx, this warpgroup's share: its box of G B_j, its k16 steps of W^T dy
    {
      float xg[32];  // x_j^T G: r_j and dB_j's term
      zero(xg);
      hopper::reg_fence(xg);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const uint64_t a = kmajor(xt + r0 * 128, kk);
        hopper::wgmma_m64n64k16_bf16_kmaj_mnmaj(xg, a, mnmajor(g_hi + kk * 16 * 128, BOX), 1);
        hopper::wgmma_m64n64k16_bf16_kmaj_mnmaj(xg, a, mnmajor(g_lo + kk * 16 * 128, BOX), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(xg);
      float r[2];
      box_row_dots(r, xg, b_box, j0, lane);
      scale_rows(xg, s_a, s_b);
#pragma unroll
      for (int i = 0; i < 32; ++i) accb[i] += xg[i];
      if (cq == 0) {
        rpart[wg * 64 + lr + gq] = r[0];
        rpart[wg * 64 + lr + gq + 8] = r[1];
      }
    }
    {
      float dh[32];  // e^{cum_i} dy_i h_in: u_i and dC_i's term
      zero(dh);
      hopper::reg_fence(dh);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const uint64_t a = kmajor(dyt + r0 * 128, kk);
        hopper::wgmma_m64n64k16_bf16_kmaj_mnmaj(dh, a, mnmajor(h_hi + kk * 16 * 128, BOX), 1);
        hopper::wgmma_m64n64k16_bf16_kmaj_mnmaj(dh, a, mnmajor(h_lo + kk * 16 * 128, BOX), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dh);
      scale_rows(dh, row_a < qv ? ecum[row_a] : 0.f, row_b < qv ? ecum[row_b] : 0.f);
      float u[2];
      box_row_dots(u, dh, c_box, lr, lane);
#pragma unroll
      for (int i = 0; i < 32; ++i) accc[i] += dh[i];
      if (cq == 0) {
        upart[wg * 64 + lr + gq] = u[0];
        upart[wg * 64 + lr + gq + 8] = u[1];
      }
    }
    zero(accx);
    hopper::reg_fence(accx);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) {  // B_j G^T over this box's columns
      const uint64_t a = kmajor(b_box + r0 * 128, kk);
      hopper::wgmma_m64n64k16_ss_kmaj(accx, a, kmajor(g_hi, kk), 1);
      hopper::wgmma_m64n64k16_ss_kmaj(accx, a, kmajor(g_lo, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(accx);
    scale_rows(accx, s_a, s_b);
    __syncthreads();  // G and h_in are free
    if (h + 1 < H) prefetch(h + 1, buf ^ 1);
    mma::cp_async_commit();

    const float cw[2] = {row_a < qv ? cum[row_a] : 0.f, row_b < qv ? cum[row_b] : 0.f};
    const float dw_[2] = {row_a < qv ? dts[row_a] : 0.f, row_b < qv ? dts[row_b] : 0.f};
    const int end16 = min(Q, (qv + 15) & ~15);
    // ---- as the column j: dB_j += M^T C and dx_j += W^T dy over i >= j
    // (dx's k16 steps alternate between the warpgroups), Z's column sums.
    float zp[2] = {0.f, 0.f};
    for (int i0 = r0; i0 < end16; i0 += 32) {
      const bool two = i0 + 16 < end16;
      float dwt[16];  // x_j . dy_i, two k16 steps of i
      zero(dwt);
      hopper::reg_fence(dwt);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        hopper::wgmma_m64n32k16_ss_kmaj(dwt, kmajor(xt + r0 * 128, kk),
                                        kmajor(dyt + i0 * 128, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dwt);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 1 && !two) break;
        const int ii = i0 + 16 * t;
        const bool mine = (((ii - r0) >> 4) & 1) == wg;  // this warpgroup's step of dx
        uint32_t mhi[4], mlo[4], whi[4], wlo[4];
        column_weights(dwt + 8 * t, cbm, r0, j0, ii, qv, cum, cw, dw_, lane, mine, mhi, mlo, whi,
                       wlo, zp);
        hopper::reg_fence(mhi);
        hopper::reg_fence(mlo);
        hopper::reg_fence(whi);
        hopper::reg_fence(wlo);
        hopper::reg_fence(accb);
        hopper::reg_fence(accx);
        hopper::wgmma_fence();
        const uint64_t cdesc = mnmajor(c_box + (ii - r0) * 128, CT * 128);
        hopper::wgmma_m64n64k16_rs_mnmaj(accb, mhi, cdesc);
        hopper::wgmma_m64n64k16_rs_mnmaj(accb, mlo, cdesc);
        if (mine) {
          const uint64_t ddesc = mnmajor(dyt + ii * 128, QT * 128);
          hopper::wgmma_m64n64k16_rs_mnmaj(accx, whi, ddesc);
          hopper::wgmma_m64n64k16_rs_mnmaj(accx, wlo, ddesc);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(accb);
        hopper::reg_fence(accx);
        hopper::reg_fence(mhi);
        hopper::reg_fence(mlo);
        hopper::reg_fence(whi);
        hopper::reg_fence(wlo);
      }
    }
    // ---- as the row i: dC_i += M B over j <= i, Z's row sums.
    float rz[2] = {0.f, 0.f};
    const int jend = min(r0 + R, end16);
    for (int jj0 = 0; jj0 < jend; jj0 += 32) {
      const bool two = jj0 + 16 < jend;
      float dwr[16];  // dy_i . x_j, two k16 steps of j
      zero(dwr);
      hopper::reg_fence(dwr);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        hopper::wgmma_m64n32k16_ss_kmaj(dwr, kmajor(dyt + r0 * 128, kk),
                                        kmajor(xt + jj0 * 128, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dwr);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 1 && !two) break;
        const int jj = jj0 + 16 * t;
        uint32_t mhi[4], mlo[4];
        row_weights(dwr + 8 * t, cbm, r0, CT, j0, jj, qv, cum, dts, cw, lane, mhi, mlo, rz);
        hopper::reg_fence(mhi);
        hopper::reg_fence(mlo);
        hopper::reg_fence(accc);
        hopper::wgmma_fence();
        const uint64_t bdesc = mnmajor(b_box + jj * 128, BT * 128);
        hopper::wgmma_m64n64k16_rs_mnmaj(accc, mhi, bdesc);
        hopper::wgmma_m64n64k16_rs_mnmaj(accc, mlo, bdesc);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(accc);
        hopper::reg_fence(mhi);
        hopper::reg_fence(mlo);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      zp[hh] = quad_sum(zp[hh]);
      rz[hh] = quad_sum(rz[hh]);
    }
    if (wg == 0 && cq == 0) {
      colz[lr + gq] = zp[0];
      colz[lr + gq + 8] = zp[1];
      rowz[lr + gq] = rz[0];
      rowz[lr + gq + 8] = rz[1];
    }
    __syncthreads();  // every read of this head's x and dy is done
    // dx: warpgroup 1's share through the exchange (64 x 64 floats over
    // this head's x and dy, columns swizzled by row), added by warpgroup 0.
    float* xch = reinterpret_cast<float*>(xdy + buf * 2 * QT * 128);
    if (wg == 1) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = lr + gq + 8 * hh;
          const int col = (8 * jj + 2 * cq) ^ ((row & 7) << 3);
          *reinterpret_cast<float2*>(xch + row * 64 + col) =
              make_float2(accx[4 * jj + 2 * hh], accx[4 * jj + 2 * hh + 1]);
        }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = lr + gq + 8 * hh;
        const int j = r0 + row;
        if (j >= qv) continue;
        bf16* xr = dx + ((row0 + s0 + j) * H + h) * P;
#pragma unroll
        for (int jj = 0; jj < P / 8; ++jj) {
          const int col = 8 * jj + 2 * cq;
          const float2 o =
              *reinterpret_cast<const float2*>(xch + row * 64 + (col ^ ((row & 7) << 3)));
          *reinterpret_cast<__nv_bfloat162*>(xr + col) = __floats2bfloat162_rn(
              accx[4 * jj + 2 * hh] + o.x, accx[4 * jj + 2 * hh + 1] + o.y);
        }
      }
    }
    for (int t = tid; t < R; t += kThreads) {
      const int kk = r0 + t;
      if (kk >= qv) continue;
      store_rows(dcump, ddtp, srp, bh * S + s0 + kk, dts[kk], sv[kk], etot[kk], colz[t],
                 rowz[t], upart[t] + upart[64 + t], rpart[t] + rpart[64 + t]);
    }
    if (tid == 0) {
      float d = 0.f;
      for (int w = 0; w < kWarps; ++w) d += red[w];
      dot[(bh * nc + c) * SLICES + slice] = d;
      for (int q = n_slices; q < SLICES && slice == 0; ++q) dot[(bh * nc + c) * SLICES + q] = 0.f;
    }
  }

  mma::cp_async_wait<0>();
  // dB and dC of this warpgroup's box: column 8 jj + 2 cq is the state's
  // column wg N / 2 + 8 jj + 2 cq where it is under N / 2.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + gq + 8 * hh;
    if (j >= qv) continue;
    const size_t at = static_cast<size_t>(row0 + s0 + j) * N + wg * NB + 2 * cq;
#pragma unroll
    for (int jj = 0; jj < NB / 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(dB + at + jj * 8) =
          __floats2bfloat162_rn(accb[4 * jj + 2 * hh], accb[4 * jj + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dC + at + jj * 8) =
          __floats2bfloat162_rn(accc[4 * jj + 2 * hh], accc[4 * jj + 2 * hh + 1]);
    }
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
  void* dB;
  void* dC;
  void* dA;
  float* hst;   // (B, H, chunks, P, N): the states entering the chunks
  float* gst;   // mma: (B, H, chunks, P, N), the gradients leaving them
  float* edec;  // mma: (B, H, chunks)
  float* rows;  // mma: (3, B, H, S): dcum_part, ddt_part, s r
  float* dot;   // mma: (B, H, chunks, slices)
  float* dbp;   // simt: (B, H, S, N)
  float* dcp;   // simt: (B, H, S, N)
  float* dap;   // simt: (B, H)
  long long sBb, sBs, sCb, sCs;
  int B, S, H, aligned;
  cudaEvent_t events[2];  // recorded after launch 1 and 2 where not null
};

int record(const Args& a, int i, cudaStream_t stream) {
  return a.events[i] == nullptr ? 0 : (int)cudaEventRecord(a.events[i], stream);
}

// `parts`: partial dots of <G, h_in> a chunk (the grads launch's slices).
int launch_finish(const Args& a, int Q, int parts, cudaStream_t stream) {
  const float* dcump = a.rows;
  const size_t plane = static_cast<size_t>(a.B) * a.S * a.H;
  auto go = [&](auto kernel) {
    kernel<<<a.H, kFinishThreads, 0, stream>>>(
        static_cast<const float*>(a.dt), static_cast<const float*>(a.A), dcump, dcump + plane,
        dcump + 2 * plane, a.dot, a.edec, static_cast<float*>(a.ddt),
        static_cast<float*>(a.dA), a.B, a.S, a.H, parts);
  };
  switch (Q) {
    case 32: go(ssd_bwd_finish<32>); break;
    case 64: go(ssd_bwd_finish<64>); break;
    case 128: go(ssd_bwd_finish<128>); break;
    default: return (int)cudaErrorInvalidValue;
  }
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
      static_cast<float*>(a.dx), static_cast<float*>(a.ddt), a.dbp, a.dcp, a.dap, a.hst, a.sBb,
      a.sBs, a.sCb, a.sCs, a.S, a.H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int rc;
  if ((rc = record(a, 0, stream)) != 0) return rc;
  const long long total = static_cast<long long>(a.B) * a.S * N;
  ssd_bwd_reduce<float><<<static_cast<int>((total + 255) / 256), 256, 0, stream>>>(
      a.dbp, a.dcp, a.dap, static_cast<float*>(a.dB), static_cast<float*>(a.dC),
      static_cast<float*>(a.dA), a.B, a.S, a.H, N);
  return (int)cudaGetLastError();
}

template <int P, int N, int Q>
int launch_mma(const Args& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using WL = tc::WalkLayout<P, N, Q>;
  using GL = tc::GradsLayout<P, N, Q>;
  const int nc = (a.S + Q - 1) / Q;
  const size_t plane = static_cast<size_t>(a.B) * a.S * a.H;
  cudaError_t err;
  int rc;
  auto walk = tc::ssd_bwd_walk_mma<P, N, Q>;
  auto grads = tc::ssd_bwd_grads_wgmma<P, N, Q>;
  if ((err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)WL::bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)GL::launch_bytes)) != cudaSuccess)
    return (int)err;
  const auto* x = static_cast<const bf16*>(a.x);
  const auto* dt = static_cast<const float*>(a.dt);
  const auto* A = static_cast<const float*>(a.A);
  const auto* Bm = static_cast<const bf16*>(a.Bm);
  const auto* Cm = static_cast<const bf16*>(a.Cm);
  const auto* dy = static_cast<const bf16*>(a.dy);
  walk<<<dim3(a.H, a.B, 2), kThreads, WL::bytes, stream>>>(
      x, dt, A, Bm, Cm, dy, a.hst, a.gst, a.edec, a.sBb, a.sBs, a.sCb, a.sCs, a.S, a.H,
      a.aligned);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((rc = record(a, 0, stream)) != 0) return rc;
  grads<<<dim3(Q / GL::R, nc, a.B), kThreads, GL::launch_bytes, stream>>>(
      x, dt, A, Bm, Cm, dy, a.hst, a.gst, static_cast<bf16*>(a.dx), static_cast<bf16*>(a.dB),
      static_cast<bf16*>(a.dC), a.rows, a.rows + plane, a.rows + 2 * plane, a.dot, a.sBb, a.sBs,
      a.sCb, a.sCs, a.S, a.H, a.aligned);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((rc = record(a, 1, stream)) != 0) return rc;
  return launch_finish(a, Q, Q / GL::R, stream);
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
  if (a.B < 1 || a.S < 1 || a.H < 1 || 2 * a.B > 65535 || a.H > 65535 ||
      (a.S + Q - 1) / Q > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32: return by_state<kMma, 32>(a, N, Q, st);
    case 64: return by_state<kMma, 64>(a, N, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

void set_events(Args& a, void* const* events) {
  for (int i = 0; i < 2; ++i)
    a.events[i] = events == nullptr ? nullptr : static_cast<cudaEvent_t>(events[i]);
}

}  // namespace

// x and dy (B, S, H, P), dt (B, S, H) float32, A (H,) float32, contiguous;
// Bm and Cm (B, S, N) with element strides (sBb, sBs) and (sCb, sCs) and unit
// stride along N.  Writes dx (B, S, H, P), d(dt) (B, S, H) float32, dB and dC
// (B, S, N) contiguous and dA (H,) float32; x, Bm, Cm, dy, dx, dB and dC share
// the type.  Scratch, float32: hch B * H * ceil(S / Q) * P * N floats, dbp
// and dcp B * H * S * N (the per-head partials), dap B * H.  `events`, null
// or two cudaEvent_t (each null or an event), are recorded after the per-head
// launch (the second is not used).  Returns the CUDA error code of the
// launches (0 on success).
extern "C" int ssd_bwd_f32(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* dy, void* dx, void* ddt, void* dB,
                           void* dC, void* dA, void* hch, void* dbp, void* dcp, void* dap,
                           long long sBb, long long sBs, long long sCb, long long sCs, int B,
                           int S, int H, int P, int N, int Q, void* const* events,
                           void* stream) {
  Args a{x, dt, A, Bm, Cm, dy, dx, ddt, dB, dC, dA, static_cast<float*>(hch), nullptr, nullptr,
         nullptr, nullptr, static_cast<float*>(dbp), static_cast<float*>(dcp),
         static_cast<float*>(dap), sBb, sBs, sCb, sCs, B, S, H, 0, {}};
  set_events(a, events);
  return dispatch<false>(a, P, N, Q, stream);
}

// As ssd_bwd_f32, in bf16 and without per-head partials (dB and dC are
// summed over the heads on chip), with `aligned` nonzero when x, dy, Bm and
// Cm start 16-byte aligned and sBb, sBs, sCb, sCs are multiples of 8 (their
// rows are then copied 16 bytes at a time).  Scratch, float32: hst and gst
// B * H * ceil(S / Q) * P * N floats each, edec B * H * ceil(S / Q), dot
// twice that, rows 3 * B * H * S.  Events after the walk and the grads
// launches.
extern "C" int ssd_bwd_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, void* dx, void* ddt, void* dB,
                            void* dC, void* dA, void* hst, void* gst, void* edec, void* rows,
                            void* dot, long long sBb, long long sBs, long long sCb,
                            long long sCs, int B, int S, int H, int P, int N, int Q,
                            int aligned, void* const* events, void* stream) {
  Args a{x, dt, A, Bm, Cm, dy, dx, ddt, dB, dC, dA, static_cast<float*>(hst),
         static_cast<float*>(gst), static_cast<float*>(edec), static_cast<float*>(rows),
         static_cast<float*>(dot), nullptr, nullptr, nullptr, sBb, sBs, sCb, sCs, B, S, H,
         aligned, {}};
  set_events(a, events);
  return dispatch<true>(a, P, N, Q, stream);
}
