// Flash-decode for Hopper (sm_90a): one query token per sequence against a
// (ring) KV cache, behind a plain C interface loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:72
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
// bytes-bound, as at every served shape (at most about 16 FLOP a byte, at
// R = 16, against the card's 295).
//
// The TPU kernel walks the cache in order on one core.  B*KV is only 4-32
// at the served shapes, so here the slots are split over CTAs: grid
// (n_split, KV, B), n_split chosen by the wrapper so that about one CTA
// (mma) or two (simt) per SM cover the card.  Slots past a split's end weigh nothing (score
// -inf), so a split with no valid slot gives the TPU kernel's result over
// its own slots: masked scores are -2e38, not -inf, so they weigh exp(0) =
// 1 each and the output is the mean of v.  Two variants, picked by dtype
// alone (decode_attention.py:_variant):
//
// 1. decode_mma (bf16; every served decode step): four warps on the tensor
//    cores, mma.sync.m16n8k16 with float32 accumulators, and the merge of
//    the splits in the same kernel.
//    - Loads: a ring of three stages, each a tile of BL slots of K and of V
//      (32 KB at every head_dim: BL = 8192 / D when the row groups allow),
//      copied with cp.async (16 bytes a thread, L2 only) in commit groups,
//      so that tiles i+1 and i+2 are in flight while tile i is computed.
//      A CTA takes about 107 KB of shared memory at NG = 1, so two fit on
//      an SM, and a cluster of 8 CTAs needs only 4 SMs of a GPC.  More
//      stages (one CTA an SM) were slower on an H100: clusters of 8 SMs
//      packed worse into its GPCs.  The slot rows of a tile sit
//      in shared memory with their 16-byte chunks XOR-swizzled by row
//      (chunk ^ row % 8), so ldmatrix reads them without bank conflicts.
//      Slots past the split are zero-filled, never read.
//    - Rows: the R query heads of a KV group, zero-padded to NG row groups
//      of 16 (NG = 1 up to R = 16), the M of m16n8k16.  mma.sync rather
//      than wgmma: wgmma's 64 rows would waste 4-32x of its work at
//      R = 2..16, and at 16 FLOP a byte or less the tensor rate is not the
//      limit, so the simpler warp-level instruction loses nothing.
//    - S = q K^T: each warp scores its quarter of the tile's slots over the
//      whole head_dim (A: q from shared memory, B: K rows, both by
//      ldmatrix).  Scale, softcap (accurate tanhf) and mask on the float32
//      fragment; the tile's row maxima go through shared memory, so every
//      warp applies the same running max.
//    - O += P V: p = exp(s - m) is written to shared memory as bf16 hi =
//      bf16(p) and lo = bf16(p - hi) (a float32 p rounded once would put
//      outputs outside the card tolerance: scripts/torch_flash_p_rounding.py)
//      and each warp multiplies all of the tile's p into its quarter of the
//      head_dim (V by ldmatrix.trans), two products a k16 step.  So O stays
//      in registers (at most 64 floats a thread) and only the row maxima,
//      p and the ring need the CTA to synchronise: three barriers a tile.
//      Each warp sums l over its own slots; the sums meet at the end.
//    - Merge: the n_split CTAs of a (b, g) are one thread-block cluster (at
//      most 16; the wrapper picks a power of two).  Each leaves its (max,
//      sum, accumulator) in its shared memory; after a cluster barrier
//      each merges 1 / n_split of the outputs by log-sum-exp, reading the
//      others' partials through distributed shared memory, and writes them
//      in bf16.  A first design with a separate combine kernel (one thread
//      an output, partials through a float32 scratch) spent 25-55% of a
//      call in it on an H100 (PERF.md); the cluster keeps the partials on
//      chip and saves the second launch.
// 2. decode_simt (float32; phase 8's float32 models): 128 threads; each
//    tile of K and V is copied with cp.async into shared memory and waited
//    for, scores are one (query head, slot) pair a thread, the online
//    softmax one warp a query head, and p v one thread a (head, column)
//    pair, all float32 FMAs (TF32 would break the float32 2e-5 limit).
//    Each CTA writes its (max, sum, unnormalised accumulator) to a float32
//    scratch, and decode_combine, one thread per output element, merges
//    the splits by log-sum-exp.
#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

// ---------------------------------------------------------------- simt

namespace simt {

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
    decode_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

}  // namespace simt

// ---------------------------------------------------------------- mma

namespace tc {

using attn::kMinDenom;
using attn::kNegInf;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kStages = 3;
constexpr int kMaxSplits = 16;  // CTAs of a cluster: the splits of one (b, g)

// Slots a tile: 32 KB of K and V (8192 / D slots) while each warp's scores
// stay at most 8 fragments (NG row groups x BL / 32 slots), and at least
// one n8 fragment a warp.
template <int D, int NG>
__host__ __device__ constexpr int tile_slots() {
  return 32 * (256 / (D * NG) > 1 ? 256 / (D * NG) : 1);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of D
// columns, chunks XOR-swizzled by row (D >= 64: eight chunks or more a row).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

template <int D, int NG>
struct Layout {
  static constexpr int BL = tile_slots<D, NG>();
  static constexpr int RP = 16 * NG;     // query rows, padded
  static constexpr int LDP = BL + 8;     // row stride of p (elements)
  static constexpr size_t stage = 2ull * BL * D * sizeof(bf16);  // K then V
  // After the last tile the ring holds the split's partial for the merge:
  // max and sum of each padded row, the accumulator, the merge weights.
  static constexpr size_t merge = sizeof(float) * RP * (3 + D + kMaxSplits);
  static constexpr size_t ring = kStages * stage > merge ? kStages * stage : merge;
  static constexpr size_t q_off = (ring + 127) / 128 * 128;
  static constexpr size_t p_off = q_off + sizeof(bf16) * RP * D;
  static constexpr size_t m_off = p_off + 2 * sizeof(bf16) * RP * LDP;  // p hi, then lo
  static constexpr size_t pos_off = m_off + sizeof(float) * 4 * RP;     // per-warp row values
  static constexpr size_t bytes = pos_off + sizeof(int) * kStages * BL;
  // Splits a cluster may have: 16 (non-portable) while two CTAs fit an SM,
  // else the portable 8.
  static constexpr int max_splits = 2 * (bytes + 1024) <= 233472 ? kMaxSplits : 8;
};

template <int D, int NG>
__global__ void __launch_bounds__(kThreads, 2)
    decode_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ pos, bf16* __restrict__ o_out,
               int L, int KV, int R, int cur, int chunk, float scale, float softcap,
               int window) {
  using Lay = Layout<D, NG>;
  constexpr int BL = Lay::BL, RP = Lay::RP, LDP = Lay::LDP;
  constexpr int NT = BL / 32;  // n8 fragments of slots a warp scores
  constexpr int DW = D / 4;    // output columns a warp owns
  constexpr int NO = DW / 8;   // n8 fragments of the output a warp owns
  constexpr int CH = D / 8;    // 16-byte chunks a row
  static_assert(NO % 2 == 0 && BL % 16 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + Lay::q_off);
  bf16* p_hi = reinterpret_cast<bf16*>(smem + Lay::p_off);
  bf16* p_lo = p_hi + RP * LDP;
  float* w_s = reinterpret_cast<float*>(smem + Lay::m_off);  // [4][RP]
  int* pos_s = reinterpret_cast<int*>(smem + Lay::pos_off);   // [kStages][BL]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment row
  const int cq = lane & 3;   // fragment column pair
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;

  const size_t kv_stride = static_cast<size_t>(KV) * D;  // between slots
  const size_t base = static_cast<size_t>(b) * L * kv_stride + static_cast<size_t>(g) * D;
  const int l_begin = split * chunk;
  const int l_end = min(L, l_begin + chunk);
  const int n_tiles = l_end > l_begin ? (l_end - l_begin + BL - 1) / BL : 0;

  // Tile t of this split into stage t % kStages; rows past the split are
  // zero-filled, their positions 0 (masked by l_end below).
  auto load_tile = [&](int t) {
    const int l0 = l_begin + t * BL;
    bf16* ks = kv_s + (t % kStages) * 2 * BL * D;
    bf16* vs = ks + BL * D;
    for (int idx = tid; idx < BL * CH; idx += kThreads) {
      const int row = idx / CH;
      const int c = idx % CH;
      const bool ok = l0 + row < l_end;
      const size_t off = base + static_cast<size_t>(ok ? l0 + row : l_begin) * kv_stride + c * 8;
      mma::cp_async16(ks + swz<D>(row, c), k + off, ok);
      mma::cp_async16(vs + swz<D>(row, c), v + off, ok);
    }
    for (int j = tid; j < BL; j += kThreads)
      mma::cp_async4(pos_s + (t % kStages) * BL + j, pos + min(l0 + j, L - 1), l0 + j < l_end);
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    mma::cp_async_commit();
  }
  // q rows of this KV group, zero past R.
  const bf16* q_row = q + (static_cast<size_t>(b) * KV + g) * R * D;
  for (int idx = tid; idx < RP * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = idx % CH;
    *reinterpret_cast<uint4*>(q_s + swz<D>(r, c)) =
        r < R ? *reinterpret_cast<const uint4*>(q_row + r * D + c * 8) : make_uint4(0, 0, 0, 0);
  }

  // Rows gq and gq + 8 of each row group: running max, this thread's part
  // of the running sum, and the warp's columns of the accumulator.
  float m_run[NG][2], l_run[NG][2];
  float o[NG][NO][4];
#pragma unroll
  for (int rg = 0; rg < NG; ++rg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[rg][h] = kNegInf;
      l_run[rg][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[rg][n][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; tile t - 1 and its p are consumed
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    mma::cp_async_commit();

    const bf16* ks = kv_s + (t % kStages) * 2 * BL * D;
    const bf16* vs = ks + BL * D;
    const int* ps = pos_s + (t % kStages) * BL;
    const int l0 = l_begin + t * BL;

    // S = q K^T over this warp's slots [warp * NT * 8, (warp + 1) * NT * 8),
    // in two partial sums (even and odd k16 steps), which halves the chain
    // of dependent mma.sync on each fragment.
    float sacc[NG][NT][4], sodd[NG][NT][4];
#pragma unroll
    for (int rg = 0; rg < NG; ++rg)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[rg][n][e] = sodd[rg][n][e] = 0.f;
    auto s_step = [&](int kk, float (&acc)[NG][NT][4]) {
      uint32_t bk[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int row = warp * NT * 8 + n * 8 + (lane & 7);
        mma::ldsm_x2(bk[n], ks + swz<D>(row, (kk >> 3) + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int rg = 0; rg < NG; ++rg) {
        uint32_t a[4];
        const int row = rg * 16 + mma::a_rowmajor_row(lane);
        mma::ldsm_x4(a, q_s + swz<D>(row, (kk + mma::a_rowmajor_col(lane)) >> 3));
#pragma unroll
        for (int n = 0; n < NT; ++n) mma::mma_bf16(acc[rg][n], a, bk[n][0], bk[n][1]);
      }
    };
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 32) {
      s_step(kk, sacc);
      s_step(kk + 16, sodd);
    }
#pragma unroll
    for (int rg = 0; rg < NG; ++rg)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[rg][n][e] += sodd[rg][n][e];

    // Scale, softcap, mask; this warp's row maxima to shared memory.
    float tmax[NG][2];
#pragma unroll
    for (int rg = 0; rg < NG; ++rg) {
      tmax[rg][0] = tmax[rg][1] = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = warp * NT * 8 + n * 8 + 2 * cq + (e & 1);
          float x = sacc[rg][n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int p = ps[j];
          const bool ok = p >= 0 && p <= cur && (window <= 0 || p > cur - window);
          // Slots past the split weigh nothing; masked ones weigh exp(0) in
          // a split with no valid slot (the mean of v, as the TPU kernel).
          x = l0 + j >= l_end ? -INFINITY : ok ? x : kNegInf;
          sacc[rg][n][e] = x;
          tmax[rg][e >> 1] = fmaxf(tmax[rg][e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = tmax[rg][h];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (cq == 0) w_s[warp * RP + rg * 16 + gq + 8 * h] = mx;
      }
    }
    __syncthreads();

    // The tile's max over all warps; rescale, then p as bf16 hi + lo.
#pragma unroll
    for (int rg = 0; rg < NG; ++rg) {
      float m_new[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rg * 16 + gq + 8 * h;
        const float mt = fmaxf(fmaxf(w_s[row], w_s[RP + row]),
                               fmaxf(w_s[2 * RP + row], w_s[3 * RP + row]));
        m_new[h] = fmaxf(m_run[rg][h], mt);
        alpha[h] = expf(m_run[rg][h] - m_new[h]);
        m_run[rg][h] = m_new[h];
        l_run[rg][h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[rg][n][0] *= alpha[0];
        o[rg][n][1] *= alpha[0];
        o[rg][n][2] *= alpha[1];
        o[rg][n][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = expf(sacc[rg][n][2 * h] - m_new[h]);
          const float p1 = expf(sacc[rg][n][2 * h + 1] - m_new[h]);
          l_run[rg][h] += p0 + p1;
          uint32_t hi, lo;
          mma::split2(p0, p1, hi, lo);
          const int off = (rg * 16 + gq + 8 * h) * LDP + warp * NT * 8 + n * 8 + 2 * cq;
          *reinterpret_cast<uint32_t*>(p_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(p_lo + off) = lo;
        }
    }
    __syncthreads();

    // O[:, warp * DW ..] += p V: all of the tile's slots, this warp's columns.
#pragma unroll
    for (int kk = 0; kk < BL; kk += 16) {
#pragma unroll
      for (int rg = 0; rg < NG; ++rg) {
        uint32_t ahi[4], alo[4];
        const int off =
            (rg * 16 + mma::a_rowmajor_row(lane)) * LDP + kk + mma::a_rowmajor_col(lane);
        mma::ldsm_x4(ahi, p_hi + off);
        mma::ldsm_x4(alo, p_lo + off);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bv[4];
          const int row = kk + mma::b_kmajor_row(lane);
          const int col = warp * DW + n * 8 + mma::b_kmajor_col(lane);
          mma::ldsm_x4_t(bv, vs + swz<D>(row, col >> 3));
          mma::mma_bf16(o[rg][n], ahi, bv[0], bv[1]);
          mma::mma_bf16(o[rg][n], alo, bv[0], bv[1]);
          mma::mma_bf16(o[rg][n + 1], ahi, bv[2], bv[3]);
          mma::mma_bf16(o[rg][n + 1], alo, bv[2], bv[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();

  // Row sums over the quad.
#pragma unroll
  for (int rg = 0; rg < NG; ++rg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[rg][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_run[rg][h] = l;
    }
  __syncthreads();  // every warp is done with the ring and the last maxima

  // This split's (max, sum, accumulator) of every padded row, in the ring's
  // shared memory, where the other CTAs of the cluster read it.
  float* pm = reinterpret_cast<float*>(smem);
  float* pl = pm + RP;
  float* pacc = pl + RP;      // [RP][D]
  float* wt = pacc + RP * D;  // [n_split][RP] merge weights, then [RP] denominators
#pragma unroll
  for (int rg = 0; rg < NG; ++rg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 16 + gq + 8 * h;
      if (cq == 0) {
        w_s[warp * RP + row] = l_run[rg][h];
        if (warp == 0) pm[row] = m_run[rg][h];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(pacc + row * D + warp * DW + n * 8 + 2 * cq) =
            make_float2(o[rg][n][2 * h], o[rg][n][2 * h + 1]);
    }
  __syncthreads();
  for (int r = tid; r < RP; r += kThreads)
    pl[r] = w_s[r] + w_s[RP + r] + w_s[2 * RP + r] + w_s[3 * RP + r];

  // Merge the cluster's splits by log-sum-exp (the rank order of the sums
  // is fixed): per row, each split's weight and the denominator, then this
  // CTA's share of the R * D outputs, reading the other CTAs' accumulators
  // through distributed shared memory.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in place
  const int n_split = static_cast<int>(cluster.num_blocks());
  float* den = wt + kMaxSplits * RP;
  for (int r = tid; r < R; r += kThreads) {
    float mv[kMaxSplits];
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < kMaxSplits; ++t)
      if (t < n_split) {
        mv[t] = *cluster.map_shared_rank(pm + r, t);
        mx = fmaxf(mx, mv[t]);
      }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSplits; ++t)
      if (t < n_split) {
        const float w = expf(mv[t] - mx);
        wt[t * RP + r] = w;
        sum += *cluster.map_shared_rank(pl + r, t) * w;
      }
    den[r] = fmaxf(sum, kMinDenom);
  }
  __syncthreads();
  const int rd = R * D;
  bf16* out = o_out + (static_cast<size_t>(b) * KV + g) * rd;
  for (int i = split * kThreads + tid; i < rd; i += n_split * kThreads) {
    const int r = i / D;
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_split; ++t) acc += wt[t * RP + r] * *cluster.map_shared_rank(pacc + i, t);
    attn::store(out + i, acc / den[r]);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}
}  // namespace tc

// Merge the n_split partial softmaxes by log-sum-exp: one thread per
// output element, grid (B * KV, R * D / kThreads), so that the merge's
// dependent loads spread over many SMs (R = 16 gives 4,096 elements per
// (b, g)).
template <typename T>
__global__ void __launch_bounds__(attn::kThreads)
    decode_combine(const float* __restrict__ part, T* __restrict__ o, int R, int D,
                   int n_split) {
  using attn::kMinDenom;
  using attn::kNegInf;
  const int rd = R * D;
  const int i = blockIdx.y * attn::kThreads + threadIdx.x;
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
  attn::store(o + static_cast<size_t>(blockIdx.x) * rd + i, acc / fmaxf(sum, kMinDenom));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;
  float* part;
  int B, L, KV, R, cur, n_split, chunk;
  float scale, softcap;
  int window;
};

template <typename T>
int launch_combine(const Args& a, int D, cudaEvent_t mid, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mid != nullptr && (err = cudaEventRecord(mid, stream)) != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.KV, (a.R * D + attn::kThreads - 1) / attn::kThreads);
  decode_combine<T><<<grid, attn::kThreads, 0, stream>>>(a.part, static_cast<T*>(a.o), a.R, D,
                                                         a.n_split);
  return (int)cudaGetLastError();
}

template <int D>
int launch_simt(const Args& a, cudaEvent_t mid, cudaStream_t stream) {
  const size_t smem = simt::smem_bytes<float, D>(a.R);
  auto kernel = simt::decode_simt<float, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.n_split, a.KV, a.B), attn::kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.pos, a.part, a.L, a.KV, a.R, a.cur, a.chunk, a.scale,
      a.softcap, a.window);
  return launch_combine<float>(a, D, mid, stream);
}

// The split pass and, in the same kernel, the merge: a cluster of n_split
// CTAs per (b, g).
template <int D, int NG>
int launch_mma(const Args& a, cudaStream_t stream) {
  using Lay = tc::Layout<D, NG>;
  constexpr size_t smem = Lay::bytes;
  static_assert(smem <= 232448, "shared memory");
  if (a.n_split > Lay::max_splits) return (int)cudaErrorInvalidValue;
  auto kernel = tc::decode_mma<D, NG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.KV, a.B);
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using bf16 = __nv_bfloat16;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(a.q),
                           static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v), a.pos,
                           static_cast<bf16*>(a.o), a.L, a.KV, a.R, a.cur, a.chunk, a.scale,
                           a.softcap, a.window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Row groups of 16 query heads, rounded up to a power of two; 0 if R * D
// is above what the kernel takes (8192).
int row_groups(int R, int D) {
  const int need = (R + 15) / 16;
  int ng = 1;
  while (ng < need) ng *= 2;
  return ng * D <= 512 ? ng : 0;
}

template <int D>
int dispatch_mma(const Args& a, cudaStream_t st) {
  switch (row_groups(a.R, D)) {
    case 1: return launch_mma<D, 1>(a, st);
    case 2: return launch_mma<D, 2>(a, st);
    case 4: if constexpr (D <= 128) return launch_mma<D, 4>(a, st);
      return (int)cudaErrorInvalidValue;
    case 8: if constexpr (D <= 64) return launch_mma<D, 8>(a, st);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// Layout::max_splits of the instantiation dispatch_mma launches; 0 where
// it launches none.
template <int D>
int max_splits_mma(int R) {
  switch (row_groups(R, D)) {
    case 1: return tc::Layout<D, 1>::max_splits;
    case 2: return tc::Layout<D, 2>::max_splits;
    case 4: if constexpr (D <= 128) return tc::Layout<D, 4>::max_splits;
      return 0;
    case 8: if constexpr (D <= 64) return tc::Layout<D, 8>::max_splits;
      return 0;
    default: return 0;
  }
}

bool valid(const Args& a, int unit) {
  return a.B >= 1 && a.L >= 1 && a.KV >= 1 && a.R >= 1 && a.n_split >= 1 && a.chunk >= 1 &&
         a.chunk % unit == 0 && static_cast<long long>(a.n_split) * a.chunk >= a.L &&
         static_cast<long long>(a.n_split - 1) * a.chunk < a.L;
}

}  // namespace

// q (B, KV, R, D), k and v (B, L, KV, D), pos (L,) int32, o (B, KV, R, D),
// scratch B*KV*n_split*R*(D+2) floats, all contiguous and 16-byte aligned.
// Split s covers slots [s*chunk, min(L, (s+1)*chunk)); every split holds
// a slot.  softcap <= 0 means none, window <= 0 means none.  `mid`, a
// cudaEvent_t or null, is recorded between the split pass and the combine
// pass.  Returns the CUDA error code of the launches.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, void* scratch, int B, int L,
                                    int KV, int R, int D, int cur, int n_split, int chunk,
                                    float scale, float softcap, int window, void* mid,
                                    void* stream) {
  const Args a{q, k, v, static_cast<const int*>(pos), o, static_cast<float*>(scratch),
               B, L, KV, R, cur, n_split, chunk, scale, softcap, window};
  if (!valid(a, attn::tile_rows<float>())) return (int)cudaErrorInvalidValue;
  const cudaEvent_t ev = static_cast<cudaEvent_t>(mid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_simt<64>(a, ev, st);
    case 128: return launch_simt<128>(a, ev, st);
    case 256: return launch_simt<256>(a, ev, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The most splits decode_attention_bf16 takes at R query heads of head_dim
// D: 16, or the portable 8 where a CTA takes more than half an SM's shared
// memory (R > 16 at D = 256); 0 where it takes no such R and D.
extern "C" int decode_mma_max_splits(int R, int D) {
  switch (D) {
    case 64: return max_splits_mma<64>(R);
    case 128: return max_splits_mma<128>(R);
    case 256: return max_splits_mma<256>(R);
    default: return 0;
  }
}

// As decode_attention_f32 in bf16, in one kernel: the n_split CTAs of a
// (b, g) form a cluster and merge their splits through distributed shared
// memory, so there is no scratch and no combine pass (`scratch` and `mid`
// are not used).  n_split is at most decode_mma_max_splits(R, D).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* pos, void* o, void* scratch, int B, int L,
                                     int KV, int R, int D, int cur, int n_split, int chunk,
                                     float scale, float softcap, int window, void* mid,
                                     void* stream) {
  const Args a{q, k, v, static_cast<const int*>(pos), o, static_cast<float*>(scratch),
               B, L, KV, R, cur, n_split, chunk, scale, softcap, window};
  if (!valid(a, 1) || n_split > tc::kMaxSplits) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return dispatch_mma<64>(a, st);
    case 128: return dispatch_mma<128>(a, st);
    case 256: return dispatch_mma<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
