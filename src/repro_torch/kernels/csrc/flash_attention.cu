// Causal flash attention with GQA, sliding window and logit softcap, for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/attention.py:75 flash_attention
// (body _kernel, :24): o = softmax(mask(softcap(q k^T / sqrt(D)))) v over
// positions 0..S-1, query head h reading KV head h / (H / KV), with the
// online softmax (acc, m, l) in float32, the mask value -2e38 and the
// normaliser max(l, 1e-37) of the TPU kernel.
//
// Bound on an H100 SXM at the served prefill (gemma2-2b: B=4, S=2048,
// H=8, KV=4, D=256, causal): 4*B*H*D*S(S+1)/2 = 68.7 GFLOP, 69 us at the
// 989 TFLOP/s of bf16 tensor cores, against 100.7 MB of q, k, v and o,
// 30 us at 3.35 TB/s: compute-bound, so only the tensor cores come near it.
//
// Two variants, picked by dtype alone (attention.py:_variant):
//
// 1. wgmma (bf16; D = 64, 128 or 256; every served prefill): one CTA per
//    (b, h, 128-query block), launched heaviest (latest queries) first
//    across all heads, of two warpgroups that own 64 query rows each.
//    - Loads: thread 0 loads the q block once and the K and V tiles
//      through a ring (2 stages at D=256, 3 below), each stage with a full
//      and an empty mbarrier, all by TMA; it refills the stage of tile i - 1
//      at the start of tile i.  Thread 0 waits on that stage's empty
//      barrier first, so warpgroup 0's products wait for warpgroup 1 to
//      release tile i - 1: the two warpgroups run in lockstep.  There is no
//      producer warp: ptxas budgets
//      65,536 / 384 = 168 registers a thread for a CTA of two warpgroups and
//      a producer warp, and does not budget the consumers' code at a
//      setmaxnreg.inc (tried: 24/240, 40/232, 56/224, a warp-uniform
//      branch), which left 844 bytes of spills at D=256.  Two warpgroups
//      alone get 255.  The tensor maps are 3-D, (H*D, S, B) for q and
//      (KV*D, S, B) for k and v, in boxes of 64 columns (128 bytes) with
//      128-byte swizzle: rows past S are zero-filled, never read from the
//      next sequence.  A key tile is 64 keys at D=256 and 128 below, so
//      shared memory holds q 64 KB + 2 x (K 32 KB + V 32 KB) at D=256 and
//      q 32 KB + 3 x 64 KB at D=128.
//    - S = q k^T: wgmma m64nBKk16 with both operands K-major in shared
//      memory.  Scale, softcap (accurate tanhf), mask and the online
//      softmax run on the float32 accumulator fragment in registers, in
//      base 2 (scores times log2 e, exp2f); row reductions are quad
//      shuffles.  Only tiles on the causal diagonal, at the window's edge
//      or past S apply the mask; tiles the window empties are never loaded.
//    - O += P V: wgmma with A in registers.  The S fragment, packed as
//      bf16x2, is the A fragment of each k16 step (hopper_common.cuh), and
//      V is the MN-major B operand (tnspB = 1; LBO the stride between
//      64-column boxes, SBO 1 KB).  The TPU kernel multiplies a float32 p;
//      rounding p once to bf16 puts 5-7% of the outputs outside the card
//      tolerance (one bf16 ulp plus 1e-4) at the tests' shapes.  So p is
//      split into hi = bf16(p) and lo = bf16(p - hi), both multiplied into
//      the float32 accumulator: 1.5x the bound's tensor work, and no
//      output outside.  l is summed from the float32 p.
//    - The output is normalised, rounded once to bf16 and stored from
//      registers, rows past S masked.
//    - Every mbarrier wait traps after about 2^30 polls: a lost arrival or
//      a wrong byte count fails the launch instead of hanging the card.
// 2. simt (float32; phase 8's float32 models): TF32 would break the float32
//    2e-5 limit, so both products are float32 FMAs.  The TPU kernel walks
//    its (b, h, q block, kv block) grid in order and carries the softmax
//    state in VMEM across kv steps.  Here one CTA of 128 threads owns one
//    (b, h, 32-query block) and loops over the K/V tiles itself, from the
//    first key the window can reach to the causal diagonal, skipping tiles
//    the mask empties entirely; no state crosses CTAs.  Blocks are
//    launched heaviest first.  The q block and each K/V tile are copied
//    into shared memory with cp.async.  Each warp owns 8 query rows for the
//    whole tile: its lanes split the tile's keys for q k^T, reduce row max
//    and sum with shuffles, write p to shared memory, and split the head
//    dimension for p v, so the accumulator (8 rows x D/32 columns a lane,
//    64 floats at D=256) stays in registers and only the K/V tile loads
//    need the whole CTA to synchronise.  Keys and queries past S (a ragged
//    tail) are zero-filled and masked.
//
// Both kernels optionally write each row's logsumexp, float32 (B, H, S), for
// the backward (flash_attention_bwd.cu): lse = m + log(l), the natural log
// of the sum of exp over the row's masked, capped, scaled scores.  The
// wgmma kernel runs its softmax in base 2 (m in units of log2 e times the
// score), so it stores (m + log2 l) * ln 2, converted once a row; the simt
// kernel's softmax is in base e and stores m + log l.  A null pointer
// writes nothing, which is what serving passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------- simt

constexpr int kBlockQ = 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;

template <typename T, int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBlockQ + 2 * tile_rows<T>()) * (D + kPad) * sizeof(T) +
         static_cast<size_t>(kBlockQ) * (tile_rows<T>() + 4) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, float scale,
               float softcap, int window) {
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
    if (lse != nullptr && lane == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qpos] = m[r] + logf(l[r]);
    T* o_row = o + static_cast<size_t>(b) * S * q_stride + qpos * q_stride +
               static_cast<size_t>(h) * D + lane * VEC;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) store(o_row + c * 32 * VEC + e, acc[r][c][e] / denom);
  }
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int H, int KV, float scale, float softcap, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto kernel = flash_simt<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma

namespace wg {

constexpr int BQ = 128;                      // query rows a CTA
constexpr int kWarpgroups = 2;               // of 64 query rows each
constexpr int kThreads = kWarpgroups * 128;  // thread 0 also issues every load
__device__ constexpr float kLog2e = 1.4426950408889634f;
__device__ constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;   // keys a tile
  static constexpr int STAGES = D == 256 ? 2 : 3;  // K/V stages in the ring
  static constexpr int kBoxes = D / 64;            // 64-column (128-byte) boxes a row
  static constexpr int kQBox = BQ * 128;           // bytes of one q box
  static constexpr int kKVBox = BK * 128;          // bytes of one K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one K or V tile
  static constexpr int kStage = 2 * kKVBytes;
  static constexpr int kSmem = kQBytes + STAGES * kStage + 1024;  // and room to align to 1 KB
  static constexpr int kNO = D == 64 ? 64 : 128;  // output columns of one P V product
  static constexpr int kNH = D / kNO;             // P V products a k16 step
};

__device__ __forceinline__ void mma_qk(float (&s)[32], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n64k16_ss_kmaj(s, a, b, acc);
}
__device__ __forceinline__ void mma_qk(float (&s)[64], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n128k16_ss_kmaj(s, a, b, acc);
}
__device__ __forceinline__ void mma_pv(float (&o)[32], const uint32_t (&p)[4], uint64_t b) {
  hopper::wgmma_m64n64k16_rs_mnmaj(o, p, b);
}
__device__ __forceinline__ void mma_pv(float (&o)[64], const uint32_t (&p)[4], uint64_t b) {
  hopper::wgmma_m64n128k16_rs_mnmaj(o, p, b);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Over the four lanes that hold one row of a fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int S, int H, int KV, float scale, float softcap,
                int window) {
  using namespace hopper;
  using T = Tile<D>;
  constexpr int BK = T::BK, STAGES = T::STAGES, kNO = T::kNO, kNH = T::kNH;
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t smem_tiles[];
  // Swizzle atoms must start 1024-byte aligned in the shared window.
  uint8_t* smem = smem_tiles + ((1024u - (smem_addr(smem_tiles) & 1023u)) & 1023u);
  uint8_t* qs = smem;
  uint8_t* ring = smem + T::kQBytes;

  // Query blocks heaviest first, each over every (b, h) before the next.
  const int n_qb = (S + BQ - 1) / BQ;
  const int heads = gridDim.x / n_qb;  // B * H
  const int q0 = (n_qb - 1 - static_cast<int>(blockIdx.x) / heads) * BQ;
  const int h = blockIdx.x % heads % H;
  const int b = blockIdx.x % heads / H;
  const int g = h / (H / KV);
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_first / BK;
  const int n_tiles = q_last / BK + 1 - t_first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Thread 0 loads K/V tile i into stage i % STAGES once the 8 warps have
  // released the tile that stage held before (its empty barrier's phase).
  auto load_tile = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    uint8_t* st = ring + s * T::kStage;
    mbar_arrive_expect_tx(&full[s], T::kStage);
    const int k0 = (t_first + i) * BK;
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(st + j * T::kKVBox, &kmap, &full[s], g * D + 64 * j, k0, b);
      tma_load_3d(st + T::kKVBytes + j * T::kKVBox, &vmap, &full[s], g * D + 64 * j, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                 // thread 0's arrive.expect_tx
      mbar_init(&empty[s], kWarpgroups * 4);  // one arrival per warp
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&q_full, T::kQBytes);
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load_3d(qs + j * T::kQBox, &qmap, &q_full, h * D + 64 * j, q0, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_tile(i);
  }
  __syncthreads();

  // This thread's rows (the fragment layout in hopper_common.cuh).
  const int wgi = warp / 4;
  const int row0 = q0 + 64 * wgi + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const int col_in = 2 * (lane % 4);
  const bool capped = softcap > 0.f;
  const float scale2 = scale * kLog2e;
  const float inv_cap = capped ? 1.f / softcap : 0.f;
  const uint8_t* qw = qs + wgi * 64 * 128;  // this warpgroup's rows of each q box

  float acc[kNH][kNO / 2];
  float sc[BK / 2];
#pragma unroll
  for (int n = 0; n < kNH; ++n)
#pragma unroll
    for (int i = 0; i < kNO / 2; ++i) acc[n][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (t_first + i) * BK;
    // The stage that tile i - 1 held takes tile i - 1 + STAGES; by now the
    // other warpgroup has mostly released it too.
    if (threadIdx.x == 0 && i >= 1 && i - 1 + STAGES < n_tiles) load_tile(i - 1 + STAGES);
    __syncwarp();
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* ks = ring + s * T::kStage;
    const uint8_t* vs = ks + T::kKVBytes;

    // S = q k^T over D: k16 step kk reads 32 bytes along the swizzled rows
    // of box kk / 4 of both operands.
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int j = kk / 4, off = (kk % 4) * 32;
      mma_qk(sc, smem_desc_b128(qw + j * T::kQBox + off, 16, 1024),
             smem_desc_b128(ks + j * T::kKVBox + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // Scale, softcap and (on edge tiles) mask, in base 2; sc[4 j + 2 hh + c]
    // is row row0 + 8 hh, key k0 + 8 j + col_in + c.
    const bool edge = k0 + BK - 1 > q0 || k0 + BK > S || (window > 0 && k0 <= q_last - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int idx = 0; idx < BK / 2; ++idx) {
      const int hh = (idx / 2) % 2;
      float x = capped ? softcap * tanhf(sc[idx] * scale * inv_cap) * kLog2e : sc[idx] * scale2;
      if (edge) {
        const int row = row0 + 8 * hh;
        const int col = k0 + 8 * (idx / 4) + col_in + idx % 2;
        if (!(col <= row && col < S && (window <= 0 || col > row - window))) x = kNegInf;
      }
      sc[idx] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
    // p, and its hi and lo bf16 halves as the A fragments of the k16 steps.
    float sum[2] = {0.f, 0.f};
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int idx = 8 * t + 2 * a, hh = a % 2;
        const float p0 = exp2f(sc[idx] - m[hh]), p1 = exp2f(sc[idx + 1] - m[hh]);
        sum[hh] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        p_hi[t][a] = bits(hi);
        p_lo[t][a] = bits(__floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi)));
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + quad_sum(sum[hh]);
#pragma unroll
    for (int n = 0; n < kNH; ++n)
#pragma unroll
      for (int idx = 0; idx < kNO / 2; ++idx) acc[n][idx] *= alpha[(idx / 2) % 2];

    // O += p_hi V + p_lo V: k16 step t reads 16 key rows (2 KB) down each
    // 64-column V box; a product of kNO columns spans kNO / 64 boxes.
#pragma unroll
    for (int n = 0; n < kNH; ++n) reg_fence(acc[n]);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      reg_fence(p_hi[t]);
      reg_fence(p_lo[t]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int n = 0; n < kNH; ++n) {
        const uint64_t dv =
            smem_desc_b128(vs + n * (kNO / 64) * T::kKVBox + t * 16 * 128, T::kKVBox, 1024);
        mma_pv(acc[n], p_hi[t], dv);
        mma_pv(acc[n], p_lo[t], dv);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kNH; ++n) reg_fence(acc[n]);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      reg_fence(p_hi[t]);
      reg_fence(p_lo[t]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // acc[n][4 j + 2 hh + c] is row row0 + 8 hh, column n kNO + 8 j + col_in + c.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    const float denom = fmaxf(l[hh], kMinDenom);
    if (lse != nullptr && lane % 4 == 0)  // base 2 -> natural log, once a row
      lse[(static_cast<size_t>(b) * H + h) * S + row] = (m[hh] + log2f(l[hh])) * kLn2;
    __nv_bfloat16* out = o + (static_cast<size_t>(b) * S + row) * H * D +
                         static_cast<size_t>(h) * D + col_in;
#pragma unroll
    for (int n = 0; n < kNH; ++n)
#pragma unroll
      for (int j = 0; j < kNO / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + n * kNO + 8 * j) = __floats2bfloat162_rn(
            acc[n][4 * j + 2 * hh] / denom, acc[n][4 * j + 2 * hh + 1] / denom);
  }
}

}  // namespace wg

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                 int H, int KV, float scale, float softcap, int window, cudaStream_t st) {
  using T = wg::Tile<D>;
  const long long ctas = (static_cast<long long>(S) + wg::BQ - 1) / wg::BQ * H * B;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(H) * D, static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[2] = {static_cast<cuuint64_t>(H) * D * 2,
                                  static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t qbox[3] = {64, wg::BQ, 1};
  const cuuint64_t kvdims[3] = {static_cast<cuuint64_t>(KV) * D, static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t kvstrides[2] = {static_cast<cuuint64_t>(KV) * D * 2,
                                   static_cast<cuuint64_t>(S) * KV * D * 2};
  const cuuint32_t kvbox[3] = {64, T::BK, 1};
  int rc = hopper::encode_bf16_b128(&qmap, const_cast<void*>(q), 3, qdims, qstrides, qbox);
  if (rc == 0)
    rc = hopper::encode_bf16_b128(&kmap, const_cast<void*>(k), 3, kvdims, kvstrides, kvbox);
  if (rc == 0)
    rc = hopper::encode_bf16_b128(&vmap, const_cast<void*>(v), 3, kvdims, kvstrides, kvbox);
  if (rc != 0) return rc;
  auto kernel = wg::flash_wgmma<D>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(ctas), wg::kThreads, T::kSmem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, S, H, KV, scale, softcap, window);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KV) { return B < 1 || S < 1 || KV < 1 || H % KV != 0; }

}  // namespace

// q (B, S, H, D), k and v (B, S, KV, D), o (B, S, H, D), all contiguous
// and 16-byte aligned; D in {64, 128, 256}.  lse, when not null, receives
// each row's natural-log logsumexp, float32 (B, H, S).  softcap <= 0 means
// none, window <= 0 means none.  float32 runs the simt kernel, bf16 the wgmma
// kernel.  Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int S, int H, int KV, int D, float scale,
                                   float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_simt<float, 64>(q, k, v, o, lse, B, S, H, KV, scale, softcap, window, st);
    case 128:
      return launch_simt<float, 128>(q, k, v, o, lse, B, S, H, KV, scale, softcap, window, st);
    case 256:
      return launch_simt<float, 256>(q, k, v, o, lse, B, S, H, KV, scale, softcap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int S, int H, int KV, int D, float scale,
                                    float softcap, int window, void* stream) {
  if (bad_shape(B, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_wgmma<64>(q, k, v, o, lse, B, S, H, KV, scale, softcap, window, st);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, B, S, H, KV, scale, softcap, window, st);
    case 256: return launch_wgmma<256>(q, k, v, o, lse, B, S, H, KV, scale, softcap, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
