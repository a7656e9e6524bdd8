// Pieces of the grouped (ragged expert) GEMM shared by its forward
// (grouped_gemm.cu) and its backward (grouped_gemm_bwd.cu): element loads
// and stores in float32, the search that maps a CTA's row tile onto the
// experts' segments, and the zeroing of the rows outside every segment.
// Segments follow the forward's layout: expert e owns rows
// [offsets[e], offsets[e + 1]) of an (N, .) operand, each bound clamped
// into [0, N].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace grouped {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Warp 0 finds row tile `tile` (of BM rows) among the experts' segments and
// writes (expert, first row, end row) to info, expert -1 past the last tile.
// Each lane sums the tile counts of a contiguous run of experts; an
// inclusive scan over the lanes by shuffles gives each run's first tile.
template <int BM>
__device__ void find_tile(const int* __restrict__ offsets, int E, int N, int tile, int* info) {
  const int lane = threadIdx.x;
  const int per = (E + 31) / 32;
  const int e0 = min(E, lane * per), e1 = min(E, e0 + per);
  int local = 0;
  for (int e = e0; e < e1; ++e) {
    const int lo = min(max(offsets[e], 0), N);
    const int hi = min(max(offsets[e + 1], lo), N);
    local += (hi - lo + BM - 1) / BM;
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const bool mine = tile >= incl - local && tile < incl;
  if (mine) {
    int t = tile - (incl - local);
    for (int e = e0; e < e1; ++e) {
      const int lo = min(max(offsets[e], 0), N);
      const int hi = min(max(offsets[e + 1], lo), N);
      const int n = (hi - lo + BM - 1) / BM;
      if (t < n) {
        info[0] = e;
        info[1] = lo + t * BM;
        info[2] = hi;
        break;
      }
      t -= n;
    }
  }
  if (__ballot_sync(0xffffffffu, mine) == 0 && lane == 0) info[0] = -1;
}

// The segments cover [lo, hi) = [offsets[0], offsets[E]), clamped into
// [0, N].  Zeroes the rows of [r0, r1) outside it, in columns [c0, c1),
// with all `nthreads` threads of the CTA.
template <typename T>
__device__ void zero_outside(T* __restrict__ out, const int* __restrict__ offsets, int N, int F,
                             int E, int r0, int r1, int c0, int c1, int nthreads) {
  const int lo = min(max(offsets[0], 0), N);
  const int hi = min(max(offsets[E], lo), N);
  r1 = min(r1, N);
  c1 = min(c1, F);
  const int w = c1 - c0;
  if (w <= 0) return;
  const int ranges[2][2] = {{r0, min(r1, lo)}, {max(r0, hi), r1}};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int a = ranges[i][0], n = (ranges[i][1] - a) * w;
    for (int idx = threadIdx.x; idx < n; idx += nthreads)
      store(out + static_cast<size_t>(a + idx / w) * F + c0 + idx % w, 0.f);
  }
}

}  // namespace grouped
