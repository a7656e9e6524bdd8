// Warp-level tensor-core building blocks (mma.sync, ldmatrix, cp.async with
// commit groups) shared by decode_attention.cu and ssd.cu, as inline PTX.
//
// Fragments of mma.sync.m16n8k16 (bf16 in, float32 accumulate), for lane l
// of a warp, g = l / 4 and c = l % 4:
//   A (16 x 16, four bf16x2): a[0] = (row g, cols 2c, 2c+1), a[1] = (g + 8,
//     2c..), a[2] = (g, 2c + 8..), a[3] = (g + 8, 2c + 8..);
//   B (16 x 8, two bf16x2): b[0] = (rows 2c, 2c+1, col g), b[1] = (rows
//     2c + 8.., col g);
//   C and D (16 x 8 float32): d[0..1] = (row g, cols 2c, 2c+1), d[2..3] =
//     (row g + 8, cols 2c, 2c+1).
// The element with the lower column (A) or row (B) sits in the low half of
// a bf16x2.  ldmatrix gives these fragments from shared memory: without
// .trans from tiles stored with the fragment's contiguous index innermost
// (A row-major, B column-major), with .trans from the other layout.  The
// a_* and b_* helpers below give the row and column offsets (in elements,
// from the 16 x 16 block's corner in the stored tile) of the address lane l
// passes to ldmatrix.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- ldmatrix -------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Lane l's row and column offsets for ldsm_x4 of:
// - an A fragment from a row-major tile (rows m, columns k): a[0..3];
// - two B fragments from a column-major tile (rows n, columns k):
//   {b[0], b[1]} of columns n0..n0+7, then of n0+8..n0+15 (use with
//   b_nmajor_* below);
// - two B fragments from a row-major tile (rows k, columns n), with .trans;
// - an A fragment from a column-major tile (rows k, columns m), with .trans.
__device__ __forceinline__ int a_rowmajor_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_rowmajor_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_nmajor_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_nmajor_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int b_kmajor_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int b_kmajor_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int a_kmajor_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int a_kmajor_col(int lane) { return ((lane >> 3) & 1) * 8; }

// ---- mma ------------------------------------------------------------------------

// d += a b: m16n8k16, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as bf16 hi = bf16(x) and lo = bf16(x - hi), each packed as a
// bf16x2 with x0 in the low half: hi + lo carries about 16 bits of x.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---- cp.async with commit groups ------------------------------------------------

// 16 bytes global -> shared, L2 only; zero-filled (and nothing read) when
// `valid` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
