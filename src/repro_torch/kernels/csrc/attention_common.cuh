// Helpers shared by flash_attention.cu and decode_attention.cu (ssd.cu
// uses the type conversions and load4/dot4).
//
// Tiles of q, k and v sit in shared memory in the input type (float or
// bfloat16), rows padded by kPad elements, and are read four elements at a
// time and widened to float for SIMT float32 arithmetic.  With a row
// stride of D + 4 elements (D a multiple of 64), lanes that read the same
// column of 32 different rows hit distinct banks: 16-byte reads (float)
// are served a quarter-warp at a time and land on banks 4*row mod 32,
// 8-byte reads (bfloat16) a half-warp at a time on banks 2*row mod 32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;               // elements of padding per tile row
__device__ constexpr float kNegInf = -2.0e38f;  // the TPU kernels' mask value (not -inf)
__device__ constexpr float kMinDenom = 1e-37f;  // the TPU kernels' normaliser floor

// Keys per tile: bfloat16 tiles are half the bytes, so twice the rows.
template <typename T>
__host__ __device__ constexpr int tile_rows() { return sizeof(T) == 2 ? 64 : 32; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as jnp's astype
}

// Four consecutive elements widened to float (16-byte aligned for float,
// 8-byte aligned for bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Two consecutive elements widened to float.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float component(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Asynchronous copy of four elements global -> shared (cp.async, sm_80+);
// when `valid` is false nothing is read and the four elements are zeroed.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid);

template <>
__device__ __forceinline__ void cp_async<16>(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

template <>
__device__ __forceinline__ void cp_async<8>(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 8 : 0)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async4(T* smem, const T* gmem, bool valid) {
  cp_async<static_cast<int>(4 * sizeof(T))>(smem, gmem, valid);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `rows` rows of D elements, `row_stride` elements apart in global
// memory starting at `src`, into a shared tile with rows D + kPad apart.
// Rows at or past `valid_rows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* tile, const T* src, size_t row_stride,
                                          int rows, int valid_rows) {
  constexpr int kUnits = D / 4;
  for (int idx = threadIdx.x; idx < rows * kUnits; idx += kThreads) {
    const int row = idx / kUnits;
    const int col = (idx % kUnits) * 4;
    const bool ok = row < valid_rows;
    cp_async4(tile + row * (D + kPad) + col, ok ? src + row * row_stride + col : src, ok);
  }
}

}  // namespace attn
