"""The card's mma.sync rate: how many m16n8k16 bf16 products an SM issues a
cycle, by the warps of one CTA, each with a few independent accumulator
chains and nothing else to do.  The yardstick for the port's kernels built
on mma.sync (their achieved rate is their products over their time).

Builds a small CUDA program with nvcc under ``build/mma_sync_rate/`` and
runs it; prints, per (chains a warp, warps), the cycles between a warp's
products and the SM's products a cycle and a microsecond, then the card's
name and power limit.  Needs a card and nvcc::

    python scripts/torch_mma_sync_rate.py
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_sync_rate"

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CHAINS>
__global__ void chains(float* out, int iters, long long* cycles) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float d[CHAINS][4] = {};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) mma(d[k], a, 0x3f803f80u + i, 0x3f803f80u);
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}
template <int CHAINS>
void run(int warps) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 1 << 20);
  cudaMalloc(&cyc, 8);
  const int iters = 4096;
  chains<CHAINS><<<1, 32 * warps>>>(out, iters, cyc);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<CHAINS><<<1, 32 * warps>>>(out, iters, cyc);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c = 0;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  const double n = (double)iters * CHAINS;
  printf("chains %2d warps %2d: %5.1f cycles between a warp's products, %.3f products a cycle "
         "an SM, %.0f products a microsecond an SM (launch included)\n", CHAINS, warps, c / n,
         n * warps / c, n * warps / (ms * 1e3));
  cudaFree(out);
  cudaFree(cyc);
}
int main() {
  run<1>(1); run<8>(1); run<1>(8); run<2>(8); run<4>(8); run<8>(8); run<8>(16);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "mma_sync_rate.cu", OUT / "mma_sync_rate"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(src)], check=True)
    rc = subprocess.run([str(exe)]).returncode
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
