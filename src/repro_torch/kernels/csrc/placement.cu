// Best-fit placement scores: the controller's greedy-repair candidate matrix.
//
// Replaces the reference's jax-traced broadcast in
// repro/core/binpack/heuristics.py placement_scores (its XLA branch, taken
// there from 2^20 candidates up).  For every (item i, choice c, open bin p):
//
//     fit   = all_d req[i, c, d] <= resid[p, d] + 1e-9, and mask[i, c]
//     score = fit ? max_d (resid[p, d] - req[i, c, d]) / max(resid[p, d], 1e-300)
//                 : +inf
//
// out is (k, C, P) float64.  The arithmetic is one add, a subtraction, a
// division and compares in float64, each rounded once (built with
// --fmad=false), so the result is placement_scores_np's and the plain
// version's (kernels/placement.py: placement_scores_plain) bit for bit.
//
// Bound on the card: bytes.  Each output is 8 bytes written once; the
// inputs (k C dim + P dim doubles and k C mask bytes) are small beside it.
// At the controller's sizes (a few thousand candidates to some 64,000) the
// call is far below a microsecond of bytes, so its time is latency: the
// launch, one round trip to memory for the inputs, the stores.
//
// Design: a 2-D grid, (i, c) rows on x (kRows a CTA, one warp a row) and
// blocks of kBins bins on y (a lane a bin), so no thread divides a flat
// index; every index is 32-bit (the wrapper checks that k C P and k C dim
// fit).  All of a thread's loads are issued before its first compare: its
// mask byte, its row's requirements and its bin's residuals (into registers
// as 16-byte words where dim is the fleet's 4: cores, memory and two
// accelerator dimensions; read in the loop for any other dim).  A warp's
// stores of a row are one coalesced 256-byte run.  On an H100 at 22 x 2 x
// 38 and 500 x 2 x 64 this ran 6.1 and 6.5 us cold against an empty
// launch's 5.1 and 4.7 (scripts/torch_placement_probe.py); two bins a
// thread with one 16-byte store ran some 1.1 us slower (each thread's
// divisions in series), the bins' residuals staged in shared memory by a
// cooperative load some 0.4 us slower (its barrier).
// `placement_empty` is a kernel of the same launch shape that does nothing:
// its time is the call's floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                // (i, c) rows a CTA, a warp each
constexpr int kBins = 32;               // bins a CTA, a lane each
constexpr int kThreads = kRows * kBins;
__device__ constexpr double kFitEps = 1e-9;
__device__ constexpr double kTiny = 1e-300;

// One dimension of a (row, bin) score: requirement rv, the bin's residual
// cap; d == 0 starts the slack.
__device__ __forceinline__ void fold(double rv, double cap, int d, bool& fit, double& slack) {
  fit = fit && (rv <= cap + kFitEps);
  const double q = (cap - rv) / (cap > kTiny ? cap : kTiny);
  slack = (d == 0 || q > slack) ? q : slack;
}

// DIM 4 (the requirement and residual rows in registers), or 0 for any dim
// (read in the loop).  Grid (ceil(rows / kRows), ceil(P / kBins)), block
// (kBins, kRows).
template <int DIM>
__global__ void __launch_bounds__(kThreads)
    placement_scores(const double* __restrict__ req, const uint8_t* __restrict__ mask,
                     const double* __restrict__ resid, int rows, int p_n, int dim,
                     double* __restrict__ out) {
  const int row = blockIdx.x * kRows + threadIdx.y;
  const int p = blockIdx.y * kBins + threadIdx.x;
  if (row >= rows || p >= p_n) return;
  bool fit = mask[row] != 0;
  double slack = 0.0;
  if constexpr (DIM == 4) {
    const double2* r2 = reinterpret_cast<const double2*>(req + row * 4);
    const double2* c2 = reinterpret_cast<const double2*>(resid + p * 4);
    const double2 r01 = r2[0], r23 = r2[1], c01 = c2[0], c23 = c2[1];
    fold(r01.x, c01.x, 0, fit, slack);
    fold(r01.y, c01.y, 1, fit, slack);
    fold(r23.x, c23.x, 2, fit, slack);
    fold(r23.y, c23.y, 3, fit, slack);
  } else {
    for (int d = 0; d < dim; ++d) fold(req[row * dim + d], resid[p * dim + d], d, fit, slack);
  }
  out[row * p_n + p] = fit ? slack : __longlong_as_double(0x7ff0000000000000ll);
}

__global__ void __launch_bounds__(kThreads) placement_empty() {}

// The launch shape of both kernels; a CUDA error code where the shape is
// not one the kernels take.
int shape(int k, int c, int p_n, int dim, dim3* grid) {
  if (k < 1 || c < 1 || p_n < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)k * c;
  if (rows * p_n > 0x7fffffffll || rows * dim > 0x7fffffffll ||
      (long long)p_n * dim > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const long long bin_blocks = (p_n + kBins - 1) / kBins;
  if (bin_blocks > 65535) return (int)cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>((rows + kRows - 1) / kRows),
               static_cast<unsigned>(bin_blocks));
  return 0;
}

}  // namespace

extern "C" {

// req (k, C, dim) float64, mask (k, C) uint8, resid (P, dim) float64, out
// (k, C, P) float64; k C P, k C dim and P dim below 2^31, P below 2^21.
// Returns a CUDA error code (0 on success).
int placement_scores_f64(const void* req, const void* mask, const void* resid, int k, int c,
                         int p_n, int dim, void* out, void* stream) {
  dim3 grid;
  const int err = shape(k, c, p_n, dim, &grid);
  if (err != 0) return err;
  const dim3 block(kBins, kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* rq = static_cast<const double*>(req);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* rs = static_cast<const double*>(resid);
  auto* o = static_cast<double*>(out);
  // 16-byte rows where dim is 4 and both bases are on 16 bytes.
  if (dim == 4 && reinterpret_cast<uintptr_t>(req) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(resid) % 16 == 0)
    placement_scores<4><<<grid, block, 0, st>>>(rq, mk, rs, k * c, p_n, dim, o);
  else
    placement_scores<0><<<grid, block, 0, st>>>(rq, mk, rs, k * c, p_n, dim, o);
  return (int)cudaGetLastError();
}

// `placement_empty` on the launch shape placement_scores_f64 takes for
// (k, C, P, dim): the call's floor.
int placement_empty_f64(int k, int c, int p_n, int dim, void* stream) {
  dim3 grid;
  const int err = shape(k, c, p_n, dim, &grid);
  if (err != 0) return err;
  placement_empty<<<grid, dim3(kBins, kRows), 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
