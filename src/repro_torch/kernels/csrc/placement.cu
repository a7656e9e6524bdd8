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
//
// Design: one thread an output, looping over dim; consecutive threads take
// consecutive bins p of one (i, c), so the stores coalesce and the
// requirement row is one broadcast load a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
__device__ constexpr double kFitEps = 1e-9;
__device__ constexpr double kTiny = 1e-300;

__global__ void __launch_bounds__(kThreads)
    placement_scores(const double* __restrict__ req, const uint8_t* __restrict__ mask,
                     const double* __restrict__ resid, long long total, int p_n, int dim,
                     double* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long ic = idx / p_n;  // flat (item, choice)
  const int p = (int)(idx - ic * p_n);
  const double* r = req + ic * dim;
  const double* rb = resid + (long long)p * dim;
  bool fit = mask[ic] != 0;
  double slack = 0.0;
  for (int d = 0; d < dim; ++d) {
    const double rv = r[d];
    const double cap = rb[d];
    fit = fit && (rv <= cap + kFitEps);
    const double q = (cap - rv) / (cap > kTiny ? cap : kTiny);
    slack = (d == 0 || q > slack) ? q : slack;
  }
  out[idx] = fit ? slack : __longlong_as_double(0x7ff0000000000000ll);
}

}  // namespace

extern "C" {

// req (k, C, dim) float64, mask (k, C) uint8, resid (P, dim) float64, out
// (k, C, P) float64.  Returns a CUDA error code (0 on success).
int placement_scores_f64(const void* req, const void* mask, const void* resid, int k, int c,
                         int p_n, int dim, void* out, void* stream) {
  if (k < 1 || c < 1 || p_n < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)k * c * p_n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  placement_scores<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(req), static_cast<const uint8_t*>(mask),
      static_cast<const double*>(resid), total, p_n, dim, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
