// Multiple-choice FFD/BFD scan over many fleets: the what-if packing kernel.
//
// Replaces the reference's jax-traced scan repro/core/binpack/heuristics.py
// _pack_core (a lax.scan over items, vmapped over fleets by _batched_kernel
// and fanned over devices by _pmap_kernel).  One CTA packs one fleet.  For
// each step s, item i = order[b, s] with requirement rows req[b, i, c, :]:
//
//     new_load = load[bin, :] + req[c, :]
//     fit      = all_d new_load <= cap[bin, d] + 1e-9, and mask[b, i, c]
//     slack    = max_d (cap[bin, d] - new_load[d]) / max(cap[bin, d], 1e-300)
//
// over every (open bin, choice) pair, flattened bin-major.  First fit takes
// the first fitting pair; best fit the pair of least slack, the first of
// equals.  With no fitting pair, the bin type and choice of least
// open_score[b, i, :, :] (flattened type-major, the first of equals) open a
// new bin.  A step whose item has no valid choice is a padding item: it
// changes nothing and records -1.  Records per step: the bin, the choice and
// the type opened (-1 when an open bin took the item); per fleet the bins
// opened and their summed cost, added in step order as Solution.cost sums
// its bins and as Python's sum adds floats (Neumaier's compensated sum,
// Python 3.12 and later).  The arithmetic is adds, a division and compares
// in float64, each rounded once (built with --fmad=false), so the result is
// the plain version's (kernels/pack.py: pack_scan_plain) bit for bit.
//
// Bound on the card: the inputs and records are read and written once, some
// 0.5 MB for a cone of 4 fleets of 500 streams over 10 instance types (0.15
// us at 3.35 TB/s).  The real floor is the n dependent steps of the scan:
// each step's decision needs the loads the step before it wrote.
//
// Design.
//   - One CTA a fleet, kThreads threads over the (open bin, choice) pairs of
//     a step; each thread keeps its least (score, pair) key, first fit's
//     score being 0 for a fitting pair, and one block reduction (warp
//     shuffles, then one warp over the warps' keys) picks the pair: the
//     smaller score wins, then the smaller pair index, which is the
//     reference's first-occurrence argmin / argmax.
//   - The open bins' loads and capacities stay in shared memory (variant
//     "shared"), or in a global scratch of (B, n, dim) each when a fleet's
//     2 n dim doubles outgrow it (variant "global"); the wrapper picks the
//     variant by shape (kernels/pack.py: _variant).
//   - The fleet's order sits in shared memory (int32) and the step's
//     requirement rows and mask are staged there by all threads, so the
//     pair loop reads shared memory only.
//   - Thread 0 applies the decision: adds the rows to the bin's load, or
//     scans the item's open scores (n_bt x C, small) and opens a bin, and
//     writes the records.  Two barriers a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
__device__ constexpr double kFitEps = 1e-9;
__device__ constexpr double kTiny = 1e-300;

struct Key {
  double score;
  int pair;
};

__device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000ll); }

__device__ __forceinline__ bool before(const Key& a, const Key& b) {
  return a.score < b.score || (a.score == b.score && a.pair < b.pair);
}

__device__ __forceinline__ Key warp_min(Key k) {
  for (int off = 16; off > 0; off >>= 1) {
    Key o;
    o.score = __shfl_down_sync(0xffffffffu, k.score, off);
    o.pair = __shfl_down_sync(0xffffffffu, k.pair, off);
    if (before(o, k)) k = o;
  }
  return k;
}

// Shared-memory bytes of one CTA: the loads and capacities of up to n open
// bins (variant "shared" only), the staged rows (C x dim doubles), the
// warps' keys, the order (n int32), the staged mask (C bytes).
__host__ __device__ long long smem_bytes(int shared_state, int n, int c, int dim) {
  long long doubles = (shared_state ? 2ll * n * dim : 0ll) + (long long)c * dim;
  long long bytes = doubles * 8 + kWarps * 16 + 16 + 4ll * n + c;
  return (bytes + 15) / 16 * 16;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    pack_scan(const double* __restrict__ req, const uint8_t* __restrict__ mask,
              const double* __restrict__ open_score, const int64_t* __restrict__ order,
              const double* __restrict__ caps, const double* __restrict__ costs, int n, int c,
              int dim, int n_bt, int best_fit, double* __restrict__ scratch,
              int64_t* __restrict__ bin_rec, int64_t* __restrict__ choice_rec,
              int64_t* __restrict__ bt_rec, int64_t* __restrict__ n_open_out,
              double* __restrict__ total_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  double* cursor = reinterpret_cast<double*>(smem);
  double* loads;
  double* caps_open;
  if (kShared) {
    loads = cursor;
    caps_open = cursor + (size_t)n * dim;
    cursor += 2 * (size_t)n * dim;
  } else {
    loads = scratch + (size_t)b * 2 * n * dim;
    caps_open = loads + (size_t)n * dim;
  }
  double* row = cursor;  // (C, dim) requirement rows of the step's item
  Key* keys = reinterpret_cast<Key*>(row + (size_t)c * dim);  // (kWarps + 1)
  int* order_s = reinterpret_cast<int*>(keys + kWarps + 1);
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(order_s + n);
  __shared__ int n_open_s;

  const int64_t* order_b = order + (size_t)b * n;
  for (int i = tid; i < n; i += kThreads) order_s[i] = static_cast<int>(order_b[i]);
  for (size_t i = tid; i < (size_t)n * dim; i += kThreads) loads[i] = 0.0;
  if (tid == 0) n_open_s = 0;
  double total = 0.0, comp = 0.0;  // thread 0's compensated sum of costs
  __syncthreads();

  const int row_len = c * dim;
  for (int s = 0; s < n; ++s) {
    const int item = order_s[s];
    const double* req_i = req + ((size_t)b * n + item) * row_len;
    const uint8_t* mask_i = mask + ((size_t)b * n + item) * c;
    for (int j = tid; j < row_len; j += kThreads) row[j] = req_i[j];
    for (int j = tid; j < c; j += kThreads) mask_s[j] = mask_i[j];
    __syncthreads();
    const int n_open = n_open_s;

    Key k = {inf(), 0x7fffffff};
    const int pairs = n_open * c;
    for (int p = tid; p < pairs; p += kThreads) {
      const int bin = p / c;
      const int ch = p - bin * c;
      if (!mask_s[ch]) continue;
      const double* ld = loads + (size_t)bin * dim;
      const double* cp = caps_open + (size_t)bin * dim;
      const double* rq = row + (size_t)ch * dim;
      bool fit = true;
      double slack = 0.0;
      for (int d = 0; d < dim; ++d) {
        const double nl = ld[d] + rq[d];
        const double cap = cp[d];
        fit = fit && (nl <= cap + kFitEps);
        if (best_fit) {
          const double q = (cap - nl) / (cap > kTiny ? cap : kTiny);
          slack = (d == 0 || q > slack) ? q : slack;
        }
      }
      if (!fit) continue;
      const Key cand = {best_fit ? slack : 0.0, p};
      if (before(cand, k)) k = cand;
    }
    k = warp_min(k);
    if ((tid & 31) == 0) keys[tid >> 5] = k;
    __syncthreads();
    if (tid < 32) {
      Key w = tid < kWarps ? keys[tid] : Key{inf(), 0x7fffffff};
      w = warp_min(w);
      if (tid == 0) {
        bool valid = false;
        for (int j = 0; j < c; ++j) valid = valid || mask_s[j];
        int64_t bin_out = -1, choice_out = -1, bt_out = -1;
        if (valid) {
          int bin, ch;
          if (w.score < inf()) {  // an open bin takes the item
            bin = w.pair / c;
            ch = w.pair - bin * c;
          } else {  // open the bin type and choice of least open score
            const double* sc = open_score + ((size_t)b * n + item) * n_bt * c;
            int best = 0;
            double best_v = sc[0];
            for (int j = 1; j < n_bt * c; ++j)
              if (sc[j] < best_v) {
                best_v = sc[j];
                best = j;
              }
            const int bt = best / c;
            ch = best - bt * c;
            bin = n_open;
            for (int d = 0; d < dim; ++d) caps_open[(size_t)bin * dim + d] = caps[(size_t)bt * dim + d];
            const double x = costs[bt];
            const double t = total + x;
            comp += fabs(total) >= fabs(x) ? (total - t) + x : (x - t) + total;
            total = t;
            n_open_s = n_open + 1;
            bt_out = bt;
          }
          for (int d = 0; d < dim; ++d)
            loads[(size_t)bin * dim + d] = loads[(size_t)bin * dim + d] + row[(size_t)ch * dim + d];
          bin_out = bin;
          choice_out = ch;
        }
        bin_rec[(size_t)b * n + s] = bin_out;
        choice_rec[(size_t)b * n + s] = choice_out;
        bt_rec[(size_t)b * n + s] = bt_out;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    n_open_out[b] = n_open_s;
    total_out[b] = (comp != 0.0 && isfinite(comp)) ? total + comp : total;
  }
}

}  // namespace

extern "C" {

// variant 0 ("shared"): loads and capacities in shared memory; variant 1
// ("global"): in scratch, (B, 2, n, dim) float64.  req (B, n, C, dim)
// float64, mask (B, n, C) uint8, open_score (B, n, n_bt, C) float64, order
// (B, n) int64, caps (n_bt, dim) float64, costs (n_bt,) float64; records
// (B, n) int64 each, n_open (B,) int64, total (B,) float64.  Returns a CUDA
// error code (0 on success).
int pack_scan_f64(int variant, int best_fit, const void* req, const void* mask,
                  const void* open_score, const void* order, const void* caps, const void* costs,
                  int n_batch, int n, int c, int dim, int n_bt, void* scratch, void* bin_rec,
                  void* choice_rec, void* bt_rec, void* n_open, void* total, void* stream) {
  if (n_batch < 1 || n < 1 || c < 1 || dim < 1 || n_bt < 1 || (variant != 0 && variant != 1) ||
      (long long)n * c > 0x7fffffffll || (variant == 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(variant == 0, n, c, dim);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const auto* rq = static_cast<const double*>(req);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* sc = static_cast<const double*>(open_score);
  const auto* od = static_cast<const int64_t*>(order);
  const auto* cp = static_cast<const double*>(caps);
  const auto* co = static_cast<const double*>(costs);
  auto* sr = static_cast<double*>(scratch);
  auto* br = static_cast<int64_t*>(bin_rec);
  auto* cr = static_cast<int64_t*>(choice_rec);
  auto* tr = static_cast<int64_t*>(bt_rec);
  auto* no = static_cast<int64_t*>(n_open);
  auto* to = static_cast<double*>(total);
  if (variant == 0) {
    err = cudaFuncSetAttribute(pack_scan<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    pack_scan<true><<<n_batch, kThreads, (size_t)smem, st>>>(
        rq, mk, sc, od, cp, co, n, c, dim, n_bt, best_fit, sr, br, cr, tr, no, to);
  } else {
    err = cudaFuncSetAttribute(pack_scan<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    pack_scan<false><<<n_batch, kThreads, (size_t)smem, st>>>(
        rq, mk, sc, od, cp, co, n, c, dim, n_bt, best_fit, sr, br, cr, tr, no, to);
  }
  return (int)cudaGetLastError();
}

// Shared-memory bytes a CTA of `variant` takes for a fleet of n items with C
// choices over dim dimensions, and the most a block may take: the wrapper
// picks the variant from these (kernels/pack.py: _variant).
long long pack_scan_smem_bytes(int variant, int n, int c, int dim) {
  return smem_bytes(variant == 0, n, c, dim);
}

long long pack_scan_max_smem() { return kMaxSmem; }

}  // extern "C"
