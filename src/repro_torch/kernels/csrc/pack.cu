// Multiple-choice FFD/BFD scan over many fleets: the what-if packing kernel.
//
// Replaces the reference's jax-traced scan repro/core/binpack/heuristics.py
// _pack_core (a lax.scan over items, vmapped over fleets by _batched_kernel
// and fanned over devices by _pmap_kernel).  For each fleet b and step s,
// item i = order[b, s] with requirement rows req[b, i, c, :]:
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
// What held the earlier design (one CTA of 256 threads a fleet, 2.5-2.7 us
// a step): each step loaded the item's rows and mask from device memory
// behind a block barrier, sent the warps' keys through shared memory behind
// a second, and ended on a third; thread 0 then checked the item's validity
// and scanned its n_bt x C open scores from device memory, though both are
// functions of the item alone; 256 threads covered some 78 pairs.
//
// Design.
//   - Prologue, by all threads of the CTA: each fleet's rows, mask and order
//     into shared memory, and per item its validity and opening (type,
//     choice), the first of equals over the type-major flattening, as -1 for
//     a padding item.  None of it depends on the walk's state.
//   - Variant "warp": one warp a fleet, `fleets` fleets a CTA (the wrapper
//     picks them from B and the SM count, kernels/pack.py: launch_shape).
//     The catalog, the fleet's rows, mask, order, openings and its open
//     bins' loads and capacities stay in shared memory, the loads and
//     capacities a dimension at a time across the bins (no bank conflicts).
//     A step: lane l takes the open bins l, l + 32, ..., each bin's
//     choices in order (first fit stops at its first fitting pair), and
//     keeps its least key; the warp's least is one __reduce_min_sync of the
//     pair for first fit, three for best fit (the score's order-preserving
//     64 bits, high word then low, then the pair among equals); every lane
//     then knows the decision, lanes over the dimensions apply it, lane 0
//     keeps Neumaier's sum in step order, and one __syncwarp ends the step.
//     The next two steps' items and openings are read ahead, the item's
//     rows and mask held in registers, and the records written 32 steps at
//     a time, one a lane.  No block barrier and no read of device memory on
//     the walk.  The live loop's shape (4 dimensions, 2 choices) and each
//     fit rule have kernels of their own.
//
// What holds it (PERF.md section 6 has the numbers): the step's dependent
// chain, its shared-memory round trips and reductions included; the empty
// walk (pack_scan_probe_f64) alone takes some 40% of a step of the
// lifecycle cone.
//   - Variant "global", the block-wide path for fleets whose rows and state
//     outgrow a CTA's shared memory: one CTA of kThreads a fleet, the open
//     bins' loads and capacities in a global scratch of (B, 2, n, dim), the
//     step's rows staged in shared memory, a block reduction on (score,
//     pair), thread 0 applying the decision with the prologue's opening.
//   - pack_scan_probe_f64, the warp walk without the pair loop (no pair ever
//     fits, every valid item opens a bin): the floor the walk's skeleton sets,
//     for measurement only; its records are not the scan's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFleets = 8;       // fleets a CTA of the warp variant
constexpr int kMaxSmem = 232448;    // bytes a block may use on sm_90
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

// The least Key of the warp, on every lane: a non-NaN score's bits mapped
// to an unsigned order (zero of either sign as +0, which `<` holds equal),
// reduced high word, low word, then the pair among the lanes that tie.
__device__ __forceinline__ Key warp_min_all(Key k) {
  const double s = k.score == 0.0 ? 0.0 : k.score;
  unsigned long long u = static_cast<unsigned long long>(__double_as_longlong(s));
  u = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
  const unsigned hi = static_cast<unsigned>(u >> 32), lo = static_cast<unsigned>(u);
  const unsigned m_hi = __reduce_min_sync(0xffffffffu, hi);
  const unsigned m_lo = __reduce_min_sync(0xffffffffu, hi == m_hi ? lo : 0xffffffffu);
  const bool tie = hi == m_hi && lo == m_lo;
  const unsigned pair = __reduce_min_sync(0xffffffffu, tie ? static_cast<unsigned>(k.pair)
                                                           : 0xffffffffu);
  unsigned long long m = (static_cast<unsigned long long>(m_hi) << 32) | m_lo;
  m = (m >> 63) ? (m & 0x7fffffffffffffffull) : ~m;
  return {__longlong_as_double(static_cast<long long>(m)), static_cast<int>(pair)};
}

// One pair's fit and key: first fit's score is 0 for a fitting pair.
__device__ __forceinline__ bool pair_key(const double* ld, const double* cp, const double* rq,
                                         int dim, int best_fit, double& slack) {
  bool fit = true;
  slack = 0.0;
  for (int d = 0; d < dim; ++d) {
    const double nl = ld[d] + rq[d];
    const double cap = cp[d];
    fit = fit && (nl <= cap + kFitEps);
    if (best_fit) {
      const double q = (cap - nl) / (cap > kTiny ? cap : kTiny);
      slack = (d == 0 || q > slack) ? q : slack;
    }
  }
  return fit;
}

// The item's opening, type-major over n_bt x C: the first least score.
__device__ __forceinline__ int opening(const double* sc, int m) {
  int best = 0;
  double best_v = sc[0];
  for (int j = 1; j < m; ++j)
    if (sc[j] < best_v) {
      best_v = sc[j];
      best = j;
    }
  return best;
}

__device__ __forceinline__ void neumaier_add(double& total, double& comp, double x) {
  const double t = total + x;
  comp += fabs(total) >= fabs(x) ? (total - t) + x : (x - t) + total;
  total = t;
}

__device__ __forceinline__ double neumaier_sum(double total, double comp) {
  return (comp != 0.0 && isfinite(comp)) ? total + comp : total;
}

// ---------------------------------------------------------------- warp

// A CTA's shared catalog in the warp variant: caps (n_bt, dim) and costs
// (n_bt) float64, 16-byte aligned.
__host__ __device__ long long catalog_bytes(int n_bt, int dim) {
  return (8ll * n_bt * (dim + 1) + 15) / 16 * 16;
}

// One fleet's shared memory in the warp variant: rows (n, C, dim), loads and
// capacities (dim, n) each (a dimension's bins side by side, so that lanes
// on neighbouring bins read neighbouring words), float64; order and
// openings (n) int32; mask (n, C) bytes; 16-byte aligned.
__host__ __device__ long long fleet_bytes(int n, int c, int dim) {
  const long long bytes = 8ll * n * dim * (c + 2) + 8ll * n + (long long)n * c;
  return (bytes + 15) / 16 * 16;
}

// A CTA's shared-memory bytes in the warp variant.
__host__ __device__ long long warp_bytes(int fleets, int n, int c, int dim, int n_bt) {
  return catalog_bytes(n_bt, dim) + fleets * fleet_bytes(n, c, dim);
}

struct Fleet {
  double* rows;
  double* loads;
  double* caps;
  int* order;
  int* open;
  uint8_t* mask;
};

__device__ __forceinline__ Fleet fleet_at(unsigned char* base, int n, int c, int dim) {
  Fleet f;
  f.rows = reinterpret_cast<double*>(base);
  f.loads = f.rows + (size_t)n * c * dim;
  f.caps = f.loads + (size_t)n * dim;
  f.order = reinterpret_cast<int*>(f.caps + (size_t)n * dim);
  f.open = f.order + n;
  f.mask = reinterpret_cast<uint8_t*>(f.open + n);
  return f;
}

// The warp's least pair of first fit (its score 0 where a pair fits): one
// reduction of the pair, 0xffffffff where none fits.
__device__ __forceinline__ int warp_first_fit(int pair) {
  return static_cast<int>(__reduce_min_sync(0xffffffffu, static_cast<unsigned>(pair)));
}

// grid (ceil(B / fleets)), kThreads threads: warp w < fleets walks fleet
// blockIdx.x * fleets + w; every thread helps with the prologue.  kDim and
// kC are the dimensions and choices, or 0 for the runtime `dim_` and `c_`;
// kBest is best fit.
template <int kDim, int kC, bool kBest, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
    pack_scan_warp(const double* __restrict__ req, const uint8_t* __restrict__ mask,
                   const double* __restrict__ open_score, const int64_t* __restrict__ order,
                   const double* __restrict__ caps, const double* __restrict__ costs,
                   int n_batch, int n, int c_, int dim_, int n_bt, int fleets,
                   int64_t* __restrict__ bin_rec, int64_t* __restrict__ choice_rec,
                   int64_t* __restrict__ bt_rec, int64_t* __restrict__ n_open_out,
                   double* __restrict__ total_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = kDim ? kDim : dim_;
  const int c = kC ? kC : c_;
  const long long per = fleet_bytes(n, c, dim);
  double* caps_s = reinterpret_cast<double*>(smem);
  double* costs_s = caps_s + n_bt * dim;
  unsigned char* fleets_s = smem + catalog_bytes(n_bt, dim);
  const int b0 = blockIdx.x * fleets;
  const int here = min(fleets, n_batch - b0);
  const int tid = threadIdx.x;
  const int row_len = c * dim;
  const int m = n_bt * c;

  // ---- prologue: the catalog; rows, mask, order, zero loads, openings.
  for (int i = tid; i < n_bt * dim; i += kThreads) caps_s[i] = caps[i];
  for (int i = tid; i < n_bt; i += kThreads) costs_s[i] = costs[i];
  for (int f = 0; f < here; ++f) {
    const Fleet fl = fleet_at(fleets_s + f * per, n, c, dim);
    const size_t b = b0 + f;
    const double* rq = req + b * n * row_len;
    for (int i = tid; i < n * row_len; i += kThreads) fl.rows[i] = rq[i];
    for (int i = tid; i < n * dim; i += kThreads) fl.loads[i] = 0.0;
    for (int i = tid; i < n * c; i += kThreads) fl.mask[i] = mask[b * n * c + i];
    for (int i = tid; i < n; i += kThreads) {
      fl.order[i] = static_cast<int>(order[b * n + i]);
      bool valid = false;
      for (int j = 0; j < c; ++j) valid = valid || mask[(b * n + i) * c + j];
      fl.open[i] = valid ? opening(open_score + (b * n + i) * m, m) : -1;
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= here) return;

  // ---- the walk.
  const Fleet fl = fleet_at(fleets_s + warp * per, n, c, dim);
  const size_t b = b0 + warp;
  int64_t* recs[3] = {bin_rec + b * n, choice_rec + b * n, bt_rec + b * n};
  int64_t mine[3] = {-1, -1, -1};  // lane l's record of the last step s with s % 32 == l
  int n_open = 0;
  double total = 0.0, comp = 0.0;  // lane 0's compensated sum of costs
  // The items and openings of the next two steps, read ahead: they do not
  // depend on the walk.
  int item = fl.order[0];
  int op = fl.open[item];
  int item1 = n > 1 ? fl.order[1] : 0;
  int op1 = n > 1 ? fl.open[item1] : -1;
  for (int s = 0; s < n; ++s) {
    int64_t bin_out = -1, choice_out = -1, bt_out = -1;
    int item2 = 0, op2 = -1;
    if (s + 2 < n) {
      item2 = fl.order[s + 2];
      op2 = fl.open[item2];
    }
    if (op >= 0) {
      const double* rows = fl.rows + item * row_len;
      const uint8_t* mk = fl.mask + item * c;
      int bin = -1, ch = 0;
      if (!kProbe) {
        // Lane l takes the bins l, l + 32, ... and each bin's choices in
        // order, so its pairs come in increasing order (first fit stops at
        // its first).
        Key k = {inf(), 0x7fffffff};
        // The item's rows and mask in registers where the shape is built in
        // (shared memory is written each step, so the compiler reloads them).
        constexpr int kR = kDim && kC ? kC * kDim : 1;
        double rr[kR];
        bool mm[kC ? kC : 1];
        if (kDim && kC) {
#pragma unroll
          for (int e = 0; e < kR; ++e) rr[e] = rows[e];
#pragma unroll
          for (int chh = 0; chh < (kC ? kC : 1); ++chh) mm[chh] = mk[chh];
        }
        for (int bn = lane; bn < n_open; bn += 32) {
          double ld[kDim ? kDim : 1], cp[kDim ? kDim : 1];
          if (kDim) {
#pragma unroll
            for (int d = 0; d < kDim; ++d) {
              ld[d] = fl.loads[d * n + bn];
              cp[d] = fl.caps[d * n + bn];
            }
          }
          bool found = false;
#pragma unroll
          for (int chh = 0; chh < (kC ? kC : c); ++chh) {
            if (!(kDim && kC ? mm[chh] : mk[chh])) continue;
            const double* rq = rows + chh * dim;
            bool fit = true;
            double slack = 0.0;
#pragma unroll
            for (int d = 0; d < (kDim ? kDim : dim); ++d) {
              const double nl = (kDim ? ld[d] : fl.loads[d * n + bn]) +
                                (kDim && kC ? rr[chh * kDim + d] : rq[d]);
              const double cap = kDim ? cp[d] : fl.caps[d * n + bn];
              fit = fit && (nl <= cap + kFitEps);
              if (kBest) {
                const double q = (cap - nl) / (cap > kTiny ? cap : kTiny);
                slack = (d == 0 || q > slack) ? q : slack;
              }
            }
            if (!fit) continue;
            const Key cand = {kBest ? slack : 0.0, bn * c + chh};
            if (before(cand, k)) k = cand;
            if (!kBest) {
              found = true;
              break;
            }
          }
          if (!kBest && found) break;
        }
        int pair;
        if (kBest) {
          k = warp_min_all(k);
          pair = k.score < inf() ? k.pair : -1;
        } else {
          pair = warp_first_fit(k.pair);
          pair = pair == 0x7fffffff ? -1 : pair;
        }
        if (pair >= 0) {  // an open bin takes the item
          bin = pair / c;
          ch = pair - bin * c;
        }
      } else {
        // The skeleton keeps the decision's reduction.
        bin = warp_first_fit(0x7fffffff) == 0x7fffffff ? -1 : 0;
      }
      if (bin < 0) {  // open the prologue's bin type and choice
        const int bt = op / c;
        ch = op - bt * c;
        bin = n_open;
        for (int d = lane; d < dim; d += 32) fl.caps[d * n + bin] = caps_s[bt * dim + d];
        if (lane == 0) neumaier_add(total, comp, costs_s[bt]);
        ++n_open;
        bt_out = bt;
      }
      for (int d = lane; d < dim; d += 32)
        fl.loads[d * n + bin] = fl.loads[d * n + bin] + rows[ch * dim + d];
      bin_out = bin;
      choice_out = ch;
    }
    if (lane == (s & 31)) {
      mine[0] = bin_out;
      mine[1] = choice_out;
      mine[2] = bt_out;
    }
    if ((s & 31) == 31 || s == n - 1) {  // 32 steps' records, one a lane, coalesced
      const int at = (s & ~31) + lane;
      if (at <= s) {
#pragma unroll
        for (int r = 0; r < 3; ++r) recs[r][at] = mine[r];
      }
    }
    item = item1;
    op = op1;
    item1 = item2;
    op1 = op2;
    __syncwarp();
  }
  if (lane == 0) {
    n_open_out[b] = n_open;
    total_out[b] = neumaier_sum(total, comp);
  }
}

// ---------------------------------------------------------------- global

// Shared-memory bytes of a CTA of the global variant: the staged rows (C x
// dim doubles), the warps' keys, the order and openings (n int32 each), the
// staged mask (C bytes).
__host__ __device__ long long global_bytes(int n, int c, int dim) {
  const long long bytes = 8ll * c * dim + kWarps * 16 + 16 + 8ll * n + c;
  return (bytes + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kThreads, 1)
    pack_scan_global(const double* __restrict__ req, const uint8_t* __restrict__ mask,
                     const double* __restrict__ open_score, const int64_t* __restrict__ order,
                     const double* __restrict__ caps, const double* __restrict__ costs, int n,
                     int c, int dim, int n_bt, int best_fit, double* __restrict__ scratch,
                     int64_t* __restrict__ bin_rec, int64_t* __restrict__ choice_rec,
                     int64_t* __restrict__ bt_rec, int64_t* __restrict__ n_open_out,
                     double* __restrict__ total_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = n_bt * c;
  double* loads = scratch + (size_t)b * 2 * n * dim;
  double* caps_open = loads + (size_t)n * dim;
  double* row = reinterpret_cast<double*>(smem);  // (C, dim) rows of the step's item
  Key* keys = reinterpret_cast<Key*>(row + (size_t)c * dim);  // (kWarps + 1)
  int* order_s = reinterpret_cast<int*>(keys + kWarps + 1);
  int* open_s = order_s + n;
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(open_s + n);
  __shared__ int n_open_s;

  const int64_t* order_b = order + (size_t)b * n;
  for (int i = tid; i < n; i += kThreads) {
    order_s[i] = static_cast<int>(order_b[i]);
    bool valid = false;
    for (int j = 0; j < c; ++j) valid = valid || mask[((size_t)b * n + i) * c + j];
    open_s[i] = valid ? opening(open_score + ((size_t)b * n + i) * m, m) : -1;
  }
  for (size_t i = tid; i < (size_t)n * dim; i += kThreads) loads[i] = 0.0;
  if (tid == 0) n_open_s = 0;
  double total = 0.0, comp = 0.0;  // thread 0's compensated sum of costs
  __syncthreads();

  const int row_len = c * dim;
  for (int s = 0; s < n; ++s) {
    const int item = order_s[s];
    const int op = open_s[item];
    if (op < 0) {  // a padding item: the same for every thread, no barrier
      if (tid == 0) {
        bin_rec[(size_t)b * n + s] = -1;
        choice_rec[(size_t)b * n + s] = -1;
        bt_rec[(size_t)b * n + s] = -1;
      }
      continue;
    }
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
      double slack;
      if (!pair_key(loads + (size_t)bin * dim, caps_open + (size_t)bin * dim,
                    row + (size_t)ch * dim, dim, best_fit, slack))
        continue;
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
        int bin, ch;
        int64_t bt_out = -1;
        if (w.score < inf()) {  // an open bin takes the item
          bin = w.pair / c;
          ch = w.pair - bin * c;
        } else {  // open the prologue's bin type and choice
          const int bt = op / c;
          ch = op - bt * c;
          bin = n_open;
          for (int d = 0; d < dim; ++d) caps_open[(size_t)bin * dim + d] = caps[(size_t)bt * dim + d];
          neumaier_add(total, comp, costs[bt]);
          n_open_s = n_open + 1;
          bt_out = bt;
        }
        for (int d = 0; d < dim; ++d)
          loads[(size_t)bin * dim + d] = loads[(size_t)bin * dim + d] + row[(size_t)ch * dim + d];
        bin_rec[(size_t)b * n + s] = bin;
        choice_rec[(size_t)b * n + s] = ch;
        bt_rec[(size_t)b * n + s] = bt_out;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    n_open_out[b] = n_open_s;
    total_out[b] = neumaier_sum(total, comp);
  }
}

struct Args {
  const double* req;
  const uint8_t* mask;
  const double* score;
  const int64_t* order;
  const double* caps;
  const double* costs;
  int n_batch, n, c, dim, n_bt, best_fit;
  int64_t* bin_rec;
  int64_t* choice_rec;
  int64_t* bt_rec;
  int64_t* n_open;
  double* total;
};

template <int kDim, int kC, bool kBest, bool kProbe>
int launch_warp_dim(const Args& a, int fleets, long long smem, cudaStream_t st) {
  auto kernel = pack_scan_warp<kDim, kC, kBest, kProbe>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.n_batch + fleets - 1) / fleets, kThreads, (size_t)smem, st>>>(
      a.req, a.mask, a.score, a.order, a.caps, a.costs, a.n_batch, a.n, a.c, a.dim, a.n_bt,
      fleets, a.bin_rec, a.choice_rec, a.bt_rec, a.n_open, a.total);
  return (int)cudaGetLastError();
}

// The live loop's fleets (4 dimensions, 2 choices) on kernels built for
// them; any other shape on the general ones.
template <bool kBest, bool kProbe>
int launch_warp_fit(const Args& a, int fleets, long long smem, cudaStream_t st) {
  return a.dim == 4 && a.c == 2 ? launch_warp_dim<4, 2, kBest, kProbe>(a, fleets, smem, st)
                                : launch_warp_dim<0, 0, kBest, kProbe>(a, fleets, smem, st);
}

template <bool kProbe>
int launch_warp(const Args& a, int fleets, cudaStream_t st) {
  const long long smem = warp_bytes(fleets, a.n, a.c, a.dim, a.n_bt);
  if (fleets < 1 || fleets > kMaxFleets || smem > kMaxSmem ||
      (long long)a.n * a.c * a.dim > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  return a.best_fit ? launch_warp_fit<true, kProbe>(a, fleets, smem, st)
                    : launch_warp_fit<false, kProbe>(a, fleets, smem, st);
}

Args make_args(int best_fit, const void* req, const void* mask, const void* open_score,
               const void* order, const void* caps, const void* costs, int n_batch, int n, int c,
               int dim, int n_bt, void* bin_rec, void* choice_rec, void* bt_rec, void* n_open,
               void* total) {
  return {static_cast<const double*>(req), static_cast<const uint8_t*>(mask),
          static_cast<const double*>(open_score), static_cast<const int64_t*>(order),
          static_cast<const double*>(caps), static_cast<const double*>(costs), n_batch, n, c,
          dim, n_bt, best_fit, static_cast<int64_t*>(bin_rec), static_cast<int64_t*>(choice_rec),
          static_cast<int64_t*>(bt_rec), static_cast<int64_t*>(n_open),
          static_cast<double*>(total)};
}

bool bad_shape(int n_batch, int n, int c, int dim, int n_bt) {
  return n_batch < 1 || n < 1 || c < 1 || dim < 1 || n_bt < 1 ||
         (long long)n * c > 0x7fffffffll || (long long)n_bt * c > 0x7fffffffll;
}

}  // namespace

extern "C" {

// variant 0 ("warp"): `fleets` fleets a CTA, one warp each, everything in
// shared memory; variant 1 ("global"): one CTA a fleet, loads and capacities
// in scratch, (B, 2, n, dim) float64.  req (B, n, C, dim) float64, mask
// (B, n, C) uint8, open_score (B, n, n_bt, C) float64, order (B, n) int64,
// caps (n_bt, dim) float64, costs (n_bt,) float64; records (B, n) int64
// each, n_open (B,) int64, total (B,) float64.  Returns a CUDA error code (0
// on success).
int pack_scan_f64(int variant, int fleets, int best_fit, const void* req, const void* mask,
                  const void* open_score, const void* order, const void* caps, const void* costs,
                  int n_batch, int n, int c, int dim, int n_bt, void* scratch, void* bin_rec,
                  void* choice_rec, void* bt_rec, void* n_open, void* total, void* stream) {
  if (bad_shape(n_batch, n, c, dim, n_bt) || (variant != 0 && variant != 1) ||
      (variant == 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(best_fit, req, mask, open_score, order, caps, costs, n_batch, n, c,
                           dim, n_bt, bin_rec, choice_rec, bt_rec, n_open, total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) return launch_warp<false>(a, fleets, st);
  const long long smem = global_bytes(n, c, dim);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pack_scan_global,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pack_scan_global<<<n_batch, kThreads, (size_t)smem, st>>>(
      a.req, a.mask, a.score, a.order, a.caps, a.costs, n, c, dim, n_bt, best_fit,
      static_cast<double*>(scratch), a.bin_rec, a.choice_rec, a.bt_rec, a.n_open, a.total);
  return (int)cudaGetLastError();
}

// The warp variant's walk without its pair loop (see the header): the same
// arguments as pack_scan_f64's warp variant; its records are not the scan's.
int pack_scan_probe_f64(int fleets, int best_fit, const void* req, const void* mask,
                        const void* open_score, const void* order, const void* caps,
                        const void* costs, int n_batch, int n, int c, int dim, int n_bt,
                        void* bin_rec, void* choice_rec, void* bt_rec, void* n_open, void* total,
                        void* stream) {
  if (bad_shape(n_batch, n, c, dim, n_bt)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(best_fit, req, mask, open_score, order, caps, costs, n_batch, n, c,
                           dim, n_bt, bin_rec, choice_rec, bt_rec, n_open, total);
  return launch_warp<true>(a, fleets, static_cast<cudaStream_t>(stream));
}

// The most fleets of n items, c choices over dim dimensions and n_bt bin
// types a CTA of the warp variant holds in shared memory (at most
// kMaxFleets), 0 where not one fleet fits: the wrapper picks its launch
// shape from it (kernels/pack.py: fleets_that_fit, launch_shape).
int pack_scan_warp_fleets(int n, int c, int dim, int n_bt) {
  if (bad_shape(1, n, c, dim, n_bt)) return 0;
  int fleets = 0;
  while (fleets < kMaxFleets && warp_bytes(fleets + 1, n, c, dim, n_bt) <= kMaxSmem) ++fleets;
  return fleets;
}

}  // extern "C"
