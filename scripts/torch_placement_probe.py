"""Launch shapes of the placement scores, timed against each other.

The repo's kernel (``src/repro_torch/kernels/csrc/placement.cu``: a thread
a score, every load straight from memory) against three other shapes of
the same arithmetic for 4 dimensions, built with nvcc into
``build/placement_probe/``: two bins a thread (one 16-byte store), and each
of the two with the bins' residuals staged in shared memory by one
cooperative load and a block barrier; beside the empty kernel of the repo's
launch shape (`placement.empty_launch`, the call's floor) and the kernel
before its redesign (one thread an output over a flat 64-bit index, taken
from the git history into ``build/placement_probe/`` when ``--parent`` names
its source file).  Each is checked bit for bit against
`heuristics.placement_scores_np` and timed as ``chip_smoke.py`` phase 4b
times the kernel (`time_cold_ms`: L2 flushed, each call queued while the
card spins), at the path's largest launch of phase 4b (a) (22 x 2 x 38),
the fleet-scale matrix (500 x 2 x 64) and a wide one (37 x 3 x 1029).
Needs one card.  Run from the repository root:

    PYTHONPATH=src python scripts/torch_placement_probe.py [--parent FILE] [--json FILE]

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
object on its last line; ``--json`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.binpack import heuristics
from repro_torch.kernels import _build, placement

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "placement_probe"
SHAPES = ((22, 2, 38), (500, 2, 64), (37, 3, 1029))

#: The other launch shapes: BPT bins a thread, TILE the residuals staged.
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kRows = 8;
__device__ constexpr double kFitEps = 1e-9;
__device__ constexpr double kTiny = 1e-300;
__device__ __forceinline__ void fold(double rv, double cap, int d, bool& fit, double& slack) {
  fit = fit && (rv <= cap + kFitEps);
  const double q = (cap - rv) / (cap > kTiny ? cap : kTiny);
  slack = (d == 0 || q > slack) ? q : slack;
}
template <int BPT, bool TILE>
__global__ void __launch_bounds__(256)
    probe_kernel(const double* __restrict__ req, const uint8_t* __restrict__ mask,
                 const double* __restrict__ resid, int rows, int p_n, double* __restrict__ out) {
  constexpr int kBins = 32 * BPT;
  __shared__ __align__(16) double tile[4 * kBins];
  const int lane = threadIdx.x;
  const int row = blockIdx.x * kRows + threadIdx.y;
  const int p0 = blockIdx.y * kBins;
  const int nb = min(kBins, p_n - p0);
  const bool live = row < rows;
  double cap[BPT][4];
  if (TILE) {
    for (int j = threadIdx.y * 32 + lane; j < nb * 4; j += 256)
      tile[(j & 3) * kBins + (j >> 2)] = resid[p0 * 4 + j];
  } else {
#pragma unroll
    for (int e = 0; e < BPT; ++e) {
      const int p = min(p0 + BPT * lane + e, p_n - 1);
      const double2 x = reinterpret_cast<const double2*>(resid + p * 4)[0];
      const double2 y = reinterpret_cast<const double2*>(resid + p * 4)[1];
      cap[e][0] = x.x; cap[e][1] = x.y; cap[e][2] = y.x; cap[e][3] = y.y;
    }
  }
  const bool m = live && mask[live ? row : 0] != 0;
  const double* rrow = req + (live ? row : 0) * 4;
  const double2 r01 = reinterpret_cast<const double2*>(rrow)[0];
  const double2 r23 = reinterpret_cast<const double2*>(rrow)[1];
  const double r[4] = {r01.x, r01.y, r23.x, r23.y};
  if (TILE) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < BPT; ++e)
#pragma unroll
      for (int d = 0; d < 4; ++d) cap[e][d] = tile[d * kBins + BPT * lane + e];
  }
  const int p = BPT * lane;
  if (!live || p >= nb) return;
  double s[BPT];
#pragma unroll
  for (int e = 0; e < BPT; ++e) {
    bool fit = m;
    double slack = 0.0;
#pragma unroll
    for (int d = 0; d < 4; ++d) fold(r[d], cap[e][d], d, fit, slack);
    s[e] = fit ? slack : __longlong_as_double(0x7ff0000000000000ll);
  }
  double* o = out + row * p_n + p0 + p;
  if (BPT == 2 && p + 1 < nb && p_n % 2 == 0) {
    *reinterpret_cast<double2*>(o) = make_double2(s[0], s[BPT - 1]);
  } else {
    o[0] = s[0];
    if (BPT == 2 && p + 1 < nb) o[1] = s[BPT - 1];
  }
}
template <int BPT, bool TILE>
int go(const void* req, const void* mask, const void* resid, int k, int c, int p_n, void* out,
       cudaStream_t st) {
  const int rows = k * c;
  const dim3 grid((rows + kRows - 1) / kRows, (p_n + 32 * BPT - 1) / (32 * BPT));
  probe_kernel<BPT, TILE><<<grid, dim3(32, kRows), 0, st>>>(
      (const double*)req, (const uint8_t*)mask, (const double*)resid, rows, p_n, (double*)out);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int probe(int variant, const void* req, const void* mask, const void* resid, int k,
                     int c, int p_n, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0: return go<2, false>(req, mask, resid, k, c, p_n, out, st);
    case 1: return go<1, true>(req, mask, resid, k, c, p_n, out, st);
    case 2: return go<2, true>(req, mask, resid, k, c, p_n, out, st);
  }
  return 1;
}
"""
#: Probe variant code: name.
VARIANTS = {0: "two_bins", 1: "tile", 2: "two_bins_tile"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_lib(name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.SOURCES["placement"][0], "-o",
                           str(path.with_suffix(".so")), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{(proc.stdout + proc.stderr)[-4000:]}")
    return ctypes.CDLL(str(path.with_suffix(".so")))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the kernel's source before its redesign")
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(("placement",))
    probe = _build_lib("probe", PROBE_SOURCE)
    probe.probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    parent = None
    if args.parent:
        parent = _build_lib("parent", pathlib.Path(args.parent).read_text())
        parent.placement_scores_f64.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 2
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    out = {"card": card, "rows": []}
    for k, c, p in SHAPES:
        req = rng.uniform(0, 2, (k, c, 4))
        mask = rng.rand(k, c) < 0.9
        req[~mask] = np.inf
        resid = rng.uniform(0, 2, (p, 4))
        resid[0] = 0.0
        want = heuristics.placement_scores_np(req, mask, resid)
        t = [torch.from_numpy(x).cuda() for x in (req, mask, resid)]
        o = torch.empty((k, c, p), dtype=torch.float64, device="cuda")
        ptrs = [x.data_ptr() for x in t]
        calls = {"kernel": lambda: placement._dispatch(*t)}
        for code, name in VARIANTS.items():
            calls[name] = (lambda code=code: probe.probe(code, *ptrs, k, c, p, o.data_ptr(),
                                                         stream))
        if parent is not None:
            calls["parent"] = lambda: parent.placement_scores_f64(*ptrs, k, c, p, 4, o.data_ptr(),
                                                                  stream)
        row = {"shape": [k, c, p]}
        for name, fn in calls.items():
            o.fill_(float("nan"))
            got = fn()
            torch.cuda.synchronize()
            got = got.cpu().numpy() if name == "kernel" else o.cpu().numpy()
            if not np.array_equal(got, want):
                raise SystemExit(f"{name} at {(k, c, p)} differs from placement_scores_np")
            row[f"{name}_ms"] = cs.time_cold_ms(fn, reps=30)
        row["empty_ms"] = cs.time_cold_ms(lambda: placement.empty_launch(*t), reps=30)
        print(", ".join(f"{key} {v:.5f}" if isinstance(v, float) else f"{key} {v}"
                        for key, v in row.items()), flush=True)
        out["rows"].append(row)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
