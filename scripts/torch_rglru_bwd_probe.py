"""Where the RG-LRU backward's ``split`` variant spends its time.

Builds copies of ``src/repro_torch/kernels/csrc/rglru_bwd.cu`` with nvcc,
all at once, into ``build/rglru_bwd_probe/``, each with one part of the
split taken out or changed by a text edit of the source (the script stops
if a part it edits is no longer there):

* ``no_store``: no TMA store of da and db;
* ``no_fold``: no read of the other segments' (G, A) (every carry 0);
* ``no_rewalk``: the second walk's arithmetic and its writes to the planes
  taken out (the stores write the planes as they are);
* ``no_walks``: that, and the first walk's arithmetic too;
* ``one_item``: a cluster per item (a grid of every item), so no item's
  loads run under the walk before it;
* ``unstaged``: the second walk reads each step's dh, a and h from shared
  memory between the stores of the steps before it, instead of a box at a
  time into registers.

Each copy's split (`rglru_bwd_split_f32`) is timed at recurrentgemma-9b's
training call (B 1, S 4096, W 4096, float32; SEG and the segment's steps
as `rglru._split` picks them) as ``chip_smoke.py`` phase 9 (a) times it
(`time_cold_ms`: L2 flushed, each call queued while the card spins),
beside the repo's build through `rglru._dispatch_bwd`, at SEG 16 (a
non-portable cluster: 256 steps, two CTAs an SM), and beside the ``walk``
forced at 64 and at 32 lanes a CTA.  The probes' outputs are wrong by
design (``unstaged``'s is checked: it computes the same function); the
repo's build is checked against `rglru_scan_backward_plain`.  Needs one
card.  Run from the repository root:

    PYTHONPATH=src python scripts/torch_rglru_bwd_probe.py [--json FILE]

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

from repro_torch.kernels import _build, rglru

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "rglru_bwd_probe"
SHAPE = (1, 4096, 4096)

_STORES = """        hopper::tma_store_3d(&map_db, s_dh + i * kBox, w0, t0 + i * kBoxSteps, row);
        hopper::tma_store_3d(&map_da, s_an + i * kBox, w0, t0 + i * kBoxSteps, row);"""
_FOLD = """      c = fmaf(*cluster.map_shared_rank(&carry[1][lane], j), c,
               *cluster.map_shared_rank(&carry[0][lane], j));"""
_REWALK = """      g = rewalk_box<LANES>(s_dh + i * kBox + lane, s_an + i * kBox + lane,
                            s_hp + i * kBox + lane, g, min(kBoxSteps, n - i * kBoxSteps));"""
_WALK1 = """          g = fmaf(an[j * LANES], g, dh[j * LANES]);
          prod *= an[j * LANES];
        }
      } else {"""
_GRID = "  const int clusters = std::min(items, std::min(active_clusters(seg, smem), 65535));"
_STAGED = """  float vd[kBoxSteps], va[kBoxSteps], vh[kBoxSteps];
#pragma unroll
  for (int k = 0; k < kBoxSteps; ++k) {
    vd[k] = dh[k * LANES];
    va[k] = an[k * LANES];
    vh[k] = hp[k * LANES];
  }
#pragma unroll
  for (int k = kBoxSteps - 1; k >= 0; --k) {
    if (k < n) {
      g = fmaf(va[k], g, vd[k]);
      dh[k * LANES] = g;
      an[k * LANES] = g * vh[k];
    }
  }"""
_UNSTAGED = """#pragma unroll
  for (int k = kBoxSteps - 1; k >= 0; --k) {
    if (k < n) {
      g = fmaf(an[k * LANES], g, dh[k * LANES]);
      dh[k * LANES] = g;
      an[k * LANES] = g * hp[k * LANES];
    }
  }"""
_NO_REWALK = "      g += s_dh[i * kBox + lane];"
#: Build name: (text, replacement) edits of the source.
BUILDS = {
    "no_store": ((_STORES, ""),),
    "no_fold": ((_FOLD, "      ;"),),
    "no_rewalk": ((_REWALK, _NO_REWALK),),
    "no_walks": ((_REWALK, _NO_REWALK),
                 (_WALK1, _WALK1.replace("g = fmaf(an[j * LANES], g, dh[j * LANES]);", "")
                  .replace("prod *= an[j * LANES];", ""))),
    "one_item": ((_GRID, "  const int clusters = items;"),),
    "unstaged": ((_STAGED, _UNSTAGED),),
}
_SPLIT_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_probes() -> dict:
    """Every copy of the source in `BUILDS`, built at once: {name: library}."""
    src = (_build.CSRC / "rglru_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in BUILDS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has the part it edits:\n{old}")
            text = text.replace(old, new)
        path = OUT / f"rglru_bwd_{name}.cu"
        path.write_text(text)
        cmd = [_build._nvcc(), *_build.SOURCES["rglru_bwd"][0], "-I", str(_build.CSRC), "-o",
               str(path.with_suffix(".so")), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} probe:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"rglru_bwd_{name}.so"))
        lib.rglru_bwd_split_f32.argtypes = _SPLIT_ARGS
        lib.rglru_bwd_split_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(("rglru", "rglru_bwd"))
    libs = build_probes()
    b, s, w = SHAPE
    rng = np.random.RandomState(12)
    a = torch.sigmoid(torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)).cuda() + 2)
    h = rglru._dispatch(0.3 * a, torch.from_numpy(
        rng.standard_normal(SHAPE).astype(np.float32)).cuda(), None)
    dh = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)).cuda()
    want = rglru.rglru_scan_backward_plain(a, h, dh)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    seg, _lanes = rglru._split(b, s, w, n_sms)
    steps = rglru.segment_steps(s, seg)
    share, rtol = rglru.BWD_TOLERANCE

    def check(name, got):
        for g, w_ in zip(got, want):
            if not torch.allclose(g, w_, atol=share * float(w_.abs().max()), rtol=rtol):
                raise SystemExit(f"{name}: differs from the plain backward")

    out = {"card": card, "shape": list(SHAPE), "seg": seg, "segment_steps": steps,
           "clusters": rglru.split_clusters(seg, steps), **cs.rglru_bwd_bound(a)}
    check("split", rglru._dispatch_bwd(a, h, dh))
    out["split_ms"] = cs.time_cold_ms(lambda: rglru._dispatch_bwd(a, h, dh), reps=20)
    for lanes in (64, 32):
        with cs.Patched(rglru, _bwd_variant=lambda *x: "walk", _lanes=lambda *x: lanes):
            out[f"walk_{lanes}_ms"] = cs.time_cold_ms(lambda: rglru._dispatch_bwd(a, h, dh),
                                                      reps=20)
    da, db = torch.empty_like(a), torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {name: (lib, seg, steps) for name, lib in libs.items()}
    calls["seg_16"] = (None, 16, rglru.segment_steps(s, 16))
    for name, (lib, sg, st) in calls.items():
        fn = (lib.rglru_bwd_split_f32 if lib is not None else
              rglru._bwd_fn("split"))

        def call():
            rc = fn(sg, st, a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
                    db.data_ptr(), b, s, w, stream)
            if rc != 0:
                raise SystemExit(f"{name}: launch failed, CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        if name in ("unstaged", "seg_16"):
            check(name, (da, db))
        out[f"{name}_ms"] = cs.time_cold_ms(call, reps=20)
        print(f"{name}: {out[f'{name}_ms']:.4f} ms", flush=True)
    print(f"split {out['split_ms']:.4f} ms (SEG {seg}, {out['clusters']} clusters), bound "
          f"{out['bound_ms']:.4f}; walk 64 lanes {out['walk_64_ms']:.4f}, 32 lanes "
          f"{out['walk_32_ms']:.4f}", flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
