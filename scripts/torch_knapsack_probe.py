"""Where the knapsack kernel's ``cluster`` variant spends its time.

Builds ``src/repro_torch/kernels/csrc/knapsack.cu`` four times with nvcc,
all at once, into ``build/knapsack_probe/``: as the wrapper builds it, and
with each of its probe macros (``KNAPSACK_PROBE_NO_BACKTRACK``: no device
backtrack; ``KNAPSACK_PROBE_NO_TAKE``: no take stores;
``KNAPSACK_PROBE_EMPTY_STEPS`` with ``KNAPSACK_PROBE_NO_BACKTRACK``: the
step loop keeps only its parameter loads and its cluster barrier, the
floor of T dependent steps).  Each build's kernel is launched through
`knapsack._dispatch` (its `_kernel_fn` replaced) on the 500-camera fleet's
pricing batch of ``chip_smoke.py`` (5 nodes x 3 bin kinds: B 15, S
30,940, seeded duals), at all T steps and at its first step alone, and
timed as ``chip_smoke.py`` phase 5 times the kernel (`time_cold_ms`: CUDA
events around each call, queued while the card spins).  The probes'
outputs are wrong by design and not checked; the full build is checked
against the plain version, and also timed at 4, 8 and 16 CTAs a knapsack
(`_cluster_size` replaced; `_layout` cuts the slices).  Needs one card.
Run from the repository root:

    PYTHONPATH=src python scripts/torch_knapsack_probe.py [--json FILE]

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

import torch

from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
from repro_torch.core.strategies import ST3
from repro_torch.kernels import _build, knapsack

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "knapsack_probe"
#: CTAs a knapsack at which the full build is also timed.
CLUSTER_SIZES = (4, 8, 16)
#: Build name: the probe macros it defines.
BUILDS = {
    "full": (),
    "no_backtrack": ("KNAPSACK_PROBE_NO_BACKTRACK",),
    "no_take": ("KNAPSACK_PROBE_NO_TAKE",),
    "empty_steps": ("KNAPSACK_PROBE_EMPTY_STEPS", "KNAPSACK_PROBE_NO_BACKTRACK"),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all() -> dict[str, ctypes.CDLL]:
    """One nvcc a build, all started together; the wrapper's flags plus
    the build's macros."""
    OUT.mkdir(parents=True, exist_ok=True)
    flags = _build.SOURCES["knapsack"][0]
    src = _build.CSRC / "knapsack.cu"
    procs = {}
    for name, macros in BUILDS.items():
        cmd = [_build._nvcc(), *flags, *(f"-D{m}" for m in macros),
               "-o", str(OUT / f"libknapsack-{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"libknapsack-{name}.so"))
    return libs


def kernel_fn(lib):
    def fn(dtype):
        f = lib.knapsack_dp_f64 if dtype == torch.float64 else lib.knapsack_dp_f32
        f.argtypes = knapsack._ARGTYPES
        f.restype = ctypes.c_int
        return f
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_knapsack_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    print(cs.nvidia_smi_line(), flush=True)
    problem = ResourceManager(paper_ec2_catalog(), paper_profile_table(),
                              device="cpu").formulate(cs.camera_fleet(cs.N_CAMERAS), ST3)
    v, w, b, c = cs.fleet_pricing(problem, 32_768, n_nodes=5, seed=0)
    steps = knapsack.pricing_steps(v, w, b, c)
    full = steps.to("cuda")
    sv, sw, fi, levels = full
    first = (sv[:, :1].contiguous(), sw[:, :1].contiguous(), fi, levels)
    b_n, t_n = sv.shape
    libs = build_all()
    saved = knapsack._kernel_fn, knapsack._cluster_size
    rows = {}
    try:
        for name, lib in libs.items():
            knapsack._kernel_fn = kernel_fn(lib)
            if name == "full":
                best_k, take_k, _ = knapsack._dispatch(*full)
                best_p, take_p = knapsack.knapsack_dp_plain(*full)
                if not (torch.equal(best_k, best_p) and torch.equal(take_k, take_p)):
                    raise AssertionError("the full build differs from the plain version")
            rows[name] = {
                "ms": cs.time_cold_ms(lambda: knapsack._dispatch(*full), reps=30),
                "first_step_ms": cs.time_cold_ms(lambda: knapsack._dispatch(*first), reps=30),
            }
        knapsack._kernel_fn = kernel_fn(libs["full"])
        sizes = {}
        for c in CLUSTER_SIZES:
            knapsack._cluster_size = lambda b_n, s_n, n_sms, c=c: c
            sizes[c] = cs.time_cold_ms(lambda: knapsack._dispatch(*full), reps=30)
    finally:
        knapsack._kernel_fn, knapsack._cluster_size = saved
    n_ctas, log2 = knapsack._layout(steps.states, knapsack._cluster_size(
        b_n, steps.states, torch.cuda.get_device_properties(0).multi_processor_count))
    for name, r in rows.items():
        r["per_step_us"] = (r["ms"] - r["first_step_ms"]) / (t_n - 1) * 1e3
        print(f"{name:>13}: {r['ms']:.4f} ms at T={t_n}, {r['first_step_ms']:.4f} ms at T=1, "
              f"{r['per_step_us']:.3f} us a further step", flush=True)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
              "B": b_n, "T": t_n, "S": steps.states, "ctas_a_knapsack": n_ctas,
              "slice": 1 << log2, "builds": rows,
              "cluster_sizes_ms": {str(c): ms for c, ms in sizes.items()}}
    print("full build at " + ", ".join(f"{c} CTAs a knapsack {ms:.4f} ms"
                                       for c, ms in sizes.items()), flush=True)
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
