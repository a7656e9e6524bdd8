#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Drives the port's main path — the paper's resource manager, with
branch-and-price pricing on the card — and holds every CUDA kernel of that
path against its plain torch version.  Phases, each raising on failure:

1. device: the card's name, count and power limit;
2. build: every kernel of the path, from ``src/repro_torch/kernels/csrc``;
3. kernel vs plain on the card, exact equality of ``best``, the take bits
   and the backtracked counts: a seeded sweep of small pricings (float64
   and float32), the 500-camera fleet's pricing grid with 18 knapsacks,
   and a grid larger than a block's shared memory;
4. main path: the quickstart's paper scenario 1 under ST1-ST3 (61%
   headline), then a 500-camera, 10-kind fleet allocated on the card
   (routes to branch-and-price), with the kernel's launches counted and
   the plan compared with the same fleet allocated with ``device="cpu"``;
5. timing: the kernel and the plain version on the card at the main
   path's largest pricing call, with CUDA events.

Phase 1 prints ``nvidia-smi``'s name and power limit on a line of its
own.  The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card:

    python3 chip_smoke.py [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.binpack import colgen  # noqa: E402
from repro_torch.core.binpack.arcflow import group_items  # noqa: E402
from repro_torch.core.binpack.problem import BinType  # noqa: E402
from repro_torch.core.catalog import paper_ec2_catalog  # noqa: E402
from repro_torch.core.manager import ResourceManager  # noqa: E402
from repro_torch.core.profiler import paper_profile_table  # noqa: E402
from repro_torch.core.simulator import simulate_plan  # noqa: E402
from repro_torch.core.strategies import ALL_STRATEGIES, ST1, ST3  # noqa: E402
from repro_torch.core.streams import AnalysisProgram, StreamSpec  # noqa: E402
from repro_torch.interop import plan_to_plain  # noqa: E402
from repro_torch.kernels import _build, knapsack  # noqa: E402

#: The JAX reference's result for the 500-camera fleet on a CPU, for the
#: reader: $/h and instance count (repro.core.manager, numpy pricing).
REFERENCE_500 = (24.657, 39)
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; non-tensor fp32 op/s.
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12

VGG = AnalysisProgram("VGG-16", "vgg16")
ZF = AnalysisProgram("ZF", "zf")
KINDS = [(VGG, f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
    (ZF, f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)
]
#: The main path's fleet: cameras over the 10 kinds (REFERENCE_500's fleet).
N_CAMERAS = 500


def camera_fleet(n: int) -> list[StreamSpec]:
    """n cameras over 10 kinds (VGG-16 and ZF at five rates each)."""
    return [
        StreamSpec(f"cam{i}", KINDS[i % 10][0], KINDS[i % 10][1]) for i in range(n)
    ]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 3


def compare_on_card(steps: knapsack.PricingSteps, e_n: int, label: str) -> dict:
    """Kernel vs plain on the card on one pricing batch; exact equality."""
    args = steps.to("cuda")
    best_k, take_k = knapsack.knapsack_dp(*args)
    torch.cuda.synchronize()
    best_p, take_p = knapsack.knapsack_dp_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(take_k, take_p):
        bad = int((take_k != take_p).sum())
        raise AssertionError(f"{label}: take bits differ in {bad} states")
    if not torch.equal(best_k, best_p):
        raise AssertionError(f"{label}: best differs: {best_k} vs {best_p}")
    counts_k = steps.counts(take_k.cpu().numpy(), e_n)
    counts_p = steps.counts(take_p.cpu().numpy(), e_n)
    if not np.array_equal(counts_k, counts_p):
        raise AssertionError(f"{label}: counts differ")
    err = float((best_k.double() - best_p.double()).abs().max())
    b_n, t_n = steps.step_values.shape
    return {"label": label, "B": b_n, "T": t_n, "S": steps.states, "max_abs_err": err}


def random_pricing(rng, b_n, e_n, dim, dtype):
    values = rng.uniform(0.0, 1.0, size=(b_n, e_n)).astype(dtype)
    weights = rng.randint(0, 4, size=(b_n, e_n, dim)).astype(np.int64)
    weights[..., 0] = np.maximum(weights[..., 0], 1)
    bounds = rng.randint(0, 5, size=(b_n, e_n)).astype(np.int64)
    cap_levels = rng.randint(1, 7, size=(b_n, dim)).astype(np.int64)
    return values, weights, bounds, cap_levels


def fleet_pricing(problem, grid_states: int, n_nodes: int, seed: int):
    """colgen's pricing batch for ``problem`` with seeded duals: every
    (node, bin kind) knapsack on the shared grid, as `_price_dp` builds it."""
    class_reqs, demands, _members = group_items(problem)
    grid = colgen._discretize(problem, class_reqs, grid_states)
    rng = np.random.RandomState(seed)
    duals = rng.uniform(0.0, 0.5, size=(n_nodes, len(class_reqs)))
    n_kinds = grid.weights.shape[0]
    values = np.repeat(duals[:, grid.entry_class], n_kinds, axis=0)
    weights = np.tile(grid.weights, (n_nodes, 1, 1))
    caps = np.tile(grid.cap_levels, (n_nodes, 1))
    dem = np.asarray(demands, dtype=np.int64)[grid.entry_class]
    bounds = np.minimum(np.tile(grid.fit, (n_nodes, 1)), dem[None, :])
    return values, weights, bounds, caps


def phase_kernel_vs_plain(fleet_problem) -> list[dict]:
    rows = []
    for dtype in (np.float64, np.float32):
        for seed in range(8):
            rng = np.random.RandomState(seed)
            b_n, e_n, dim = (int(rng.randint(1, 5)), int(rng.randint(1, 6)),
                             int(rng.randint(1, 4)))
            v, w, b, c = random_pricing(rng, b_n, e_n, dim, dtype)
            steps = knapsack.pricing_steps(v, w, b, c)
            if steps.step_values.shape[1] == 0:
                continue
            rows.append(compare_on_card(
                steps, e_n, f"sweep seed={seed} {np.dtype(dtype).name}"))
    for grid_states, label in ((32_768, "main-path grid"), (131_072, "large grid")):
        v, w, b, c = fleet_pricing(fleet_problem, grid_states, n_nodes=6, seed=0)
        steps = knapsack.pricing_steps(v, w, b, c)
        rows.append(compare_on_card(steps, v.shape[1], label))
    for r in rows[-2:]:
        log(f"  {r['label']}: B={r['B']} T={r['T']} S={r['S']} "
            f"({r['S'] * 8} B of float64 per state row) exact")
    if rows[-2]["S"] != 30_940:
        raise AssertionError(f"main-path grid has {rows[-2]['S']} states, not 30940")
    if rows[-1]["S"] < 32_768:
        raise AssertionError(f"large grid has only {rows[-1]['S']} states")
    return rows


# --------------------------------------------------------------- phase 4


class LaunchRecorder:
    """During the main path: CUDA events right around every kernel launch
    (the C function `knapsack._dispatch` calls), and the inputs of the
    largest DP call on the card (by T*B*S)."""

    def __init__(self):
        self.events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.largest = None
        self._size = -1
        self._dp = knapsack._dispatch
        self._kernel_fn = knapsack._kernel_fn

    def _record_dp(self, step_values, step_weights, final_idx, levels):
        size = step_values.numel() * int(np.prod(levels))
        if step_values.device.type == "cuda" and size > self._size:
            self._size = size
            self.largest = (step_values.clone(), step_weights.clone(),
                            final_idx.clone(), tuple(levels))
        return self._dp(step_values, step_weights, final_idx, levels)

    def _timed_kernel_fn(self, dtype):
        fn = self._kernel_fn(dtype)

        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((start, end))
            return rc

        return launch

    def __enter__(self):
        knapsack._dispatch = self._record_dp
        knapsack._kernel_fn = self._timed_kernel_fn
        return self

    def __exit__(self, *exc):
        knapsack._dispatch = self._dp
        knapsack._kernel_fn = self._kernel_fn

    def kernel_ms(self) -> float:
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in self.events))


def phase_quickstart() -> float:
    catalog = (
        BinType("c4.2xlarge", (8, 15, 0, 0), 0.419),
        BinType("g2.2xlarge", (8, 15, 1536, 4), 0.650),
    )
    table = paper_profile_table()
    manager = ResourceManager(catalog, table)
    streams = [StreamSpec("cam-vgg", VGG, 0.25)] + [
        StreamSpec(f"cam-zf{i}", ZF, 0.55) for i in range(3)
    ]
    costs = {}
    for strategy in ALL_STRATEGIES:
        plan = manager.allocate(streams, strategy)
        plan.solution.validate()
        sim = simulate_plan(plan, table, target=manager.utilization_cap)
        if not sim["meets_target"]:
            raise AssertionError(f"{strategy.name}: simulated performance misses")
        costs[strategy.name] = plan.hourly_cost
        log(f"  scenario 1 {strategy.name}: ${plan.hourly_cost:.3f}/h "
            f"{plan.instance_counts()} optimal={plan.optimal}")
    savings = 1 - costs[ST3.name] / costs[ST1.name]
    if abs(savings - 0.61) > 0.005:
        raise AssertionError(f"ST3 saves {savings:.3f} vs ST1, not 0.61")
    log(f"  ST3 saves {savings:.1%} vs ST1 (paper: 61%)")
    return savings


def phase_main_path() -> dict:
    streams = camera_fleet(N_CAMERAS)
    table = paper_profile_table()
    manager = ResourceManager(paper_ec2_catalog(), table)  # default: the card
    if manager.device.type != "cuda":
        raise AssertionError(f"default manager device is {manager.device}")
    with LaunchRecorder() as rec:
        knapsack.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = manager.allocate(streams, ST3)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = knapsack.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path launched the knapsack kernel 0 times")
    plan.solution.validate()
    sim = simulate_plan(plan, table, target=manager.utilization_cap)
    if not sim["meets_target"]:
        raise AssertionError("500-camera plan misses the performance target")
    kernel_ms = rec.kernel_ms()
    log(f"  card plan: ${plan.hourly_cost:.3f}/h, {len(plan.instances)} instances, "
        f"optimal={plan.optimal}, {launches} kernel launches")
    log(f"  allocate wall {wall_s:.3f} s; kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / 1e3 / wall_s:.4%} of it); host {wall_s - kernel_ms / 1e3:.3f} s")

    cpu_manager = ResourceManager(paper_ec2_catalog(), table, device="cpu")
    t0 = time.perf_counter()
    cpu_plan = cpu_manager.allocate(streams, ST3)
    cpu_s = time.perf_counter() - t0
    if knapsack.LAUNCHES != launches:
        raise AssertionError("the CPU allocate launched the kernel")
    a, b = plan_to_plain(plan), plan_to_plain(cpu_plan)
    for key in a:
        same = (np.array_equal(a[key], b[key]) if isinstance(a[key], np.ndarray)
                else a[key] == b[key])
        if not same:
            raise AssertionError(f"card and CPU plans differ in {key}")
    log(f"  CPU plan (device='cpu', same process, {cpu_s:.3f} s): identical")
    log(f"  reference (JAX package, numpy pricing, CPU): "
        f"${REFERENCE_500[0]:.3f}/h, {REFERENCE_500[1]} instances")
    largest = rec.largest
    b_n, t_n = largest[0].shape
    return {
        "cameras": N_CAMERAS,
        "hourly_cost": plan.hourly_cost,
        "instances": len(plan.instances),
        "optimal": plan.optimal,
        "launches": launches,
        "allocate_wall_s": wall_s,
        "kernel_ms": kernel_ms,
        "host_s": wall_s - kernel_ms / 1e3,
        "cpu_allocate_s": cpu_s,
        "largest_call": {"B": b_n, "T": t_n, "S": int(np.prod(largest[3]))},
        "_largest": largest,
    }


# --------------------------------------------------------------- phase 5


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(largest) -> dict:
    step_values, step_weights, final_idx, levels = largest
    b_n, t_n = step_values.shape
    s_n = int(np.prod(levels))
    d_n = len(levels)
    before = knapsack.LAUNCHES
    # `_dispatch` launches the kernel without `knapsack_dp`'s checks, whose
    # device-to-host sync would land between the timed launches.
    ms = time_ms(lambda: knapsack._dispatch(*largest), reps=20)
    plain_ms = time_ms(lambda: knapsack.knapsack_dp_plain(*largest), reps=5)
    knapsack.LAUNCHES = before  # timing launches are not the main path's
    item = step_values.element_size()
    bytes_moved = (
        b_n * t_n * (item + 8 * d_n) + b_n * 8 + 2 * d_n * 8  # inputs
        + t_n * b_n * s_n + b_n * item  # take + best
    )
    ops = t_n * b_n * s_n * (d_n + 2)  # fits compares, one add, one compare
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SIMT_OPS_PER_S * 1e3
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at B={b_n} T={t_n} "
        f"S={s_n}; bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return {
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_moved, "ops": ops,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 3 (build and kernel checks)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    log("phase 1: device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {name} x{count}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(smi)

    log("phase 2: build")
    knapsack._kernel_fn(torch.float64)
    info = _build.BUILD_INFO["knapsack"]
    log(f"  knapsack.cu built in {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")

    log("phase 3: kernel vs plain on the card")
    fleet_problem = ResourceManager(
        paper_ec2_catalog(), paper_profile_table()
    ).formulate(camera_fleet(N_CAMERAS), ST3)
    checks = phase_kernel_vs_plain(fleet_problem)
    log(f"  {len(checks)} comparisons exact")
    result = {"device": name, "nvidia_smi": smi, "build_s": info["seconds"],
              "checks": checks}

    if not args.kernel_only:
        log(f"phase 4: main path ({N_CAMERAS} cameras)")
        result["quickstart_savings"] = phase_quickstart()
        main_path = phase_main_path()
        largest = main_path.pop("_largest")
        result["main_path"] = main_path
        log("phase 5: timing at the main path's largest call")
        timing = phase_timing(largest)
        result["timing"] = timing
        result["kernels"] = [{
            "name": "knapsack_dp",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knapsack.cu",
            "replaces": "src/repro/kernels/knapsack.py:277",
            "launches": main_path["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
        }]
    result["seconds"] = time.perf_counter() - t_start
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1, default=float))
    log(f"done in {result['seconds']:.1f} s")
    if args.kernel_only:
        return 0
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
