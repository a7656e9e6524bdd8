#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Drives the port's two paths — the paper's resource manager, with
branch-and-price pricing on the card, and the serving path of the analysis
programs at gemma2-2b's full width — and holds every CUDA kernel of those
paths against its plain torch version.  Phases, each raising on failure:

1. device: the card's name, count and power limit;
2. build: every kernel, from ``src/repro_torch/kernels/csrc``, one nvcc
   process per source, all at once;
3. knapsack kernel vs plain on the card, exact equality of ``best``, the
   take bits and the backtracked counts: a seeded sweep of small pricings
   (float64 and float32), the 500-camera fleet's pricing grid with 18
   knapsacks, and a grid larger than a block's shared memory;
4. manager path: the quickstart's paper scenario 1 under ST1-ST3 (61%
   headline), then a 500-camera, 10-kind fleet allocated on the card
   (routes to branch-and-price), with the kernel's launches counted and
   the plan compared with the same fleet allocated with ``device="cpu"``;
5. knapsack timing: kernel and plain version on the card at the manager
   path's largest pricing call, with CUDA events;
6. attention kernels vs plain on the card, float32 (atol = rtol = 2e-5)
   and bfloat16 (rtol one bf16 ulp, 2^-7, atol 1e-4): flash attention at
   gemma2-2b's served prefill (B=4, S=2048), at 8192 tokens with a
   binding 4096 window, at internlm2-1.8b's layer and at ragged lengths;
   flash-decode at gemma2-2b's served cache, a wrapped 4096-slot ring,
   internlm2-1.8b's cache and a ragged cache;
7. serving path: (a) the launcher `repro_torch.launch.serve.main` for
   full-width gemma2-2b (the manager plans the fleet, one engine per
   instance serves it); (b) frame analysis: a `ServingEngine` for
   full-width gemma2-2b in bf16 serves 8 requests of 2048-token prompts
   over 4 slots, 16 greedy tokens each, with both kernels' launches
   counted (26 per prefill wave, 26 per decode step) and CUDA events
   around every launch and every forward call;
8. attention timing and the model against its plain path: each kernel
   held against its plain version on the served inputs of phase 7(b)'s
   largest call, then timed there beside its plain version and a library
   yardstick (and at internlm2-1.8b's shape, where
   ``scaled_dot_product_attention`` computes the same function); then
   full-width gemma2-2b in float32, one 2 x 2048 prefill and 8 decode
   steps, on the kernels and again with the kernel dispatch patched to
   the plain versions, logits compared.

float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.  Phase 1 prints ``nvidia-smi``'s name and power limit on a line
of its own.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Needs one
CUDA card:

    python3 chip_smoke.py [--json PATH] [--kernel-only]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
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
from repro_torch.kernels import attention as flash  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

#: The JAX reference's result for the 500-camera fleet on a CPU, for the
#: reader: $/h and instance count (repro.core.manager, numpy pricing).
REFERENCE_500 = (24.657, 39)
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; non-tensor fp32 op/s;
#: dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: Kernel vs plain on the card, (atol, rtol).  Both compute in float32 and
#: differ only in the order of their sums: float32 keeps the reference's
#: 2e-5 (tests/test_kernels.py:16-18); in bfloat16 the two float32 results
#: round to outputs at most one bf16 ulp apart, which rtol 2^-7 covers, and
#: atol 1e-4 covers the float32 difference (at most 2.2e-6 measured).
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}
#: The serving path's model and its frame-analysis deployment.
ARCH = "gemma2-2b"
PROMPT_TOKENS = 2048  # DEFAULT_TOKENS_PER_FRAME["gemma2-2b"]
NEW_TOKENS = 16
SLOTS = 4
N_REQUESTS = 8
#: Phase 8: float32 logits of the kernel path vs the plain path.  Both are
#: float32 throughout; they differ only in the order of the attention
#: kernels' sums, carried through 26 layers.
MODEL_ATOL = 1e-3

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


# --------------------------------------------------------------- phase 6


def _normal(rng, shape, dtype) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", dtype)


def ring_positions(cache_len: int, cur: int) -> np.ndarray:
    """The ``pos`` buffer decode leaves after writing positions ``0..cur``
    to slot ``p % cache_len``: each slot holds its latest position."""
    slots = np.arange(cache_len)
    last = cur - (cur - slots) % cache_len
    return np.where(last >= 0, last, -1).astype(np.int32)


#: (label, B, S, H, KV, D, window, softcap)
FLASH_CASES = [
    ("gemma2-2b layer", 4, 2048, 8, 4, 256, None, 50.0),
    ("gemma2-2b, window binds", 1, 8192, 8, 4, 256, 4096, 50.0),
    ("internlm2-1.8b layer", 4, 512, 16, 8, 128, None, None),
    ("ragged S=77", 2, 77, 4, 2, 64, None, 30.0),
    ("ragged S=2047, window 100", 1, 2047, 4, 1, 64, 100, None),
]
#: (label, B, KV, R, D, L, cur, window, softcap, ring)
DECODE_CASES = [
    ("gemma2-2b cache", 4, 4, 2, 256, 2064, 2060, None, 50.0, False),
    ("wrapped ring", 4, 4, 2, 256, 4096, 6000, 4096, 50.0, True),
    ("internlm2-1.8b cache", 4, 8, 2, 128, 528, 520, None, None, False),
    ("ragged L=77", 3, 2, 4, 64, 77, 70, 32, None, False),
]


def _compare(label, dtype, got, want) -> dict:
    torch.cuda.synchronize()
    atol, rtol = TOLERANCE[dtype]
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{label} {dtype}: kernel vs plain max abs err {err:.3g} "
                             f"outside atol={atol} rtol={rtol}")
    return {"label": label, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err}


def phase_attention_vs_plain() -> list[dict]:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, b, s, h, kv, d, window, cap) in enumerate(FLASH_CASES):
            rng = np.random.RandomState(100 + i)
            q = _normal(rng, (b, s, h, d), dtype)
            k = _normal(rng, (b, s, kv, d), dtype)
            v = _normal(rng, (b, s, kv, d), dtype)
            got = flash.flash_attention(q, k, v, window=window, logit_softcap=cap)
            want = flash.flash_attention_plain(q, k, v, window=window, logit_softcap=cap)
            rows.append({"kernel": "flash_attention",
                         **_compare(f"flash {label}", dtype, got, want)})
        for i, (label, b, kv, r, d, cache_len, cur, window, cap, ring) in enumerate(
                DECODE_CASES):
            rng = np.random.RandomState(200 + i)
            q = _normal(rng, (b, kv, r, d), dtype)
            k = _normal(rng, (b, cache_len, kv, d), dtype)
            v = _normal(rng, (b, cache_len, kv, d), dtype)
            if ring:
                pos_np = ring_positions(cache_len, cur)
            else:
                pos_np = np.where(np.arange(cache_len) <= cur, np.arange(cache_len), -1)
            pos = torch.from_numpy(pos_np.astype(np.int32)).to("cuda")
            got = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=cap)
            want = decode.decode_attention_plain(q, k, v, pos, cur, window=window,
                                                 logit_softcap=cap)
            rows.append({"kernel": "decode_attention",
                         **_compare(f"decode {label}", dtype, got, want)})
    for r in rows:
        log(f"  {r['label']} {r['dtype']}: max abs err {r['max_abs_err']:.3g}")
    return rows


# --------------------------------------------------------------- phase 7


class ServeRecorder:
    """During the serving path: CUDA events right around every attention
    kernel launch (the C function each wrapper's `_kernel_fn` returns) and
    around every `forward_prefill` / `forward_decode` call; the inputs of
    the largest flash launch and of the last decode launch; the last
    position's logits of every prefill."""

    def __init__(self):
        self.launches = {"flash_attention": [], "decode_attention": []}
        self.forward = {"prefill": [], "decode": []}
        self.flash_args = None
        self.decode_args = None
        self.prefill_logits = []
        self._saved = (flash._kernel_fn, decode._kernel_fn, flash._dispatch,
                       decode._dispatch, tfm.forward_prefill, tfm.forward_decode)

    @staticmethod
    def _timed(events, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        return call

    def __enter__(self):
        kf_flash, kf_decode, d_flash, d_decode, prefill, decode_fwd = self._saved
        flash._kernel_fn = lambda dt: self._timed(self.launches["flash_attention"],
                                                  kf_flash(dt))
        decode._kernel_fn = lambda dt: self._timed(self.launches["decode_attention"],
                                                   kf_decode(dt))

        def flash_dispatch(q, k, v, window, cap):
            if self.flash_args is None or q.numel() > self.flash_args[0].numel():
                self.flash_args = (q, k, v, window, cap)  # never written after
            return d_flash(q, k, v, window, cap)

        def decode_dispatch(q, k, v, pos, cur, window, cap):
            # The cache is written before each launch and not after its last.
            self.decode_args = (q, k, v, pos, cur, window, cap)
            return d_decode(q, k, v, pos, cur, window, cap)

        def timed_prefill(*args, **kwargs):
            logits, caches = self._timed(self.forward["prefill"], prefill)(*args, **kwargs)
            self.prefill_logits.append(logits[:, -1].clone())
            return logits, caches

        flash._dispatch = flash_dispatch
        decode._dispatch = decode_dispatch
        tfm.forward_prefill = timed_prefill
        tfm.forward_decode = self._timed(self.forward["decode"], decode_fwd)
        return self

    def __exit__(self, *exc):
        (flash._kernel_fn, decode._kernel_fn, flash._dispatch, decode._dispatch,
         tfm.forward_prefill, tfm.forward_decode) = self._saved

    @staticmethod
    def total_ms(events) -> float:
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in events))


def _reset_attention_counts() -> None:
    flash.LAUNCHES = 0
    decode.LAUNCHES = 0


def phase_serve_launcher() -> dict:
    argv = ["--arch", ARCH, "--no-smoke-weights", "--streams", "3", "--requests", "2",
            "--new-tokens", "4"]
    with ServeRecorder() as rec:
        _reset_attention_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = (flash.LAUNCHES, decode.LAUNCHES)
    layers = get_config(ARCH).num_layers
    waves, steps = len(rec.forward["prefill"]), len(rec.forward["decode"])
    if counts != (layers * waves, layers * steps) or waves == 0 or steps == 0:
        raise AssertionError(f"launcher: {counts} launches for {waves} waves, {steps} steps")
    vocab = get_config(ARCH).vocab_size
    for rs in out["results"].values():
        for r in rs:
            if len(r.tokens) != 4 or not all(0 <= t < vocab for t in r.tokens):
                raise AssertionError(f"launcher request {r.rid}: bad tokens {r.tokens}")
    for logits in rec.prefill_logits:
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("launcher: non-finite prefill logits")
    log(f"  launcher: {len(out['plan'].instances)} instances "
        f"{out['plan'].instance_counts()}, {out['tokens']} tokens in {wall_s:.2f} s; "
        f"flash launches {counts[0]} ({waves} waves), decode launches {counts[1]} "
        f"({steps} steps)")
    return {"instances": len(out["plan"].instances), "hourly_cost": out["plan"].hourly_cost,
            "tokens": out["tokens"], "wall_s": wall_s, "waves": waves, "decode_steps": steps,
            "flash_launches": counts[0], "decode_launches": counts[1]}


def phase_frame_analysis(params) -> dict:
    cfg = get_config(ARCH)
    engine = ServingEngine(cfg, params, batch_slots=SLOTS, max_seq=PROMPT_TOKENS + NEW_TOKENS)
    rng = np.random.RandomState(0)
    for rid in range(N_REQUESTS):
        engine.submit(Request(rid=rid, prompt=rng.randint(0, cfg.vocab_size, PROMPT_TOKENS),
                              max_new_tokens=NEW_TOKENS))
    with ServeRecorder() as rec:
        _reset_attention_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"flash_attention": flash.LAUNCHES, "decode_attention": decode.LAUNCHES}
    waves, steps = len(rec.forward["prefill"]), len(rec.forward["decode"])
    expect = {"flash_attention": cfg.num_layers * waves,
              "decode_attention": cfg.num_layers * steps}
    if waves != N_REQUESTS // SLOTS or steps != waves * NEW_TOKENS or counts != expect:
        raise AssertionError(f"frame analysis: launches {counts} for {waves} waves and "
                             f"{steps} decode steps (expected {expect})")
    if sorted(r.rid for r in results) != list(range(N_REQUESTS)):
        raise AssertionError("frame analysis: missing results")
    for r in results:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"frame analysis request {r.rid}: bad tokens")
    for logits in rec.prefill_logits:
        if tuple(logits.shape) != (SLOTS, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("frame analysis: bad prefill logits")
    prefill_ms = [s.elapsed_time(e) for s, e in rec.forward["prefill"]]
    decode_ms = [s.elapsed_time(e) for s, e in rec.forward["decode"]]
    kernel_ms = {name: rec.total_ms(ev) for name, ev in rec.launches.items()}
    tokens = sum(len(r.tokens) for r in results)
    out = {
        "requests": N_REQUESTS, "prompt_tokens": PROMPT_TOKENS, "new_tokens": NEW_TOKENS,
        "slots": SLOTS, "waves": waves, "decode_steps": steps, "launches": counts,
        "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "prefill_ms": prefill_ms, "decode_ms_per_step": float(np.mean(decode_ms)),
        "kernel_ms": kernel_ms,
        "kernel_share": {n: ms / 1e3 / wall_s for n, ms in kernel_ms.items()},
        "prefill_kernel_share": kernel_ms["flash_attention"] / sum(prefill_ms),
        "decode_kernel_share": kernel_ms["decode_attention"] / sum(decode_ms),
        "_flash_args": rec.flash_args, "_decode_args": rec.decode_args,
    }
    log(f"  {N_REQUESTS} requests x {PROMPT_TOKENS}-token prompts, {SLOTS} slots: "
        f"{waves} waves, {steps} decode steps; flash launches {counts['flash_attention']}, "
        f"decode launches {counts['decode_attention']}")
    log(f"  wall {wall_s:.3f} s, {out['tokens_per_s']:.1f} generated tokens/s; prefill "
        f"{', '.join(f'{ms:.1f}' for ms in prefill_ms)} ms; decode "
        f"{out['decode_ms_per_step']:.3f} ms/step")
    log(f"  kernel time: flash {kernel_ms['flash_attention']:.2f} ms "
        f"({out['kernel_share']['flash_attention']:.2%} of wall, "
        f"{out['prefill_kernel_share']:.2%} of prefill), decode "
        f"{kernel_ms['decode_attention']:.2f} ms "
        f"({out['kernel_share']['decode_attention']:.2%} of wall, "
        f"{out['decode_kernel_share']:.2%} of decode)")
    return out


# --------------------------------------------------------------- phase 8


def time_cold_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` with L2 flushed before each call (events right
    around each call): the serving path reaches each kernel after other
    layers' weights have passed through L2.  A spin of about 1 ms before
    each flush lets the host queue the call before the card reaches the
    start event, so the host's launch time stays outside the events."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)  # clock cycles: about 1 ms at the H100's ~2 GHz
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in events]))


def flash_bound(q, k, window) -> dict:
    b, s, h, d = q.shape
    item = q.element_size()
    i = np.arange(s)
    pairs = int(np.minimum(i + 1, window).sum() if window else (i + 1).sum())
    ops = 4 * b * h * d * pairs  # q k^T and p v, 2 operations per multiply-add
    bytes_moved = 2 * q.numel() * item + 2 * k.numel() * item  # q, k, v in; o out
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def decode_bound(q, k, pos, cur, window) -> dict:
    b, kv, r, d = q.shape
    item = q.element_size()
    p = pos.cpu().numpy()
    valid = (p >= 0) & (p <= cur)
    if window:
        valid &= p > cur - window
    n_valid = int(valid.sum())
    ops = 4 * b * kv * r * d * n_valid
    bytes_moved = 2 * q.numel() * item + 2 * b * n_valid * kv * d * item + pos.numel() * 4
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def _bound(bytes_moved, ops, peak) -> dict:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "ops": ops}


def _sdpa_causal(q, k, v):
    """One library call: causal GQA attention on (B, S, H, D) tensors."""
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), is_causal=True, enable_gqa=True)
    return out.transpose(1, 2)


def _sdpa_decode(q, k, v, mask):
    """One library call: one-token GQA attention over a masked cache."""
    b, kv, r, d = q.shape
    out = F.scaled_dot_product_attention(
        q.reshape(b, kv * r, 1, d), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[None, None, None, :], enable_gqa=True)
    return out.reshape(b, kv, r, d)


def phase_attention_timing(flash_args, decode_args) -> dict:
    before = (flash.LAUNCHES, decode.LAUNCHES)
    q, k, v, window, cap = flash_args
    dq, dk, dv, pos, cur, dwin, dcap = decode_args
    served = [
        {"kernel": "flash_attention", **_compare(
            "flash served prefill", q.dtype, flash._dispatch(q, k, v, window, cap),
            flash.flash_attention_plain(q, k, v, window=window, logit_softcap=cap))},
        {"kernel": "decode_attention", **_compare(
            "decode served step", dq.dtype,
            decode._dispatch(dq, dk, dv, pos, cur, dwin, dcap),
            decode.decode_attention_plain(dq, dk, dv, pos, cur, window=dwin,
                                          logit_softcap=dcap))},
    ]
    for r in served:
        log(f"  {r['label']} {r['dtype']}: max abs err {r['max_abs_err']:.3g}")
    f = {"shape": list(q.shape), "kv_heads": k.shape[2], "window": window, "softcap": cap,
         "dtype": str(q.dtype).replace("torch.", "")}
    f["ms"] = time_cold_ms(lambda: flash._dispatch(q, k, v, window, cap), reps=10)
    f["plain_ms"] = time_cold_ms(lambda: flash.flash_attention_plain(
        q, k, v, window=window, logit_softcap=cap), reps=5)
    f.update(flash_bound(q, k, window))
    f["library_ms"] = None  # the softcap: no single library call computes it

    dd = {"shape": list(dq.shape), "cache_len": dk.shape[1], "cur": cur, "window": dwin,
          "softcap": dcap, "dtype": str(dq.dtype).replace("torch.", "")}
    dd["ms"] = time_cold_ms(lambda: decode._dispatch(dq, dk, dv, pos, cur, dwin, dcap), reps=50)
    dd["plain_ms"] = time_cold_ms(lambda: decode.decode_attention_plain(
        dq, dk, dv, pos, cur, window=dwin, logit_softcap=dcap), reps=20)
    dd.update(decode_bound(dq, dk, pos, cur, dwin))
    dd["library_ms"] = None

    # internlm2-1.8b's shapes: no window, no softcap, so SDPA computes the
    # same functions; it is timed here and used nowhere in the port.
    rng = np.random.RandomState(7)
    iq = _normal(rng, (4, 512, 16, 128), torch.bfloat16)
    ik = _normal(rng, (4, 512, 8, 128), torch.bfloat16)
    iv = _normal(rng, (4, 512, 8, 128), torch.bfloat16)
    ref = flash.flash_attention_plain(iq, ik, iv)
    lib_err = float((_sdpa_causal(iq, ik, iv).float() - ref.float()).abs().max())
    f["internlm2"] = {
        "shape": [4, 512, 16, 128], "kv_heads": 8,
        "ms": time_cold_ms(lambda: flash._dispatch(iq, ik, iv, None, None), reps=20),
        "plain_ms": time_cold_ms(lambda: flash.flash_attention_plain(iq, ik, iv), reps=10),
        "library_ms": time_cold_ms(lambda: _sdpa_causal(iq, ik, iv), reps=20),
        "library_max_abs_err": lib_err, **flash_bound(iq, ik, None),
    }
    cache_len, cur_i = 528, 527
    dq_i = _normal(rng, (4, 8, 2, 128), torch.bfloat16)
    dk_i = _normal(rng, (4, cache_len, 8, 128), torch.bfloat16)
    dv_i = _normal(rng, (4, cache_len, 8, 128), torch.bfloat16)
    pos_i = torch.arange(cache_len, dtype=torch.int32, device="cuda")
    mask = (pos_i >= 0) & (pos_i <= cur_i)
    ref = decode.decode_attention_plain(dq_i, dk_i, dv_i, pos_i, cur_i)
    lib_err = float((_sdpa_decode(dq_i, dk_i, dv_i, mask).float() - ref.float()).abs().max())
    dd["internlm2"] = {
        "shape": [4, 8, 2, 128], "cache_len": cache_len,
        "ms": time_cold_ms(lambda: decode._dispatch(dq_i, dk_i, dv_i, pos_i, cur_i, None, None),
                           reps=50),
        "plain_ms": time_cold_ms(lambda: decode.decode_attention_plain(
            dq_i, dk_i, dv_i, pos_i, cur_i), reps=20),
        "library_ms": time_cold_ms(lambda: _sdpa_decode(dq_i, dk_i, dv_i, mask), reps=50),
        "library_max_abs_err": lib_err, **decode_bound(dq_i, dk_i, pos_i, cur_i, None),
    }
    flash.LAUNCHES, decode.LAUNCHES = before  # timing launches are not the path's
    for name, t in (("flash_attention", f), ("decode_attention", dd)):
        i = t["internlm2"]
        log(f"  {name} at {t['shape']} {t['dtype']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); at "
            f"internlm2 {i['shape']}: kernel {i['ms']:.4f} ms, plain {i['plain_ms']:.4f} ms, "
            f"sdpa {i['library_ms']:.4f} ms, bound {i['bound_ms']:.4f} ms")
    return {"flash_attention": f, "decode_attention": dd, "served_checks": served}


def _model_logits(params, cfg, prompt, steps) -> list[torch.Tensor]:
    b, s = prompt.shape
    caches = tfm.init_serve_cache(cfg, b, s + steps.shape[1])
    logits, caches = tfm.forward_prefill(params, cfg, {"tokens": prompt}, caches)
    out = [logits]
    for t in range(steps.shape[1]):
        step, caches = tfm.forward_decode(params, cfg, steps[:, t:t + 1], s + t, caches)
        out.append(step)
    return out


def phase_model_vs_plain() -> dict:
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = tfm.init_params(cfg, seed=1)
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, PROMPT_TOKENS))).cuda()
    steps = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 8))).cuda()
    before = (flash.LAUNCHES, decode.LAUNCHES)
    t0 = time.perf_counter()
    kern = _model_logits(params, cfg, prompt, steps)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    launched = (flash.LAUNCHES - before[0], decode.LAUNCHES - before[1])
    if launched != (cfg.num_layers, cfg.num_layers * 8):
        raise AssertionError(f"float32 model: launches {launched}")
    saved = flash._dispatch, decode._dispatch
    flash._dispatch = lambda q, k, v, w, c: flash.flash_attention_plain(
        q, k, v, window=w, logit_softcap=c)
    decode._dispatch = lambda q, k, v, p, cur, w, c: decode.decode_attention_plain(
        q, k, v, p, cur, window=w, logit_softcap=c)
    try:
        t0 = time.perf_counter()
        plain = _model_logits(params, cfg, prompt, steps)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        flash._dispatch, decode._dispatch = saved
    flash.LAUNCHES, decode.LAUNCHES = before
    errs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    for a in kern:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("float32 model: non-finite logits")
    if max(errs) > MODEL_ATOL:
        raise AssertionError(f"float32 model: kernel vs plain logits differ by {max(errs):.3g} "
                             f"> {MODEL_ATOL}")
    log(f"  float32 gemma2-2b, 2 x {PROMPT_TOKENS} prefill + 8 decode steps: logits max abs "
        f"diff kernel vs plain {errs[0]:.3g} (prefill), {max(errs[1:]):.3g} (decode), "
        f"atol {MODEL_ATOL}; kernel path {kern_s:.2f} s, plain path {plain_s:.2f} s")
    return {"prefill_max_abs_err": errs[0], "decode_max_abs_err": max(errs[1:]),
            "atol": MODEL_ATOL, "kernel_path_s": kern_s, "plain_path_s": plain_s}


class PhaseTimer:
    """Prints each phase's title as it begins and its seconds as it ends."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._key, self._t0 = None, time.perf_counter()

    def begin(self, key: str, title: str) -> None:
        self.finish()
        self._key, self._t0 = key, time.perf_counter()
        log(f"{key}: {title}")

    def finish(self) -> dict[str, float]:
        if self._key is not None:
            self.seconds[self._key] = time.perf_counter() - self._t0
            log(f"  ({self._key}: {self.seconds[self._key]:.1f} s)")
            self._key = None
        return self.seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    ap.add_argument("--kernel-only", action="store_true",
                    help="run only phases 1-3 and 6 (build and kernel checks)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # The plain versions and the model's products compare in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = PhaseTimer()
    timer.begin("phase 1", "device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {name} x{count}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(smi)

    timer.begin("phase 2", "build")
    t0 = time.perf_counter()
    _build.build_all()
    build_wall = time.perf_counter() - t0
    for src, info in _build.BUILD_INFO.items():
        log(f"  {src}.cu built in {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"    {line.strip()}")
    log(f"  all sources built in {build_wall:.2f} s (in parallel)")

    timer.begin("phase 3", "knapsack kernel vs plain on the card")
    fleet_problem = ResourceManager(
        paper_ec2_catalog(), paper_profile_table()
    ).formulate(camera_fleet(N_CAMERAS), ST3)
    checks = phase_kernel_vs_plain(fleet_problem)
    log(f"  {len(checks)} comparisons exact")
    result = {"device": name, "nvidia_smi": smi, "build_s": build_wall,
              "build": {k: v["seconds"] for k, v in _build.BUILD_INFO.items()},
              "checks": checks}

    if not args.kernel_only:
        timer.begin("phase 4", f"manager path ({N_CAMERAS} cameras)")
        result["quickstart_savings"] = phase_quickstart()
        main_path = phase_main_path()
        largest = main_path.pop("_largest")
        result["main_path"] = main_path
        timer.begin("phase 5", "knapsack timing at the manager path's largest call")
        result["timing"] = phase_timing(largest)

    timer.begin("phase 6", "attention kernels vs plain on the card")
    attn_checks = phase_attention_vs_plain()
    result["attention_checks"] = attn_checks

    if not args.kernel_only:
        timer.begin("phase 7", f"serving path, full-width {ARCH}")
        result["serve_launcher"] = phase_serve_launcher()
        params = tfm.init_params(get_config(ARCH), seed=0)
        frame = phase_frame_analysis(params)
        del params
        flash_args, decode_args = frame.pop("_flash_args"), frame.pop("_decode_args")
        result["frame_analysis"] = frame
        timer.begin("phase 8", "attention timing; float32 model vs its plain path")
        attn_timing = phase_attention_timing(flash_args, decode_args)
        del flash_args, decode_args
        attn_checks += attn_timing.pop("served_checks")
        result["attention_timing"] = attn_timing
        result["model_vs_plain"] = phase_model_vs_plain()

        timing = result["timing"]
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
        for kname, source, replaces in (
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/attention.py:75"),
            ("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:72"),
        ):
            t = attn_timing[kname]
            result["kernels"].append({
                "name": kname,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": frame["launches"][kname],
                "max_abs_err": max(c["max_abs_err"] for c in attn_checks
                                   if c["kernel"] == kname),
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "internlm2": {k: t["internlm2"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms")},
            })
    result["phase_seconds"] = timer.finish()
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
