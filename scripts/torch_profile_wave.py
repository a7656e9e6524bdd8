"""Split a served model's prefill wave between the host and the card.

Serves three waves of four random 1024-token prompts to
qwen3-moe-30b-a3b through `repro_torch.serving.ServingEngine` at full
width and depth in bf16 (random weights from seed 0, one new token a
request, so one decode step a wave), as ``chip_smoke.py``'s frame
analysis does.  Each wave's ``forward_prefill`` call is timed with CUDA
events, as there, and on the host clock up to its return (the host's
issue time).  The last wave is
traced with `torch.profiler` (host and card), and the trace gives:

* the wave on the host clock, from the call to the card going idle
  (the call ends with a synchronize);
* the card's busy time in it: the union of its kernel, copy and memset
  intervals, and the idle share ``1 - busy / wave``;
* the card's time by kernel group (flash attention, grouped GEMM,
  library GEMMs, the rest) and the kernels that take the most;
* the host's time waiting on the card (synchronizing calls and
  device-to-host copies) and its ops by self time.

The tracer slows the host down, so the untraced waves' times stand beside
the traced one's.  Needs one card.  Run from the repository root:

    PYTHONPATH=src python scripts/torch_profile_wave.py [--label L] [--json FILE]

With ``PYTHONPATH`` at another checkout's ``src`` it traces that commit's
port.  It prints one JSON object on its last line; ``--json`` also writes
it to a file.  The Chrome trace goes to ``TRACE``.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServingEngine

ARCH, PROMPT_TOKENS, SLOTS, WAVES = "qwen3-moe-30b-a3b", 1024, 4, 3
#: Where the Chrome trace goes (``build/`` is ignored by git).
TRACE = pathlib.Path(__file__).resolve().parents[1] / "build" / "profile" / "wave-trace.json"
#: Kernel groups by a piece of the kernel's name, first match wins
#: (``flash_kernel`` is the SIMT flash kernel's name in earlier commits, so
#: that a parent checkout can be traced beside this one).
GROUPS = (("flash attention", ("flash_wgmma", "flash_simt", "flash_kernel")),
          ("grouped GEMM", ("grouped_gemm",)),
          ("library GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host calls that wait for the card.
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaMemcpyAsync")


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "the rest"


def _union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def split_trace(trace: dict, wave_name: str) -> dict:
    """The wave's host/card split from a Chrome trace of `torch.profiler`."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    wave = next(e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == wave_name)
    t0, t1 = wave["ts"], wave["ts"] + wave["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    clipped = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device]
    busy = _union_us(clipped)
    by_group, by_kernel = collections.Counter(), collections.Counter()
    for e, (a, b) in zip(device, clipped):
        by_group[_group(e["name"])] += (b - a) / 1e3
        by_kernel[e["name"][:100]] += (b - a) / 1e3
    waits = [e for e in events if e.get("cat") == "cuda_runtime" and e["name"] in WAITS
             and t0 <= e["ts"] < t1]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and "Launch" in e["name"] and t0 <= e["ts"] < t1)
    return {
        "trace_categories": dict(collections.Counter(e.get("cat") for e in events)),
        "wave_ms": wave["dur"] / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wave["dur"],
        "device_ms_by_group": dict(by_group.most_common()),
        "top_kernels_ms": dict(by_kernel.most_common(12)),
        "device_ops": len(device),
        "host_launch_calls": launches,
        "host_wait_ms": sum(e["dur"] for e in waits) / 1e3,
        "host_waits": dict(collections.Counter(e["name"] for e in waits)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this run in the output")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_wave: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    cfg = get_config(ARCH)
    params = tfm.init_params(cfg, seed=0)
    engine = ServingEngine(cfg, params, batch_slots=SLOTS, max_seq=PROMPT_TOKENS + 1)
    rng = np.random.RandomState(0)
    for rid in range(WAVES * SLOTS):
        engine.submit(Request(rid=rid, prompt=rng.randint(0, cfg.vocab_size, PROMPT_TOKENS),
                              max_new_tokens=1))

    prefill = tfm.forward_prefill
    waves: list[dict] = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def timed_prefill(*a, **kw):
        traced = len(waves) == WAVES - 1
        torch.cuda.synchronize()
        if traced:
            prof.start()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"prefill wave {len(waves)}"):
            t0 = time.perf_counter()
            start.record()
            out = prefill(*a, **kw)
            end.record()
            issue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if traced:
            prof.stop()
        waves.append({"traced": traced, "event_ms": start.elapsed_time(end),
                      "host_issue_ms": issue_ms, "host_wall_ms": wall_ms})
        return out

    tfm.forward_prefill = timed_prefill
    try:
        engine.run()
    finally:
        tfm.forward_prefill = prefill
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    split = split_trace(json.loads(TRACE.read_text()), f"prefill wave {WAVES - 1}")
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    result = {
        "label": args.label, "arch": ARCH, "nvidia_smi": smi,
        "torch": torch.__version__, "prompt_tokens": PROMPT_TOKENS,
        "slots": SLOTS, "waves": waves, "traced_wave": split,
        "host_ops_self_ms": {e.key: [e.count, e.self_cpu_time_total / 1e3]
                             for e in host_ops},
    }
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
