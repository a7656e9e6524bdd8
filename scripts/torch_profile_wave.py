"""Split a served model's prefill wave, or one decode step, between the
host and the card.

Serves random prompts to one model (``--arch``, default
qwen3-moe-30b-a3b) through `repro_torch.serving.ServingEngine` at full
width and depth in bf16 (random weights from seed 0), with
``chip_smoke.py``'s frame-analysis prompts (2048 tokens for gemma2-2b,
1024 for the others) over four slots.

* Prefill (the default): three waves, one new token a request (so one
  decode step a wave).  Each wave's ``forward_prefill`` call is timed.
* ``--decode``: one wave, 8 new tokens a request.  Each of its decode
  steps' ``forward_decode`` call is timed.

A timed call starts on an idle card (a synchronize before it) and is
timed with CUDA events, as in ``chip_smoke.py``, and on the host clock up
to its return (the host's issue time).  The last wave, or decode step 5
(after five warm steps), is traced with `torch.profiler` (host and
card), and the trace gives:

* the call on the host clock, from the call to the card going idle
  (the call ends with a synchronize);
* the card's busy time in it: the union of its kernel, copy and memset
  intervals, and the idle share ``1 - busy / call``;
* the card's time by kernel group (flash attention and its backward,
  flash-decode, the SSD and RG-LRU scans and their backwards, the grouped
  GEMM and its backward, library GEMMs, the rest) and the kernels that take the most;
* the host's kernel launches, its time waiting on the card (synchronizing
  calls and device-to-host copies) and its ops by self time.

The tracer slows the host down, so the untraced calls' times stand beside
the traced one's.  Needs one card.  Run from the repository root:

    PYTHONPATH=src python scripts/torch_profile_wave.py [--arch A] [--decode]
        [--label L] [--json FILE]

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

from repro_torch.configs import DEFAULT_TOKENS_PER_FRAME, get_config
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServingEngine

ARCH, SLOTS, WAVES = "qwen3-moe-30b-a3b", 4, 3
#: ``chip_smoke.py``'s prompts: the frame-analysis deployment's, and 1024
#: for qwen3-moe-30b-a3b, which has none.
PROMPT_TOKENS = {**DEFAULT_TOKENS_PER_FRAME, "qwen3-moe-30b-a3b": 1024}
#: ``--decode``: new tokens a request (decode steps), and the step traced.
DECODE_STEPS, TRACED_STEP = 8, 5
#: Where the Chrome trace goes (``build/`` is ignored by git).
TRACE = pathlib.Path(__file__).resolve().parents[1] / "build" / "profile" / "wave-trace.json"
#: Kernel groups by a piece of the kernel's name, first match wins
#: (``flash_kernel`` is the SIMT flash kernel's name in earlier commits, so
#: that a parent checkout can be traced beside this one).
GROUPS = (("flash attention", ("flash_wgmma", "flash_simt", "flash_kernel")),
          ("flash backward", ("flash_bwd",)),
          ("flash-decode", ("decode_mma", "decode_simt", "decode_combine")),
          ("SSD backward", ("ssd_bwd",)),
          ("SSD scan", ("ssd_mma", "ssd_cb", "ssd_simt", "ssd_kernel")),
          ("RG-LRU backward", ("rglru_bwd",)),
          ("RG-LRU scan", ("rglru_tma", "rglru_cp_async")),
          ("grouped GEMM backward", ("grouped_gemm_bwd",)),
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
    """The host/card split of the call annotated ``wave_name`` (a prefill
    wave or a decode step) from a Chrome trace of `torch.profiler`."""
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
    ap.add_argument("--arch", default=ARCH, choices=sorted(PROMPT_TOKENS),
                    help="the served model (default %(default)s)")
    ap.add_argument("--decode", action="store_true",
                    help="trace one decode step instead of a prefill wave")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_wave: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    prompt_tokens = PROMPT_TOKENS[args.arch]
    new_tokens = DECODE_STEPS if args.decode else 1
    requests = SLOTS if args.decode else WAVES * SLOTS
    cfg = get_config(args.arch)
    params = tfm.init_params(cfg, seed=0)
    engine = ServingEngine(cfg, params, batch_slots=SLOTS,
                           max_seq=prompt_tokens + new_tokens)
    rng = np.random.RandomState(0)
    for rid in range(requests):
        engine.submit(Request(rid=rid, prompt=rng.randint(0, cfg.vocab_size, prompt_tokens),
                              max_new_tokens=new_tokens))

    name, traced_index = (("decode step", TRACED_STEP) if args.decode
                          else ("prefill wave", WAVES - 1))
    attr = "forward_decode" if args.decode else "forward_prefill"
    forward = getattr(tfm, attr)
    calls: list[dict] = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def timed(*a, **kw):
        traced = len(calls) == traced_index
        torch.cuda.synchronize()
        if traced:
            prof.start()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"{name} {len(calls)}"):
            t0 = time.perf_counter()
            start.record()
            out = forward(*a, **kw)
            end.record()
            issue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if traced:
            prof.stop()
        calls.append({"traced": traced, "event_ms": start.elapsed_time(end),
                      "host_issue_ms": issue_ms, "host_wall_ms": wall_ms})
        return out

    setattr(tfm, attr, timed)
    try:
        engine.run()
    finally:
        setattr(tfm, attr, forward)
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    split = split_trace(json.loads(TRACE.read_text()), f"{name} {traced_index}")
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    result = {
        "label": args.label, "arch": args.arch, "mode": "decode" if args.decode else "prefill",
        "nvidia_smi": smi, "torch": torch.__version__, "prompt_tokens": prompt_tokens,
        "slots": SLOTS, "calls": calls, "traced_call": split,
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
