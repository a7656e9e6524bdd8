"""Split one 640x480 frame of VGG-16 and of ZF between the host and the card.

Runs each analysis program of `repro_torch.models.analysis_programs`
(`PROGRAMS`, seeded weights, float32 with TF32 off as in
``chip_smoke.py``) on the card, one frame a call: three warm calls, then
``--frames`` calls timed with CUDA events (median) and on the host clock
(issue time, and wall time to a synchronize), then one call traced with
`torch.profiler`.  The trace gives, by `torch_profile_wave.split_trace`:
the call's wall time, the card's busy time and idle share, its time by
kernel group (convolutions, library GEMMs, the rest), the kernels that
take the most, and the host's launches.  Each traced call starts on an
idle card and ends with a synchronize.  Needs one card.  Run from the
repository root:

    PYTHONPATH=src python scripts/torch_profile_programs.py [--frames N] [--json FILE]

It prints one JSON object on its last line; ``--json`` also writes it to a
file.  The Chrome trace goes to ``TRACE``.
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

import torch_profile_wave as wave
from repro_torch.core.streams import FrameSize
from repro_torch.models import analysis_programs

FRAME = FrameSize(640, 480)
#: Where the Chrome trace goes (``build/`` is ignored by git).
TRACE = pathlib.Path(__file__).resolve().parents[1] / "build" / "profile" / "programs-trace.json"
#: Kernel groups by a piece of the kernel's name, first match wins.
GROUPS = (("convolution", ("conv", "fprop", "implicit", "winograd", "dgrad", "cudnn")),
          ("library GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20, help="timed calls a program")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_programs: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    frame = analysis_programs.make_frame(FRAME)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    timed = {}
    for pid, run in analysis_programs.PROGRAMS.items():
        for _ in range(3):
            run(frame)
        events, issue, walls = [], [], []
        for _ in range(args.frames):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run(frame)
            end.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            events.append((start, end))
        timed[pid] = {"event_ms": float(np.median([s.elapsed_time(e) for s, e in events])),
                      "host_issue_ms": float(np.median(issue)),
                      "host_wall_ms": float(np.median(walls))}
    torch.cuda.synchronize()
    prof.start()
    for pid, run in analysis_programs.PROGRAMS.items():
        with torch.profiler.record_function(f"{pid} frame"):
            run(frame)
            torch.cuda.synchronize()
    prof.stop()
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    trace = json.loads(TRACE.read_text())
    wave.GROUPS = GROUPS
    result = {"nvidia_smi": smi, "torch": torch.__version__, "frame": str(FRAME),
              "frames": args.frames,
              "programs": {pid: {**timed[pid], "traced_call": wave.split_trace(
                  trace, f"{pid} frame")} for pid in timed}}
    line = json.dumps(result)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
