#!/usr/bin/env python3
"""Where the card's placement scores start to beat numpy's (needs a card).

`core.binpack.heuristics.placement_scores` scores the greedy repair's
(items x choices x open bins) candidate matrix on the card, through the
CUDA kernel in ``kernels/csrc/placement.cu``, from
``_CUDA_MIN_CANDIDATES`` candidates up, and with `placement_scores_np` on
the host below that.  This times both routes as the controller calls them,
host array in, writable host array out — for the card, the copies to it,
the launch and the copy back — at candidate matrices of k items, 2 choices
and P bins over 4 dimensions, and reports the crossover: the least
candidate count from which the card's route is faster at every measured
size.  Medians of ``--reps`` calls, host clock.

    PYTHONPATH=src python scripts/torch_placement_crossover.py [--json PATH]
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.binpack import heuristics  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

KS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
PS = (8, 40, 128)


def _median_us(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_placement_crossover: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    _build.build_all(("placement",))
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    rows = []
    saved = heuristics._CUDA_MIN_CANDIDATES
    try:
        heuristics._CUDA_MIN_CANDIDATES = 0  # every call takes the card's route
        for p_n in PS:
            for k in KS:
                req = rng.uniform(0.0, 2.0, size=(k, 2, 4))
                mask = np.ones((k, 2), dtype=bool)
                resid = rng.uniform(0.0, 2.0, size=(p_n, 4))
                numpy_us = _median_us(
                    lambda: heuristics.placement_scores_np(req, mask, resid), args.reps)
                card_us = _median_us(
                    lambda: heuristics.placement_scores(req, mask, resid, device=dev),
                    args.reps)
                rows.append({"k": k, "C": 2, "P": p_n, "candidates": k * 2 * p_n,
                             "numpy_us": numpy_us, "card_us": card_us})
                print(f"k={k:5d} P={p_n:4d} candidates={k * 2 * p_n:8d}  numpy "
                      f"{numpy_us:9.1f} us  card {card_us:9.1f} us", flush=True)
    finally:
        heuristics._CUDA_MIN_CANDIDATES = saved
    crossover = None
    for size in sorted({r["candidates"] for r in rows}):
        if all(r["card_us"] < r["numpy_us"] for r in rows if r["candidates"] >= size):
            crossover = size
            break
    print(f"crossover: the card's route is faster at every measured size from "
          f"{crossover} candidates up (the module's threshold: {saved})")
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"device": smi, "rows": rows, "crossover": crossover,
                                    "threshold": saved}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
