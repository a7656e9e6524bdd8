"""Lifecycle experiment 3 on the card, two checkouts of the repo alternating.

    python scripts/torch_growth_ab.py PARENT_DIR [--pairs 10]

``chip_smoke.live_growth`` (``benchmarks/lifecycle.py`` experiment 3
through the port's live loop, every what-if on the pack scan, checked
against the reference's goldens) runs in two worker processes: one imports
the checkout at PARENT_DIR, the other the checkout holding this script.
Each worker runs the experiment once to build and warm up, then the two
take turns, parent, change, change, parent, ..., ``--pairs`` runs each; one
runs at a time, the other waits on its input.  Prints every run's wall
seconds as it comes and, last, one JSON line with both lists and the
card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def worker(root: str) -> int:
    """Reads a line a run from stdin; runs experiment 3 and answers with its
    wall seconds as one JSON line after ``AB `` (the script's log lines go
    to stdout too)."""
    sys.path.insert(0, root)
    import chip_smoke as cs  # the checkout's own script and package

    for line in sys.stdin:
        if line.strip() != "run":
            break
        with cs.LiveClock() as clock:
            out = cs.live_growth(clock)
        print("AB " + json.dumps({"wall_s": out["wall_s"], "what_ifs": out["what_ifs"]}),
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", nargs="?", help="the parent checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    import torch

    if not torch.cuda.is_available():
        print("torch_growth_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    roots = {"parent": str(pathlib.Path(args.parent).resolve()), "change": str(HERE)}
    procs = {name: subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker", root],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=root)
        for name, root in roots.items()}
    walls = {name: [] for name in procs}

    def run(name: str) -> float:
        proc = procs[name]
        proc.stdin.write("run\n")
        proc.stdin.flush()
        while True:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the {name} worker ended (exit {proc.wait()})")
            if line.startswith("AB "):
                return json.loads(line[3:])["wall_s"]

    try:
        warm = {name: run(name) for name in procs}
        print(f"warm-up runs: {warm}", flush=True)
        for i in range(args.pairs):
            for name in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                wall = run(name)
                walls[name].append(wall)
                print(f"pair {i} {name} {wall:.3f} s", flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.stdin.close()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    print(json.dumps({"nvidia_smi": smi, "wall_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
