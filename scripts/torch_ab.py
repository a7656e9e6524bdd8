"""Two checkouts of the repo on the card, taking turns: parent against change.

    python scripts/torch_ab.py PARENT_DIR [--run growth|train_step] [--pairs 10]
        [--arch qwen3-moe-30b-a3b] [--steps 4]

Two worker processes each import one checkout's own ``chip_smoke`` (and
so its own package): PARENT_DIR's and the one holding this script.  Each
runs ``--run`` (one of `RUNS`) on request:

* ``growth``: ``chip_smoke.live_growth``, ``benchmarks/lifecycle.py``
  experiment 3 through the port's live loop, every what-if on the pack
  scan, checked against the reference's goldens; its record is the run's
  wall seconds and what-ifs;
* ``train_step``: ``chip_smoke.train_full_width`` for ``--arch`` with
  ``--steps`` steps (bf16, remat, the model cut as the checkout's
  ``TRAIN_RUNS`` says, its launch counts checked, the last step traced);
  its record is every step's row (wall, forward, backward and optimizer
  ms; the first step warms up), the launches, and the traced step's card
  idle share and ms by kernel group.  The run frees its model before it
  answers, since one model's state fills most of the card.

Each worker runs once to build and warm up, then the two take turns,
parent, change, change, parent, ..., ``--pairs`` runs each; one runs at a
time, the other waits on its input.  Prints each run as it comes and,
last, one JSON line with every record and the card's name and power
limit.  Needs one card.  Compare the two only inside one call: the
host-bound runs spread widely from one machine to the next.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _growth(cs, args) -> dict:
    with cs.LiveClock() as clock:
        out = cs.live_growth(clock)
    return {"wall_s": out["wall_s"], "what_ifs": out["what_ifs"]}


def _growth_line(record: dict) -> str:
    return f"{record['wall_s']:.3f} s"


def _train_step(cs, args) -> dict:
    cut, batch, _ = cs.TRAIN_RUNS[args.arch]
    cs.TRAIN_RUNS[args.arch] = (cut, batch, args.steps)
    out = cs.train_full_width(args.arch)
    traced = out["traced_step"]
    return {"steps": out["steps"], "launches": out["launches"],
            "device_idle_share": traced["device_idle_share"],
            "device_busy_ms": traced["device_busy_ms"],
            "device_ms_by_group": traced["device_ms_by_group"]}


def _train_step_line(record: dict) -> str:
    steps = "; ".join(f"step {r['step']} {r['wall_ms']:.1f} ms = {r['forward_ms']:.1f} + "
                      f"{r['backward_ms']:.1f} + {r['optimizer_ms']:.1f}"
                      + (" (traced)" if r["traced"] else "") for r in record["steps"])
    groups = {k: round(v, 1) for k, v in record["device_ms_by_group"].items()}
    return f"{steps}; traced idle {record['device_idle_share']:.3f}, groups {json.dumps(groups)}"


#: ``--run``: (what a worker runs in its checkout's chip_smoke, the line
#: printed for its record).
RUNS = {"growth": (_growth, _growth_line), "train_step": (_train_step, _train_step_line)}


def worker(root: str, args) -> int:
    """Reads a line a run from stdin; runs ``args.run`` and answers with its
    record as one JSON line after ``AB `` (the script's log lines go to
    stdout too)."""
    sys.path.insert(0, root)
    import chip_smoke as cs  # the checkout's own script and package
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cudnn.allow_tf32 = False
    run = RUNS[args.run][0]
    for line in sys.stdin:
        if line.strip() != "run":
            break
        print("AB " + json.dumps(run(cs, args)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", nargs="?", help="the parent checkout's root")
    ap.add_argument("--run", choices=sorted(RUNS), default="growth")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b", help="train_step's model")
    ap.add_argument("--steps", type=int, default=4, help="train_step's steps a run")
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args)
    import torch

    if not torch.cuda.is_available():
        print("torch_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.parent is None:
        ap.error("the parent checkout's root is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    roots = {"parent": str(pathlib.Path(args.parent).resolve()), "change": str(HERE)}
    procs = {name: subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker", root,
         "--run", args.run, "--arch", args.arch, "--steps", str(args.steps)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=root)
        for name, root in roots.items()}
    records = {name: [] for name in procs}
    line_of = RUNS[args.run][1]

    def run(name: str) -> dict:
        proc = procs[name]
        proc.stdin.write("run\n")
        proc.stdin.flush()
        while True:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the {name} worker ended (exit {proc.wait()})")
            if line.startswith("AB "):
                return json.loads(line[3:])

    try:
        for name in procs:
            print(f"warm-up {name}: {line_of(run(name))}", flush=True)
        for i in range(args.pairs):
            for name in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                record = run(name)
                records[name].append(record)
                print(f"pair {i} {name}: {line_of(record)}", flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.stdin.close()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    print(json.dumps({"nvidia_smi": smi, "run": args.run, "arch": args.arch,
                      "steps": args.steps, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
