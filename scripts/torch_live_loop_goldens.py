#!/usr/bin/env python3
"""The JAX package's answers to `chip_smoke.py` phase 4b's three replays.

Replays, through the reference package (`repro`, numpy on the CPU), the
very traces `chip_smoke.py` builds for its live-loop phase — its trace
builders take the streams module they build events from — and prints the
golden constants the phase holds the port's card run to:

* ``LIVE_GOLDEN`` — (a) per event of the main path's churn after the
  500-camera allocate: (event, $/h, mode, migrated streams);
* ``REPLAN_GOLDEN`` — (b) `benchmarks/churn_replan.py`'s 500-stream,
  200-event replay on ``CALIBRATION_ec2.json``: the digest of the per-event
  (cost, mode, migrated, gap) rows (`chip_smoke.replay_digest`), modes
  counted;
* ``GROWTH_GOLDEN`` — (c) `benchmarks/lifecycle.py` experiment 3 (the
  acting autoscaler on the bursty growth trace, hourly billing, 2-minute
  boot): billed cost, degraded stream-seconds past the initial boot, spares
  provisioned.

Run from the repository root (several minutes on one CPU core):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_live_loop_goldens.py [--only a b c]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro.core import calibration as cal  # noqa: E402
from repro.core import streams as st  # noqa: E402
from repro.core.catalog import paper_ec2_catalog  # noqa: E402
from repro.core.lifecycle import BillingModel  # noqa: E402
from repro.core.manager import ResourceManager  # noqa: E402
from repro.core.policy import ActingAutoscaler  # noqa: E402
from repro.core.profiler import paper_profile_table  # noqa: E402
from repro.core.simulator import simulate_churn  # noqa: E402


def live_rows() -> list[tuple]:
    kinds = cs.fleet_kinds(st)
    fleet = [st.StreamSpec(f"cam{i}", *kinds[i % 10]) for i in range(cs.N_CAMERAS)]
    mgr = ResourceManager(paper_ec2_catalog(), paper_profile_table())
    t0 = time.perf_counter()
    plan = mgr.allocate(fleet)
    print(f"# (a) allocate ${plan.hourly_cost:.3f}/h in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    ctrl = mgr.controller(gap_threshold=cs.LIVE_GAP_THRESHOLD)
    rng = np.random.RandomState(cs.LIVE_SEED)
    rows = []
    for i in range(cs.LIVE_EVENTS):
        ev = cs.live_event(st, ctrl, rng, i)
        t0 = time.perf_counter()
        r = ctrl.apply(ev)
        rows.append((type(ev).__name__, r.plan.hourly_cost, r.mode, len(r.migrated)))
        print(f"# (a) {i} {rows[-1]} gap={r.gap:.4f} {time.perf_counter() - t0:.2f} s",
              file=sys.stderr)
    return rows


def replan_rows() -> list[tuple]:
    art = cal.CalibrationArtifact.load(ROOT / "CALIBRATION_ec2.json")
    mgr = ResourceManager(paper_ec2_catalog(), calibration=art,
                          max_nodes=cs.REPLAN_MAX_NODES)
    fleet, kinds = cs.replan_fleet(st)
    mgr.allocate(fleet)
    ctrl = mgr.controller()
    rng = np.random.RandomState(cs.REPLAN_SEED)
    rows = []
    for i in range(cs.REPLAN_EVENTS):
        r = ctrl.apply(cs.replan_event(st, kinds, ctrl, rng, (i + 1) * 0.02))
        rows.append((r.plan.hourly_cost, r.mode, len(r.migrated), r.gap))
    return rows


def growth_numbers() -> tuple:
    initial, trace, forecast = cs.growth_scenario(st)
    mgr = ResourceManager(paper_ec2_catalog(), paper_profile_table(),
                          max_nodes=cs.GROWTH_MAX_NODES)
    mgr.controller(gap_threshold=cs.GROWTH_GAP_THRESHOLD)
    out = simulate_churn(
        mgr, initial, trace, paper_profile_table(),
        policy=ActingAutoscaler(forecast=forecast, max_spares=cs.MAX_SPARES),
        billing=BillingModel(boot_hours=cs.BOOT_H, quantum_hours=1.0))
    return out["billed_cost"], cs.post_join_degraded(out), cs.spares_provisioned(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=("a", "b", "c"), default=("a", "b", "c"))
    args = ap.parse_args(argv)
    if "a" in args.only:
        print("LIVE_GOLDEN = (")
        for row in live_rows():
            print(f"    {row!r},")
        print(")")
    if "b" in args.only:
        rows = replan_rows()
        modes = {m: sum(r[1] == m for r in rows) for m in ("warm", "full", "noop")}
        print(f"REPLAN_GOLDEN = {{'digest': {cs.replay_digest(rows)!r}, 'modes': {modes!r}, "
              f"'final_cost': {rows[-1][0]!r}}}")
    if "c" in args.only:
        billed, degraded, spares = growth_numbers()
        print(f"GROWTH_GOLDEN = {{'billed_cost': {billed!r}, "
              f"'degraded_stream_seconds': {degraded!r}, 'spares_provisioned': {spares!r}}}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
