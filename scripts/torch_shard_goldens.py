#!/usr/bin/env python3
"""The JAX package's answers to `chip_smoke.py` phase 4c's replays.

Runs, through the reference package (`repro`, numpy on the CPU), the very
steps `chip_smoke.py`'s sharded-controller phase runs through the port —
its builders and replays take the package they drive as a namespace — and
prints the golden constants the phase holds the card run to:

* ``SHARD_GOLDEN`` — (a) `benchmarks/shard.py`'s 100,000-stream replay over
  512 cells: the summed certified lower bounds (serial, batched cold and
  warm, serial again on the batched twin), the per-event (cost, lower
  bound) digest, the end state (placements and instances, uids, billed
  cost), the routing and pricing counters, and the delta between the
  serial and the batched twin (the threaded fold is the port's alone);
* ``REPACK_GOLDEN`` — (b) the batched repair on the live cells of (a);
* ``PARITY_GOLDEN`` — (c) the cost parity at 500 streams (flat, one cell,
  8 cells with the market), on the benchmark trace's first
  `chip_smoke.PARITY_EVENTS` events;
* ``CHURN_GOLDEN`` — (d) a sharded `simulate_churn` on a spot catalog: the
  digest of its whole output dict.

The step times are printed to standard error; they are this machine's
CPU, not the card's.  Run from the repository root (a few minutes on one
CPU core; (a) holds two 100,000-stream controllers):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_shard_goldens.py [--only a c d]
"""
from __future__ import annotations

import argparse
import pathlib
import pprint
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro.core import shard  # noqa: E402
from repro.core import streams as st  # noqa: E402
from repro.core.catalog import paper_ec2_catalog, with_spot_variants  # noqa: E402
from repro.core.controller import FleetController  # noqa: E402
from repro.core.manager import ResourceManager  # noqa: E402
from repro.core.policy import ConsolidationPolicy  # noqa: E402
from repro.core.profiler import paper_profile_table  # noqa: E402
from repro.core.simulator import simulate_churn  # noqa: E402
from repro.core.strategies import ST3  # noqa: E402


def reference_package() -> types.SimpleNamespace:
    """The reference's names, as `chip_smoke.port_package` gives the port's."""
    return types.SimpleNamespace(
        st=st, ResourceManager=ResourceManager, ST3=ST3,
        ShardedController=shard.ShardedController, hash_cells=shard.hash_cells,
        FleetController=FleetController, ConsolidationPolicy=ConsolidationPolicy,
        paper_ec2_catalog=paper_ec2_catalog, paper_profile_table=paper_profile_table,
        with_spot_variants=with_spot_variants, simulate_churn=simulate_churn,
    )


def wall_tick(part: str):
    """A `tick` for the replays: each step's wall seconds, to stderr."""
    last = [time.perf_counter()]

    def tick(label):
        now = time.perf_counter()
        if label is not None:
            print(f"# ({part}) {label}: {now - last[0]:.2f} s", file=sys.stderr)
        last[0] = now

    return tick


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=("a", "c", "d"), default=("a", "c", "d"),
                    help="the parts to run ((b) runs with (a))")
    args = ap.parse_args()
    pkg = reference_package()
    if "a" in args.only:
        out, batched = cs.big_replay(pkg, wall_tick("a"), workers=False)
        print("SHARD_GOLDEN = " + pprint.pformat(out, sort_dicts=False))
        print("REPACK_GOLDEN = " + pprint.pformat(
            cs.shard_repack(pkg, batched, wall_tick("b")), sort_dicts=False))
        del batched
    if "c" in args.only:
        print("PARITY_GOLDEN = " + pprint.pformat(cs.cost_parity(pkg, wall_tick("c")),
                                                  sort_dicts=False))
    if "d" in args.only:
        print("CHURN_GOLDEN = " + pprint.pformat(cs.sharded_churn(pkg, wall_tick("d")),
                                                 sort_dicts=False))


if __name__ == "__main__":
    main()
