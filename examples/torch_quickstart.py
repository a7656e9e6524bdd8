"""Quickstart: the paper's pipeline in 60 seconds, on the port.

The PyTorch port of `examples/quickstart.py`:

1. Profile analysis programs (paper Table 3 profiles).
2. Formulate + exactly solve the multiple-choice vector bin packing
   (branch-and-price prices its columns with the knapsack kernel on the
   card; ``--device cpu`` runs its plain version).
3. Print the allocation plan and simulated fleet performance, and check
   the paper's headline: ST3 saves 61% against ST1.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core.binpack import BinType
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.core.streams import AnalysisProgram, StreamSpec

#: The paper's saving of ST3 against ST1 on scenario 1, and the slack allowed.
PAPER_SAVINGS, SAVINGS_SLACK = 0.61, 0.005


def main(argv=None) -> dict:
    """Returns ``{"costs": {strategy: $/h}, "savings": ST3's against ST1}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    vgg = AnalysisProgram("VGG-16", "vgg16")
    zf = AnalysisProgram("ZF", "zf")

    # Paper scenario 1: one VGG stream at 0.25 FPS, three ZF at 0.55 FPS.
    streams = [StreamSpec("cam-vgg", vgg, 0.25)] + [
        StreamSpec(f"cam-zf{i}", zf, 0.55) for i in range(3)
    ]
    catalog = (
        BinType("c4.2xlarge", (8, 15, 0, 0), 0.419),
        BinType("g2.2xlarge", (8, 15, 1536, 4), 0.650),
    )
    table = paper_profile_table()
    manager = ResourceManager(catalog, table, device=args.device)

    costs = {}
    for strategy in ALL_STRATEGIES:
        plan = manager.allocate(streams, strategy)
        plan.solution.validate()
        sim = simulate_plan(plan, table, target=manager.utilization_cap)
        print(f"\n=== {strategy.name}: {strategy.description}")
        print(plan.summary())
        print(f"simulated performance: {sim['overall_performance']:.0%} "
              f"(target >= 90%: {'OK' if sim['meets_target'] else 'MISS'})")
        if not sim["meets_target"]:
            raise AssertionError(f"{strategy.name}: simulated performance misses the target")
        costs[strategy.name] = plan.hourly_cost

    st1, st3 = ALL_STRATEGIES[0].name, ALL_STRATEGIES[2].name
    savings = 1 - costs[st3] / costs[st1]
    print(f"\nST3 saves {savings:.0%} vs ST1 (paper: 61%)")
    if abs(savings - PAPER_SAVINGS) > SAVINGS_SLACK:
        raise AssertionError(f"ST3 saves {savings:.3f} vs ST1, not {PAPER_SAVINGS}")
    return {"costs": costs, "savings": savings}


if __name__ == "__main__":
    main()
