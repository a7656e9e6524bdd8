"""Deep-dive into the allocator: multi-GPU bins, solver cross-checks.

The PyTorch port of `examples/allocation_demo.py`.  Demonstrates paper
§3.2's dimension expansion (2 + 2N dims for N-GPU instances: g2.8xlarge =
4 GPUs -> 10-dim vectors, 1 + N = 5 choices per stream) and cross-validates
all three solver backends on the same fleet.  The FFD heuristic runs on
the card (the ``pack_scan`` kernel) unless ``--device cpu`` is given, and
is checked against its host version.

Run:  PYTHONPATH=src python examples/torch_allocation_demo.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.binpack import (
    Choice, Item, Problem,
    first_fit_decreasing, first_fit_decreasing_device, solve, solve_arcflow,
)
from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.device import resolve_device


def multi_gpu_fleet(n_streams: int = 6) -> Problem:
    catalog = paper_ec2_catalog(include_multi_gpu=True)  # 10-dim space
    items = []
    rng = np.random.RandomState(3)
    for i in range(n_streams):
        cpu_cores = rng.uniform(1.5, 4.0)
        # Choice 0: CPU execution. Choices 1..4: one per GPU slot.
        choices = [Choice("cpu", (cpu_cores, 0.6) + (0.0,) * 8)]
        for gpu in range(4):
            acc = [0.0] * 8
            acc[2 * gpu] = rng.uniform(80, 250)  # GPU cores
            acc[2 * gpu + 1] = rng.uniform(0.2, 0.5)  # GPU memory
            choices.append(Choice(f"gpu{gpu}", (cpu_cores * 0.14, 0.6, *acc)))
        items.append(Item(f"s{i}", tuple(choices)))
    return Problem(bin_types=catalog, items=tuple(items), utilization_cap=0.9)


def main(argv=None) -> dict:
    """Returns ``{"exact", "arcflow", "ffd"}``: each backend's $/h."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    problem = multi_gpu_fleet()
    print(f"fleet: {len(problem.items)} streams, "
          f"{len(problem.items[0].choices)} choices each "
          f"(1 CPU + 4 GPU slots), dim={problem.dim}")

    exact, stats = solve(problem)
    print(f"\nbin-completion exact: ${exact.cost:.3f} "
          f"({stats.nodes} nodes, optimal={stats.optimal})")
    for i, b in enumerate(exact.bins):
        util = np.asarray(b.load) / np.asarray(b.bin_type.capacity).clip(1e-9)
        members = [
            (problem.items[a.item_index].name,
             problem.items[a.item_index].choices[a.choice_index].label)
            for a in exact.assignments if a.bin_index == i
        ]
        print(f"  [{i}] {b.bin_type.name}: {members} "
              f"max_util={np.nanmax(util):.0%}")

    af, af_stats = solve_arcflow(problem)
    print(f"arc-flow DP:          ${af.cost:.3f} "
          f"({af_stats.n_patterns} patterns, {af_stats.n_classes} classes)")
    ffd = first_fit_decreasing_device(problem, device=dev)
    host_ffd = first_fit_decreasing(problem)
    print(f"FFD heuristic ({dev}): ${ffd.cost:.3f} "
          f"(+{(ffd.cost / exact.cost - 1):.0%} vs exact)")
    assert abs(af.cost - exact.cost) < 1e-6, "solvers disagree!"
    assert ffd.cost == host_ffd.cost and ffd.assignments == host_ffd.assignments, (
        "FFD on the device and on the host disagree")
    print("\nsolvers agree on the optimum — multi-GPU dimension expansion OK")
    return {"exact": exact.cost, "arcflow": af.cost, "ffd": ffd.cost}


if __name__ == "__main__":
    main()
