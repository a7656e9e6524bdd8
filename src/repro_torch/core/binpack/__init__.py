"""Multiple-choice vector bin packing (the paper's core formulation).

## The `ProblemTensors` architecture

Every solver in this package runs on one shared, precomputed dense view of
the `Problem`, built lazily by `Problem.tensors()` and cached on the
(frozen) instance:

* `req` — a padded `(n_items, max_choices, dim)` float64 requirement
  tensor; padded choice slots hold `+inf` so they fail every fit test
  without masking;
* `min_req` / `req_sum` — per-item cheapest-per-dim demand and per-choice
  totals, feeding the solvers' lower bounds and tie-break keys;
* `caps` / `costs` — the effective (utilization-capped) capacity matrix
  and cost vector over bin types;
* `frac` / `fits_alone` / `cheapest_host` — per (item, choice, bin type)
  utilization fractions, single-item fit booleans, and the memoized
  cheapest cost of hosting an item alone.

Consumers: `heuristics` (vectorized FFD/BFD — batched sort keys, one
`(bins, choices, dim)` broadcast fit test per item), `bincompletion`
(exact branch-and-bound with incremental suffix-demand bounds),
`arcflow` (pattern DP with covering-LP dual bounds), `colgen`
(branch-and-price, pricing on the card), and the manager's strategy
sweep, which derives restricted tensors for ST1/ST2 via
`ProblemTensors.restrict` instead of rebuilding from the object model.

The device half of `heuristics` — the batched FFD/BFD scan over many
fleets (`pack_device`, `batched_fleet_costs`, `batched_pack`, on the
``pack_scan`` kernel) and the repair's `placement_scores` (on the
placement kernel from a measured size up) — stands in for the reference's
jax-traced `pack_jax` family; `evacuation_scores` is numpy in both.
"""
from .problem import (
    Assignment,
    BinType,
    Choice,
    InfeasibleError,
    Item,
    OpenBin,
    Problem,
    ProblemTensors,
    Solution,
    build_solution,
)
from .heuristics import (
    batched_fleet_costs,
    batched_pack,
    best_fit_decreasing,
    best_fit_decreasing_device,
    evacuation_scores,
    first_fit_decreasing,
    first_fit_decreasing_device,
    pack_device,
    placement_scores,
    placement_scores_np,
)
from .bincompletion import (
    SolveStats,
    migration_subproblem,
    pinned_solution,
    root_lower_bound,
    solve,
)
from .arcflow import ArcflowStats, covering_search, dual_prices, solve_arcflow
from .colgen import ColumnPool, solve_colgen
from .bruteforce import solve_bruteforce

__all__ = [
    "Assignment",
    "BinType",
    "Choice",
    "InfeasibleError",
    "Item",
    "OpenBin",
    "Problem",
    "ProblemTensors",
    "Solution",
    "build_solution",
    "batched_fleet_costs",
    "batched_pack",
    "best_fit_decreasing",
    "best_fit_decreasing_device",
    "evacuation_scores",
    "first_fit_decreasing",
    "first_fit_decreasing_device",
    "pack_device",
    "placement_scores",
    "placement_scores_np",
    "SolveStats",
    "migration_subproblem",
    "pinned_solution",
    "root_lower_bound",
    "solve",
    "ArcflowStats",
    "ColumnPool",
    "covering_search",
    "dual_prices",
    "solve_arcflow",
    "solve_colgen",
    "solve_bruteforce",
]
