"""Exact branch-and-bound solver for multiple-choice vector bin packing.

The paper solves MC-VBP with VPSolver (arc-flow MILP + a commercial MILP
backend).  No MILP solver is available offline, so this module provides an
exact combinatorial branch-and-bound in the spirit of Korf's bin-completion,
generalized to:

* multiple choices per item (CPU vs GPU execution vectors),
* heterogeneous bin types with monetary costs (min-cost, not min-count),
* real-valued multi-dimensional capacities with a utilization cap.

Search: items are processed in FFD order; each node branches on placing the
next item into (a) an already-open bin (deduplicated by residual-capacity
signature, which collapses the permutation symmetry of identical bins) or
(b) a freshly opened bin of each non-dominated type.  Nodes are pruned with
an admissible lower bound combining a per-dimension cost-density relaxation
with a cheapest-forced-new-bin bound.

Per-node cost is kept O(dim) + one small vectorized fit test by maintaining
everything incrementally on the shared `ProblemTensors` cache:

* suffix demand sums over the FFD order are precomputed once, so the
  density bound reads one row instead of re-stacking the remaining items;
* the total open residual is a running vector updated on place/unplace;
* the best capacity-per-dollar densities are constants hoisted out of the
  node loop entirely;
* the forced-new-bin bound is only evaluated when the density bound alone
  fails to prune, uses the memoized per-item cheapest hosting cost, and
  tests all remaining items against all open bins in one broadcast;
* the open-bin fit test is one `(bins, choices)` comparison per node.

Optimality is certified when the search space is exhausted (`stats.optimal`).
A node budget keeps worst cases bounded; on exhaustion the incumbent (never
worse than FFD/BFD) is returned with `optimal=False`.

Warm starts (the live re-planning loop): `solve` accepts

* ``incumbent=`` — a feasible `Solution` whose cost seeds the upper bound.
  A near-optimal incumbent (e.g. the previous plan repaired after a fleet
  event) prunes most of the tree immediately, so re-plans certify in a
  tiny fraction of a cold solve's nodes.  If the search finds nothing
  strictly cheaper, the incumbent object itself is returned.
* ``pinned=`` — pre-opened bins (`OpenBin`: type + existing load) whose
  contents are fixed.  The solver packs only `problem.items` (the
  displaced/new streams) into the pinned bins' residual effective capacity
  or freshly opened bins, minimizing total cost (pinned bin costs are
  included as a constant).  The returned solution is built over an
  *augmented* problem in which each pinned bin's existing load appears as
  one ghost item (name ``__pinned<j>``, single choice labelled
  ``pinned``) assigned to bin ``j`` — see `pinned_solution` — so
  `Solution.validate` holds exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .heuristics import best_fit_decreasing, first_fit_decreasing
from .problem import (
    BinType,
    Choice,
    InfeasibleError,
    Item,
    OpenBin,
    Problem,
    Solution,
    build_solution,
)

__all__ = [
    "solve",
    "SolveStats",
    "pinned_solution",
    "migration_subproblem",
    "root_lower_bound",
]

_EPS = 1e-9
_INF = float("inf")


@dataclasses.dataclass
class SolveStats:
    nodes: int = 0
    pruned: int = 0
    optimal: bool = True
    incumbent_updates: int = 0
    # Pattern/column work counters, shared vocabulary with `ArcflowStats`
    # so benchmarks can report any solver uniformly.  The placement B&B
    # enumerates bin completions rather than pricing an LP, so
    # `patterns_enumerated` counts completions tried and the colgen-style
    # counters stay 0 unless a pricing-based solver fills them in.
    patterns_enumerated: int = 0
    columns_generated: int = 0
    pricing_rounds: int = 0


def _non_dominated_bins(problem: Problem) -> list[int]:
    """Indices of bin types not dominated by a cheaper >=-capacity type."""
    keep: list[int] = []
    for i, bt in enumerate(problem.bin_types):
        dominated = False
        for other in problem.bin_types:
            if other is bt:
                continue
            if (
                other.cost <= bt.cost + _EPS
                and all(oc + _EPS >= bc for oc, bc in zip(other.capacity, bt.capacity))
                and (
                    other.cost < bt.cost - _EPS
                    or any(oc > bc + _EPS for oc, bc in zip(other.capacity, bt.capacity))
                )
            ):
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return keep or list(range(len(problem.bin_types)))


def root_lower_bound(problem: Problem) -> float:
    """Admissible lower bound on any feasible solution's cost, O(n·dim).

    The search's depth-0 bound with no open bins: the per-dimension
    cost-density relaxation over total minimum demand, and the cheapest
    host forced by the hardest single item (any solution contains a bin
    that hosts that item, so costs at least its cheapest lone host).
    """
    t = problem.tensors()
    n = t.req.shape[0]
    if n == 0:
        return 0.0
    lb = 0.0
    total = t.min_req.sum(axis=0)
    for d in range(total.shape[0]):
        bd = float(t.best_density[d])
        if total[d] > _EPS and 0.0 < bd < _INF:
            lb = max(lb, float(total[d]) / bd)
    finite = t.cheapest_host[np.isfinite(t.cheapest_host)]
    if finite.size:
        lb = max(lb, float(finite.max()))
    return lb


def pinned_solution(
    problem: Problem,
    pinned: Sequence[OpenBin],
    placements: Sequence[tuple[int, int, int]],
    opened_new: Sequence[BinType],
) -> Solution:
    """Build a validated `Solution` for a pinned sub-solve.

    `placements` are (item, choice, bin) triples over `problem.items`,
    where bins ``0..len(pinned)-1`` are the pinned bins (in order) and
    higher indices refer to `opened_new`.  Each pinned bin's existing load
    becomes a ghost item appended after `problem.items`, so the standard
    feasibility validation applies to the combined loads.  The solution's
    cost covers pinned and new bins alike (the full fleet's hourly cost).
    """
    n = len(problem.items)
    ghosts = tuple(
        Item(f"__pinned{j}", (Choice("pinned", tuple(ob.load)),))
        for j, ob in enumerate(pinned)
    )
    aug = Problem(
        bin_types=problem.bin_types,
        items=problem.items + ghosts,
        utilization_cap=problem.utilization_cap,
    )
    all_placements = [(n + j, 0, j) for j in range(len(pinned))] + list(placements)
    opened = [ob.bin_type for ob in pinned] + list(opened_new)
    return build_solution(aug, all_placements, opened)


def migration_subproblem(
    problem: Problem, free_indices: Sequence[int]
) -> Problem:
    """The migration sub-solve's entry: a sub-`Problem` over ``free_indices``.

    Unlike the controller's churn path (where displaced items sit at the
    fleet's tail), a consolidation move frees items at *arbitrary*
    positions.  The sub-problem's tensors are sliced from the full
    problem's cached build via `ProblemTensors.drop_items` — no re-stack —
    so a ≤k-stream migration solve (`solve(sub, pinned=...)`) costs O(k)
    tensor work regardless of fleet size.
    """
    idx = list(free_indices)
    sub = Problem(
        bin_types=problem.bin_types,
        items=tuple(problem.items[i] for i in idx),
        utilization_cap=problem.utilization_cap,
    )
    if idx:
        object.__setattr__(sub, "_tensors", problem.tensors().drop_items(idx))
    return sub


def solve(
    problem: Problem,
    max_nodes: int = 2_000_000,
    *,
    incumbent: Solution | None = None,
    pinned: Sequence[OpenBin] | None = None,
) -> tuple[Solution, SolveStats]:
    """Exact (within `max_nodes`) minimum-cost MC-VBP solve.

    See the module docstring for the warm-start (`incumbent`) and
    pinned-bin (`pinned`) semantics.  With `pinned`, costs — including the
    returned solution's and any `incumbent`'s — are total fleet costs
    (pinned bins included), so comparisons are apples-to-apples.
    """
    t = problem.tensors()
    bad = np.where(~np.isfinite(t.cheapest_host))[0]
    if bad.size:
        item = problem.items[int(bad[0])]
        raise InfeasibleError(
            f"item {item.name}: no (choice, bin type) fits even when alone"
        )

    stats = SolveStats()
    nd = _non_dominated_bins(problem)
    n = len(problem.items)
    dim = problem.dim
    pinned = tuple(pinned or ())
    n_pinned = len(pinned)
    # Validate pinned loads up front (before any incumbent construction
    # touches them): a pinned bin must respect its effective capacity.
    pinned_resid: list[np.ndarray] = []
    for j, ob in enumerate(pinned):
        resid = problem.effective_capacity(ob.bin_type) - np.asarray(
            ob.load, dtype=np.float64
        )
        if np.any(resid < -1e-6):
            raise ValueError(
                f"pinned bin {j} ({ob.bin_type.name}) overflows its "
                f"effective capacity"
            )
        pinned_resid.append(np.maximum(resid, 0.0))

    # FFD order (decreasing tightness; dominated types never give the min
    # fraction, so the full-catalog key is identical).
    order = np.argsort(-t.min_frac(_EPS), kind="stable")

    # --- hoisted constants ------------------------------------------------
    # Requirements re-indexed into search order: row d is item order[d].
    req_o = np.ascontiguousarray(t.req[order])  # (n, C, dim), +inf padded
    req_o_l = req_o.tolist()  # python floats for the O(dim) bookkeeping
    req_sum_o_l = t.req_sum[order].tolist()  # (n, C)
    cheapest_o = t.cheapest_host[order]  # (n,)
    # Suffix sums of per-item min requirements: density-bound demand for the
    # items still unplaced at depth d is one O(dim) row read.  The suffix
    # max of the cheapest hosting cost bounds the forced-new-bin term from
    # above, letting most nodes skip its broadcast entirely.
    suffix = np.zeros((n + 1, dim))
    if n:
        suffix[:n] = np.cumsum(t.min_req[order][::-1], axis=0)[::-1]
    suffix_l = suffix.tolist()
    suffix_max_cheapest = [0.0] * (n + 1)
    for d in range(n - 1, -1, -1):
        suffix_max_cheapest[d] = max(
            suffix_max_cheapest[d + 1], float(cheapest_o[d])
        )
    cheapest_l = cheapest_o.tolist()
    # Depths visited in decreasing cheapest-host order: the forced-new-bin
    # scan walks this and stops at the first non-fitting item (it yields the
    # max) or once no remaining item can beat the density bound.
    by_cheapest = sorted(range(n), key=lambda d: -cheapest_l[d])
    # Valid (flat choice offsets) per depth for scalar fit tests.
    choice_idx_l = [
        [c for c in range(t.req.shape[1]) if t.choice_mask[order[d], c]]
        for d in range(n)
    ]

    # Best capacity-per-dollar per dim (a node-invariant, shared via
    # ProblemTensors; dominated types never set the per-dim max).
    best_density = t.best_density.tolist()

    # New-bin branching order: cheapest non-dominated types first (stable).
    nd_sorted = sorted(nd, key=lambda i: float(t.costs[i]))
    new_caps_eps = [t.caps[i] + _EPS for i in nd_sorted]
    new_caps_eps_l = [(t.caps[i] + _EPS).tolist() for i in nd_sorted]
    new_caps_l = [t.caps[i].tolist() for i in nd_sorted]
    new_costs = [float(t.costs[i]) for i in nd_sorted]
    new_cap_sums = [float(t.cap_sums[i]) for i in nd_sorted]
    new_types = [problem.bin_types[i] for i in nd_sorted]
    # New-bin moves per depth, precomputed: the (type, fitting choices)
    # pairs are node-invariant, so no per-node fit test is needed there.
    fits_new_o = t.fits_alone[order][:, :, nd_sorted]  # (n, C, n_nd)
    new_moves = [
        [
            (type_i, np.nonzero(fits_new_o[d, :, type_i])[0].tolist())
            for type_i in range(len(nd_sorted))
            if fits_new_o[d, :, type_i].any()
        ]
        for d in range(n)
    ]

    # Incumbent pool: FFD/BFD pack the free items into fresh bins (with
    # pinned bins this ignores their residual space but stays feasible and
    # keeps the guarantee "never worse than the heuristics"), plus the
    # caller's warm start.  The cheapest seeds the upper bound and is
    # returned as-is when the search finds nothing strictly better.
    incumbent_sol = min(
        (first_fit_decreasing(problem), best_fit_decreasing(problem)),
        key=lambda s: s.cost,
    )
    if n_pinned:
        incumbent_sol = pinned_solution(
            problem,
            pinned,
            [
                (a.item_index, a.choice_index, a.bin_index + n_pinned)
                for a in incumbent_sol.assignments
            ],
            [b.bin_type for b in incumbent_sol.bins],
        )
    if incumbent is not None and incumbent.cost < incumbent_sol.cost - _EPS:
        incumbent_sol = incumbent
    best_cost = incumbent_sol.cost
    best_raw: tuple[list[tuple[int, int, int]], list[BinType]] | None = None

    # --- mutable search state --------------------------------------------
    cap_bins = 8
    while cap_bins < n_pinned + 4:
        cap_bins *= 2
    # Open-bin residuals, stored pre-shifted by +_EPS so every fit test is a
    # bare comparison (matches `req <= resid + eps` bit for bit).
    resid_eps = np.zeros((cap_bins, dim))
    resid_l: list[list[float]] = [[0.0] * dim for _ in range(cap_bins)]
    bin_tot = [0.0] * cap_bins  # per-bin residual totals (move sort key)
    n_open = 0
    resid_sum = [0.0] * dim  # running sum of all open residuals
    opened: list[BinType] = []
    placements: list[tuple[int, int, int]] = []
    cost = 0.0
    # Pinned bins enter the search pre-opened: residual = effective
    # capacity minus the existing load, cost counted as a constant.  They
    # behave exactly like bins the search opened itself, except no branch
    # ever closes them (they sit below the n_open floor).
    for j, ob in enumerate(pinned):
        resid = pinned_resid[j]
        resid_eps[j] = resid + _EPS
        resid_l[j] = resid.tolist()
        bin_tot[j] = float(resid.sum())
        for d in range(dim):
            resid_sum[d] += float(resid[d])
        opened.append(ob.bin_type)
        cost += ob.bin_type.cost
    n_open = n_pinned
    order_l = order.tolist()
    # Hot counters kept as locals; folded back into `stats` after the search.
    node_count = 0
    pruned_count = 0
    aborted = False

    def lower_bound(depth: int) -> float:
        """Admissible completion bound; O(dim) density part first, the
        broadcasted forced-new-bin part only when it could actually prune."""
        row = suffix_l[depth]
        lb = 0.0
        for d in range(dim):
            extra = row[d] - resid_sum[d]
            if extra > _EPS:
                bd = best_density[d]
                if 0.0 < bd < _INF:
                    v = extra / bd
                    if v > lb:
                        lb = v
        if cost + lb >= best_cost - _EPS:
            return lb
        # Forced-new-bin: any remaining item fitting no open residual forces
        # at least its cheapest hosting bin.  The suffix max of cheapest
        # hosting costs caps this term, so skip the broadcast when the
        # density part already dominates it or even the upper envelope
        # cannot prune — either way the decision is unchanged.
        smc = suffix_max_cheapest[depth]
        if lb >= smc or cost + smc < best_cost - _EPS:
            return lb
        if not n_open:
            return smc if smc > lb else lb
        if n - depth > 32:
            # Large fleets: one broadcast beats the scalar scan.
            fits = (
                (req_o[depth:, :, None, :] <= resid_eps[None, None, :n_open, :])
                .all(3)
                .reshape(n - depth, -1)
                .any(1)
            )
            forced = cheapest_o[depth:][~fits]
            if forced.size:
                v = float(forced.max())
                if v > lb:
                    lb = v
            return lb
        for d in by_cheapest:
            if d < depth:
                continue
            ch = cheapest_l[d]
            if ch <= lb:
                break
            reqs = req_o_l[d]
            fits = False
            for c in choice_idx_l[d]:
                rc = reqs[c]
                for b in range(n_open):
                    rb = resid_l[b]
                    for dd in range(dim):
                        if rc[dd] > rb[dd]:
                            break
                    else:
                        fits = True
                        break
                if fits:
                    break
            if not fits:
                return ch  # max over non-fitting: first in desc order
        return lb

    def recurse(depth: int) -> None:
        nonlocal cost, best_cost, best_raw, n_open, resid_eps, resid_l, bin_tot, cap_bins
        nonlocal node_count, pruned_count, aborted
        node_count += 1
        if node_count > max_nodes:
            aborted = True
            return
        if depth == n:
            if cost < best_cost - _EPS:
                best_cost = cost
                best_raw = (list(placements), list(opened))
                stats.incumbent_updates += 1
            return
        if cost + lower_bound(depth) >= best_cost - _EPS:
            pruned_count += 1
            return

        item_i = order_l[depth]
        item_reqs = req_o[depth]  # (C, dim)
        item_reqs_l = req_o_l[depth]
        item_sums = req_sum_o_l[depth]

        # Moves into open bins, deduplicated by (residual signature, choice).
        if n_open:
            fit = (item_reqs[None, :, :] <= resid_eps[:n_open, None, :]).all(2)
            flat = fit.ravel().nonzero()[0]  # bin-major, choice-minor order
            if flat.size:
                n_c = fit.shape[1]
                sig_buf = resid_eps[:n_open].round(9).tobytes()
                row_bytes = dim * 8
                seen: set[tuple[bytes, int]] = set()
                moves: list[tuple[float, int, int]] = []
                for pos in flat.tolist():
                    bin_i, choice_i = divmod(pos, n_c)
                    key = (
                        sig_buf[bin_i * row_bytes : (bin_i + 1) * row_bytes],
                        choice_i,
                    )
                    if key in seen:
                        continue
                    seen.add(key)
                    # Prefer tight placements (small residual after).
                    moves.append(
                        (bin_tot[bin_i] - item_sums[choice_i], choice_i, bin_i)
                    )
                moves.sort()
                for _, choice_i, bin_i in moves:
                    req = item_reqs[choice_i]
                    req_l = item_reqs_l[choice_i]
                    resid_eps[bin_i] -= req
                    bin_tot[bin_i] -= item_sums[choice_i]
                    rl = resid_l[bin_i]
                    for d in range(dim):
                        resid_sum[d] -= req_l[d]
                        rl[d] -= req_l[d]
                    placements.append((item_i, choice_i, bin_i))
                    recurse(depth + 1)
                    placements.pop()
                    for d in range(dim):
                        resid_sum[d] += req_l[d]
                        rl[d] += req_l[d]
                    bin_tot[bin_i] += item_sums[choice_i]
                    resid_eps[bin_i] += req
                    if aborted:
                        return

        # Moves opening a new bin (cheapest types first; fit lists are
        # precomputed per depth).
        for type_i, choices in new_moves[depth]:
            bt_cost = new_costs[type_i]
            if cost + bt_cost >= best_cost - _EPS:
                continue
            cap_eps = new_caps_eps[type_i]
            cap_eps_l = new_caps_eps_l[type_i]
            cap_l = new_caps_l[type_i]
            for choice_i in choices:
                req = item_reqs[choice_i]
                req_l = item_reqs_l[choice_i]
                if n_open == cap_bins:
                    cap_bins *= 2
                    resid_eps = np.vstack([resid_eps, np.zeros_like(resid_eps)])
                    resid_l = resid_l + [[0.0] * dim for _ in range(cap_bins // 2)]
                    bin_tot = bin_tot + [0.0] * len(bin_tot)
                bin_i = n_open
                resid_eps[bin_i] = cap_eps - req
                resid_l[bin_i] = [
                    cap_eps_l[d] - req_l[d] for d in range(dim)
                ]
                bin_tot[bin_i] = new_cap_sums[type_i] - item_sums[choice_i]
                for d in range(dim):
                    resid_sum[d] += cap_l[d] - req_l[d]
                opened.append(new_types[type_i])
                placements.append((item_i, choice_i, bin_i))
                n_open += 1
                cost += bt_cost
                recurse(depth + 1)
                cost -= bt_cost
                n_open -= 1
                placements.pop()
                opened.pop()
                for d in range(dim):
                    resid_sum[d] -= cap_l[d] - req_l[d]
                if aborted:
                    return

    recurse(0)
    stats.nodes = node_count
    stats.pruned = pruned_count
    stats.optimal = not aborted

    if best_raw is None:
        # The seed incumbent was already optimal (or node budget hit).
        return incumbent_sol, stats
    raw_placements, raw_opened = best_raw
    if n_pinned:
        sol = pinned_solution(problem, pinned, raw_placements, raw_opened[n_pinned:])
    else:
        sol = build_solution(problem, raw_placements, raw_opened)
    return sol, stats
