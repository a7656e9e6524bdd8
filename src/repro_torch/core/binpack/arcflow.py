"""Arc-flow-style exact solver for MC-VBP (Brandao & Pedroso 2016 flavor).

The paper delegates solving to VPSolver, whose core idea is:

1. group identical items (network-camera fleets have MANY identical
   streams: same program, fps, frame size) into classes with demands,
2. build, per bin type, a DAG over capacity levels whose source->sink paths
   are exactly the feasible *packing patterns*, compressed by merging
   equivalent nodes,
3. solve a min-cost integer flow (equivalently: select a multiset of
   patterns covering all demands) with a MILP backend.

Offline we have no MILP backend, so step 3 is an exact branch-and-bound
over the residual-demand lattice.  Relative to the naive memoized DP
(which enumerated every reachable demand vector one pattern application at
a time), the covering search is restructured for high-multiplicity fleets:

* patterns are deduplicated to per-class count vectors (choice splits that
  cover the same classes are interchangeable; only the cheapest
  representative matters) and dominated count vectors are dropped in one
  vectorized pass;
* each node branches only on patterns covering the *lowest* uncovered
  class — a canonical ordering that is exhaustive for covering problems —
  and applies a pattern with its full multiplicity in one jump, so a fleet
  of 100 identical streams steps through 1 state, not 100;
* nodes are pruned by an admissible bound (per-dim cost-density relaxation
  + per-class ceil(demand / max-pattern-count) coverage bound) against a
  greedy pattern-cover incumbent, with best-cost dominance memoization on
  visited demand states.

Pattern enumeration itself checks maximality with one vectorized fit test
over all (class, choice) rows instead of a Python loop per class.

`bincompletion.solve` remains the default production solver; this module
cross-checks it (tests assert equal optimal costs) and is preferred when
fleets collapse to few classes with high multiplicity.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import sys
from typing import Sequence

import numpy as np

from .problem import (
    BinType,
    InfeasibleError,
    Problem,
    Solution,
    build_solution,
)

__all__ = [
    "solve_arcflow",
    "ArcflowStats",
    "group_items",
    "enumerate_patterns",
    "class_key",
    "item_class_keys",
    "covering_search",
    "dual_prices",
]

_EPS = 1e-9

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class ArcflowStats:
    n_classes: int = 0
    n_patterns: int = 0
    dp_states: int = 0
    optimal: bool = True
    lp_bound: float = 0.0  # root covering-LP value: optimum is >= this
    # Solver work counters (colgen fills the last two; enumeration-based
    # paths fill the first): how many raw patterns the enumerator visited,
    # how many columns pricing added to the master, and how many
    # LP-price-add rounds the column generation ran.
    patterns_enumerated: int = 0
    columns_generated: int = 0
    pricing_rounds: int = 0


def group_items(problem: Problem) -> tuple[list[np.ndarray], list[int], list[list[int]]]:
    """Group items with identical choice matrices.

    Returns (class requirement matrices, class demands, item indices per
    class), classes in first-occurrence order.  Uses the padded requirement
    tensor so the whole fleet is grouped by one `np.unique` call.
    """
    t = problem.tensors()
    n = len(problem.items)
    if n == 0:
        return [], [], []
    keys = t.req.round(9)
    keys = np.where(np.isfinite(keys), keys, np.inf).reshape(n, -1)
    _, first, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    # Re-rank classes by first occurrence (np.unique sorts lexicographically).
    rank = np.argsort(np.argsort(first, kind="stable"), kind="stable")
    class_of = rank[inverse]
    n_classes = int(first.size)
    classes: list[np.ndarray] = [None] * n_classes  # type: ignore[list-item]
    demands = [0] * n_classes
    members: list[list[int]] = [[] for _ in range(n_classes)]
    reqs = problem.choice_matrix()
    for i, c in enumerate(class_of.tolist()):
        if demands[c] == 0:
            classes[c] = reqs[i].round(9)
        demands[c] += 1
        members[c].append(i)
    return classes, demands, members


def class_key(choice_matrix: np.ndarray) -> bytes:
    """Canonical byte key of one item class's (n_choices, dim) requirements.

    Independent of fleet-level choice-axis padding, so the same stream kind
    maps to the same key across different fleets (used by the controller to
    price classes under churn)."""
    return np.ascontiguousarray(
        np.asarray(choice_matrix, dtype=np.float64).round(9)
    ).tobytes()


def item_class_keys(problem: Problem) -> list[bytes]:
    """Per-item class keys (see `class_key`), one `tensors()` read."""
    t = problem.tensors()
    n_choices = t.n_choices.tolist()
    return [
        class_key(t.req[i, : n_choices[i]]) for i in range(len(problem.items))
    ]


def dual_prices(
    problem: Problem, max_patterns: int = 200_000
) -> tuple[dict[bytes, float], float]:
    """Covering-LP dual prices per item class, reusable across fleet churn.

    Returns ``(prices, lp_value)`` where ``prices[class_key] = y_c >= 0``
    and ``lp_value = Σ demand_c · y_c`` is a certified lower bound on the
    optimum for *this* problem.  Crucially the patterns are enumerated to
    *capacity* maximality (per-class counts capped by what physically fits
    in the largest bin, not by this fleet's demands), so dual feasibility
    — ``pattern · y <= pattern cost`` for every feasible packing — is a
    property of the catalog alone.  The prices therefore remain admissible
    for ANY fleet over the same bin types and utilization cap: price
    unseen classes at 0 and ``Σ demand'_c · y_c`` lower-bounds that
    fleet's optimum.  This is what lets a live controller certify re-plan
    gaps without re-solving an LP per event.
    """
    class_reqs, demands, _members = group_items(problem)
    n_classes = len(class_reqs)
    if n_classes == 0:
        return {}, 0.0
    caps = np.asarray(
        [problem.effective_capacity(bt) for bt in problem.bin_types]
    )
    # Physical per-class count ceiling: any packing of n copies (choices
    # freely mixed) satisfies n·min_choice_req[d] <= cap[d] per dimension,
    # so n <= min over binding dims of cap_d / min_req_d.  (Per-choice
    # "fits alone" counts would NOT be valid here: choices stressing
    # disjoint dimensions can mix to beat every single-choice count.)
    # Replaces the fleet's demand as the enumeration cap so patterns are
    # capacity-maximal.
    enum_demands = []
    unbounded = []
    for r in class_reqs:
        r_min = np.asarray(r, dtype=np.float64).min(axis=0)  # (dim,)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_bin = np.where(
                r_min[None, :] > _EPS,
                np.floor(caps / np.maximum(r_min[None, :], 1e-300) + _EPS),
                np.inf,
            ).min(axis=-1)  # (n_bins,)
        best = float(per_bin.max()) if per_bin.size else 0.0
        unbounded.append(not np.isfinite(best) or best > 4096.0)
        enum_demands.append(int(min(max(best, 1.0), 4096.0)))
    pat_counts, pat_costs, _reps, truncated, _n_enum = _pattern_columns(
        problem, class_reqs, enum_demands, max_patterns
    )
    if truncated or not pat_counts:
        # A truncated enumeration breaks the admissibility argument (the
        # LP would only be dual-feasible for the patterns it saw): no
        # certificate is honest here, so price everything at zero and let
        # callers fall back to the density bound.
        return {class_key(r): 0.0 for r in class_reqs}, 0.0
    pat_mat = np.asarray(pat_counts, dtype=np.float64)
    pat_cost_arr = np.asarray(pat_costs, dtype=np.float64)
    demands_f = np.asarray(demands, dtype=np.float64)
    dual_y, _primal = _covering_lp(pat_mat, pat_cost_arr, demands_f)
    # A class whose per-bin count had to be clamped could, in principle,
    # pack denser than any enumerated pattern — its price is only safe at 0.
    dual_y = np.where(unbounded, 0.0, dual_y)
    prices = {
        class_key(r): float(y) for r, y in zip(class_reqs, dual_y.tolist())
    }
    return prices, float(demands_f @ dual_y)


def enumerate_patterns(
    cap: np.ndarray,
    class_reqs: Sequence[np.ndarray],
    demands: Sequence[int],
    max_patterns: int = 200_000,
) -> list[tuple[tuple[int, int], ...]]:
    """All *maximal* feasible patterns for one bin.

    A pattern is a tuple of ((class, choice) -> count) entries; maximality:
    no further demanded item of any class/choice fits in the residual.
    Classes are visited in canonical order (the arc-flow level ordering);
    within a class, choice counts are enumerated jointly.  The maximality
    test fits every (class, choice) row against the residual in one
    broadcast.
    """
    n_classes = len(class_reqs)
    dim = int(cap.shape[0])
    patterns: list[tuple[tuple[int, int], ...]] = []
    counts: dict[tuple[int, int], int] = {}
    if n_classes == 0:
        return patterns

    # Flattened (class, choice) requirement rows for the maximality test.
    all_reqs = np.concatenate([np.asarray(r, dtype=np.float64) for r in class_reqs])
    row_class = np.concatenate(
        [np.full(len(r), c, dtype=np.intp) for c, r in enumerate(class_reqs)]
    )
    demands_arr = np.asarray(demands, dtype=np.int64)
    class_reqs_l = [np.asarray(r, dtype=np.float64).tolist() for r in class_reqs]

    used_per_class = [0] * n_classes

    def is_maximal(resid: list[float]) -> bool:
        open_classes = np.asarray(used_per_class) < demands_arr
        if not open_classes.any():
            return True
        fits = (all_reqs <= np.asarray(resid)[None, :] + _EPS).all(axis=1)
        return not bool((fits & open_classes[row_class]).any())

    def rec(class_i: int, resid: list[float]) -> None:
        if len(patterns) >= max_patterns:
            return
        if class_i == n_classes:
            if counts and is_maximal(resid):
                patterns.append(tuple(sorted(counts.items())))
            return
        n_choices = len(class_reqs_l[class_i])

        def rec_choice(choice_i: int, resid: list[float]) -> None:
            if choice_i == n_choices:
                rec(class_i + 1, resid)
                return
            req = class_reqs_l[class_i][choice_i]
            # count = 0 branch
            rec_choice(choice_i + 1, resid)
            # count >= 1 branches
            k = 0
            r = resid
            while used_per_class[class_i] < demands[class_i] and all(
                req[d] <= r[d] + _EPS for d in range(dim)
            ):
                k += 1
                r = [r[d] - req[d] for d in range(dim)]
                used_per_class[class_i] += 1
                counts[(class_i, choice_i)] = k
                rec_choice(choice_i + 1, r)
            if k:
                used_per_class[class_i] -= k
                del counts[(class_i, choice_i)]

        rec_choice(0, resid)

    rec(0, np.asarray(cap, dtype=np.float64).tolist())
    return patterns


def _pattern_columns(
    problem: Problem,
    class_reqs: Sequence[np.ndarray],
    demands: Sequence[int],
    max_patterns: int = 200_000,
) -> tuple[list[list[int]], list[float], list[tuple[float, BinType, tuple]]]:
    """Deduplicated, domination-pruned pattern columns over all bin types.

    Patterns are reduced to per-class count vectors (choice splits covering
    the same classes are interchangeable for the covering search; only the
    cheapest representative matters), then dominated count vectors —
    another column covering >= per class at <= cost with something strict —
    are dropped in one chunked broadcast.  Returns (pat_counts, pat_costs,
    pat_reps, truncated, n_enumerated); the first three empty when nothing
    packs.
    """
    n_classes = len(class_reqs)
    by_counts: dict[tuple[int, ...], tuple[float, BinType, tuple]] = {}
    truncated = False
    n_enumerated = 0
    for bt in problem.bin_types:
        cap = problem.effective_capacity(bt)
        pats = enumerate_patterns(cap, class_reqs, demands, max_patterns)
        n_enumerated += len(pats)
        # enumerate_patterns stops at its budget; record AND log it so
        # callers needing the FULL maximal-pattern set (dual_prices'
        # admissibility argument) can degrade instead of over-certifying,
        # and the drop is visible rather than silent.
        if len(pats) >= max_patterns:
            truncated = True
            _log.warning(
                "pattern enumeration for bin type %r hit the cap "
                "(max_patterns=%d, %d classes): further maximal patterns "
                "were discarded and the result is no longer certifiable",
                bt.name, max_patterns, n_classes,
            )
        for pat in pats:
            vec = [0] * n_classes
            for (class_i, _choice_i), cnt in pat:
                vec[class_i] += cnt
            key = tuple(vec)
            old = by_counts.get(key)
            if old is None or bt.cost < old[0] - _EPS:
                by_counts[key] = (bt.cost, bt, pat)
    if not by_counts:
        return [], [], [], truncated, n_enumerated

    count_mat = np.asarray(list(by_counts.keys()), dtype=np.int64)
    cost_arr = np.asarray([v[0] for v in by_counts.values()], dtype=np.float64)
    # Skipped for very large pattern sets where the quadratic pass would
    # cost more than it saves (reduced-cost column fixing prunes those).
    n_pat = count_mat.shape[0]
    keep_mask = np.ones(n_pat, dtype=bool)
    if n_pat <= 6000:
        chunk = max(1, min(n_pat, 4_000_000 // max(1, n_pat)))
        for lo in range(0, n_pat, chunk):
            hi = min(n_pat, lo + chunk)
            geq = (count_mat[None, :, :] >= count_mat[lo:hi, None, :]).all(-1)
            cheaper = cost_arr[None, :] <= cost_arr[lo:hi, None] + _EPS
            strict = (count_mat[None, :, :] > count_mat[lo:hi, None, :]).any(-1) | (
                cost_arr[None, :] < cost_arr[lo:hi, None] - _EPS
            )
            dominated = (geq & cheaper & strict).any(axis=1)
            keep_mask[lo:hi] &= ~dominated
    kept = np.where(keep_mask)[0]
    reps = list(by_counts.values())
    pat_counts = [count_mat[i].tolist() for i in kept.tolist()]
    pat_costs = [float(cost_arr[i]) for i in kept.tolist()]
    pat_reps = [reps[i] for i in kept.tolist()]
    return pat_counts, pat_costs, pat_reps, truncated, n_enumerated


def _covering_lp(
    pat_mat: np.ndarray, pat_cost: np.ndarray, demand: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Duals and primal of min{c·x : Σ x_p·pattern_p >= d, x >= 0}.

    Revised simplex with Big-M artificials and Bland's rule; the basis is
    only (n_classes x n_classes), so iterations are trivial.  Whatever the
    exit path, the returned y is projected to dual feasibility
    (pattern·y <= cost for every pattern, y >= 0), so `d'·y` is an
    admissible completion bound for any residual demand d'.  The primal x
    (per-pattern fractional multiplicities) seeds the rounding incumbent.
    """
    n_pat, k = pat_mat.shape
    if k == 0:
        return np.zeros(0), np.zeros(n_pat)
    big_m = (float(demand.sum()) + 1.0) * (float(pat_cost.max()) + 1.0)
    # Columns: patterns | surplus (-I, cost 0) | artificials (+I, cost M).
    cols = np.concatenate([pat_mat.T, -np.eye(k), np.eye(k)], axis=1)
    costs = np.concatenate([pat_cost, np.zeros(k), np.full(k, big_m)])
    basis = list(range(n_pat + k, n_pat + 2 * k))
    x_b = demand.astype(np.float64).copy()
    y = np.zeros(k)
    for _ in range(2000):
        b_mat = cols[:, basis]
        try:
            y = np.linalg.solve(b_mat.T, costs[basis])
        except np.linalg.LinAlgError:
            break
        reduced = costs - y @ cols
        entering_candidates = np.where(reduced < -1e-9)[0]
        if entering_candidates.size == 0:
            break
        j = int(entering_candidates[0])  # Bland's rule: smallest index
        try:
            u = np.linalg.solve(b_mat, cols[:, j])
        except np.linalg.LinAlgError:
            break
        pos = np.where(u > 1e-10)[0]
        if pos.size == 0:
            break  # unbounded direction (cannot happen for feasible duals)
        ratios = x_b[pos] / u[pos]
        r_min = ratios.min()
        # Bland tie-break: leaving variable with the smallest basis index.
        leave_pos = min(
            (int(basis[int(i)]), int(i)) for i in pos[ratios <= r_min + 1e-12]
        )[1]
        step = x_b[leave_pos] / u[leave_pos]
        x_b = x_b - step * u
        x_b[leave_pos] = step
        basis[leave_pos] = j
    # Project to dual feasibility regardless of how the loop exited.
    y = np.maximum(y, 0.0)
    used = y @ pat_mat.T  # (P,)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale_all = np.where(
            used > 1e-12, np.maximum(pat_cost, 0.0) / used, np.inf
        )
    scale = float(min(1.0, scale_all.min())) if scale_all.size else 1.0
    if not np.isfinite(scale) or scale < 0:
        scale = 0.0
    x_primal = np.zeros(n_pat)
    for b_i, x_v in zip(basis, x_b):
        if b_i < n_pat and x_v > 1e-12:
            x_primal[b_i] = x_v
    return y * scale, x_primal


def solve_arcflow(
    problem: Problem,
    max_dp_states: int = 2_000_000,
    max_patterns: int = 200_000,
) -> tuple[Solution, ArcflowStats]:
    t = problem.tensors()
    bad = np.where(~np.isfinite(t.cheapest_host))[0]
    if bad.size:
        item = problem.items[int(bad[0])]
        raise InfeasibleError(
            f"item {item.name}: no (choice, bin type) fits even when alone"
        )
    stats = ArcflowStats()
    class_reqs, demands, members = group_items(problem)
    stats.n_classes = len(class_reqs)
    n_classes = len(class_reqs)
    if n_classes == 0:
        return build_solution(problem, [], []), stats

    # --- pattern generation, deduplicated to per-class count vectors ------
    # Truncation is survivable here (the DP still searches the enumerated
    # patterns and the LP duals only prune within that set) but the result
    # can no longer be certified optimal — better patterns may exist.
    pat_counts, pat_costs, pat_reps, truncated, n_enum = _pattern_columns(
        problem, class_reqs, demands, max_patterns
    )
    if not pat_counts:
        raise InfeasibleError("no feasible packing exists")
    stats.n_patterns = len(pat_counts)
    stats.patterns_enumerated = n_enum
    if truncated:
        stats.optimal = False

    pat_mat = np.asarray(pat_counts, dtype=np.float64)  # (P, K)
    pat_cost_arr = np.asarray(pat_costs, dtype=np.float64)
    if not all((pat_mat[:, c] > 0).any() for c in range(n_classes)):
        raise InfeasibleError("no feasible packing exists")

    # Dual prices for the pattern-covering LP: any y >= 0 with
    # pattern.y <= pattern_cost for every pattern makes demand.y an
    # admissible bound for EVERY state at once.  The root LP's optimal
    # duals (computed by a tiny revised simplex -- the LP only has
    # n_classes rows) give the near-tight cutting-stock bound that keeps
    # huge demand lattices from being enumerated.
    demands_f = np.asarray(demands, dtype=np.float64)
    dual_y, lp_primal = _covering_lp(pat_mat, pat_cost_arr, demands_f)
    stats.lp_bound = float(demands_f @ dual_y)
    sol = covering_search(
        problem, class_reqs, demands, members,
        pat_counts, pat_costs, pat_reps,
        dual_y, lp_primal, max_dp_states, stats,
    )
    return sol, stats


def covering_search(
    problem: Problem,
    class_reqs: Sequence[np.ndarray],
    demands: Sequence[int],
    members: Sequence[Sequence[int]],
    pat_counts: list[list[int]],
    pat_costs: list[float],
    pat_reps: list[tuple[float, BinType, tuple]],
    dual_y: np.ndarray,
    lp_primal: np.ndarray,
    max_dp_states: int,
    stats: ArcflowStats,
    ub_hint: Solution | None = None,
) -> Solution:
    """Exact covering search over a given column set.

    The back half of the arc-flow solve, shared with column generation
    (`colgen` hands it the generated column pool instead of the full
    enumeration): LP-rounding incumbent, reduced-cost column fixing
    against the incumbent, then the memoized best-bound demand-lattice
    DP.  ``dual_y`` must be admissible (``pattern·y <= cost`` for every
    demand-capped feasible pattern — integer-solution-admissible is
    enough); the result is then optimal *over the given columns*, or the
    anytime incumbent with ``stats.optimal = False`` when the
    ``max_dp_states`` budget is hit.  ``stats.dp_states`` is updated;
    ``stats.optimal`` is only ever downgraded.
    """
    t = problem.tensors()
    n_classes = len(class_reqs)
    pat_mat = np.asarray(pat_counts, dtype=np.float64)  # (P, K)
    pat_cost_arr = np.asarray(pat_costs, dtype=np.float64)
    demands_f = np.asarray(demands, dtype=np.float64)
    lp_value = float(demands_f @ dual_y)

    # Greedy cover from an arbitrary start demand: completes the rounding
    # incumbent and serves as the anytime fallback.
    def greedy_cover(start: np.ndarray) -> tuple[float, list[int]]:
        demand = start.copy()
        order: list[int] = []
        total = 0.0
        while demand.any():
            c0 = int(np.argmax(demand > 0))
            covered = np.minimum(pat_mat, demand[None, :]).sum(axis=1)
            eff = np.where(
                (pat_mat[:, c0] > 0) & (covered > 0),
                pat_cost_arr / np.maximum(covered, 1e-300),
                np.inf,
            )
            p = int(eff.argmin())
            order.append(p)
            total += float(pat_cost_arr[p])
            demand = np.maximum(demand - pat_mat[p], 0.0)
        return total, order

    # Incumbent: the better of plain greedy and LP-floor + greedy on the
    # residual.  The rounding incumbent typically lands within a fraction
    # of one bin of the LP bound, which is what gives the reduced-cost
    # fixing below its bite.
    greedy_cost, greedy_order = greedy_cover(demands_f)
    floored = np.floor(lp_primal + 1e-9)
    resid = np.maximum(demands_f - pat_mat.T @ floored, 0.0)
    resid_cost, resid_order = greedy_cover(resid)
    floor_order = [
        p for p in np.where(floored > 0)[0].tolist() for _ in range(int(floored[p]))
    ]
    floor_cost = float(pat_cost_arr @ floored) + resid_cost
    if floor_cost < greedy_cost - _EPS:
        ub_order = floor_order + resid_order
    else:
        ub_order = greedy_order
    ub_reps = [(pat_reps[p][1], pat_reps[p][2]) for p in ub_order]

    def materialize(reps_seq) -> Solution:
        """Open one bin per (bin type, pattern) and assign concrete items
        with free disposal (counts capped at remaining demand)."""
        remaining = {c: list(members[c]) for c in range(n_classes)}
        demand = list(demands)
        opened: list[BinType] = []
        placements: list[tuple[int, int, int]] = []
        for bt, pat in reps_seq:
            if not any(demand):
                break
            opened.append(bt)
            bin_i = len(opened) - 1
            used_bin = False
            for (class_i, choice_i), cnt in pat:
                take = min(cnt, demand[class_i])
                for _ in range(take):
                    item_i = remaining[class_i].pop()
                    placements.append((item_i, choice_i, bin_i))
                demand[class_i] -= take
                if take:
                    used_bin = True
            if not used_bin:
                opened.pop()
        assert not any(demand), "pattern sequence did not cover all demand"
        return build_solution(problem, placements, opened)

    ub_sol = materialize(ub_reps)
    ub_cost = ub_sol.cost  # realized cost (unused rounded bins are dropped)
    # An externally supplied incumbent (e.g. colgen's dive) tightens both
    # the reduced-cost fixing below and the final comparison.
    if ub_hint is not None and ub_hint.cost < ub_cost - _EPS:
        ub_sol, ub_cost = ub_hint, ub_hint.cost
    if ub_cost <= lp_value + 1e-9:
        return ub_sol  # incumbent meets the LP bound: optimal

    # Reduced-cost column fixing: a pattern whose LP reduced cost pushes the
    # bound to or past the incumbent cannot appear in any strictly better
    # solution, so the exact search only needs the surviving columns.
    reduced = np.maximum(pat_cost_arr - pat_mat @ dual_y, 0.0)
    survive = np.where(lp_value + reduced < ub_cost - _EPS)[0].tolist()
    if not survive or not all(
        any(pat_counts[p][c] for p in survive) for c in range(n_classes)
    ):
        # Some class is uncoverable by improving columns: incumbent optimal.
        return ub_sol
    pat_counts = [pat_counts[p] for p in survive]
    pat_costs = [pat_costs[p] for p in survive]
    pat_reps = [pat_reps[p] for p in survive]

    # Patterns covering each class (restricted set), cheapest first.
    covers: list[list[int]] = [[] for _ in range(n_classes)]
    for p, vec in enumerate(pat_counts):
        for c, cnt in enumerate(vec):
            if cnt > 0:
                covers[c].append(p)
    for c in range(n_classes):
        covers[c].sort(key=lambda p: pat_costs[p])

    # --- admissible bounds -------------------------------------------------
    dim = problem.dim
    class_min_req = [np.asarray(r).min(axis=0).tolist() for r in class_reqs]
    best_density = t.best_density.tolist()  # shared via ProblemTensors
    max_count = [max(pat_counts[p][c] for p in covers[c]) for c in range(n_classes)]
    min_cost_cover = [min(pat_costs[p] for p in covers[c]) for c in range(n_classes)]
    dual_l = dual_y.tolist()

    def lower_bound(demand: Sequence[int]) -> float:
        lb = 0.0
        for d in range(dim):
            total = 0.0
            for c in range(n_classes):
                if demand[c]:
                    total += demand[c] * class_min_req[c][d]
            if total > _EPS:
                bd = best_density[d]
                if 0.0 < bd < math.inf:
                    v = total / bd
                    if v > lb:
                        lb = v
        dual = 0.0
        for c in range(n_classes):
            dc = demand[c]
            if dc:
                v = -(-dc // max_count[c]) * min_cost_cover[c]
                if v > lb:
                    lb = v
                dual += dc * dual_l[c]
        return dual if dual > lb else lb

    # --- exact DP over the demand lattice ---------------------------------
    # Memoized best-completion cost per residual-demand vector, as in
    # VPSolver's min-cost flow.  Each state is expanded exactly once and
    # branches only on surviving patterns covering the lowest uncovered
    # class -- a canonical, exhaustive scheme for covering problems with
    # free disposal.  Per state, all children and their admissible bounds
    # come from one batched computation, expanded best-bound-first;
    # children whose bound cannot beat the best child found so far are
    # skipped without expansion, and expansion stops early once the state's
    # own lower bound is attained.  All cuts preserve exact memo values.
    covers_mat = [
        np.asarray([pat_counts[p] for p in covers[c]], dtype=np.int64)
        for c in range(n_classes)
    ]
    covers_cost = [
        np.asarray([pat_costs[p] for p in covers[c]]) for c in range(n_classes)
    ]
    covers_cost_l = [cc.tolist() for cc in covers_cost]
    min_req_mat = np.asarray(class_min_req)  # (K, dim)
    inv_density = np.asarray(
        [1.0 / bd if 0.0 < bd < math.inf else 0.0 for bd in best_density]
    )
    max_count_arr = np.asarray(max_count, dtype=np.int64)
    min_cost_cover_arr = np.asarray(min_cost_cover)

    def child_bounds(children: np.ndarray) -> np.ndarray:
        """Admissible completion bound for each child demand row."""
        dens = ((children @ min_req_mat) * inv_density[None, :]).max(axis=1)
        cover = (
            -(-children // max_count_arr[None, :]) * min_cost_cover_arr[None, :]
        ).max(axis=1)
        return np.maximum(np.maximum(dens, cover), children @ dual_y)

    # Provision recursion depth relative to the CURRENT stack, not zero —
    # solve_arcflow may already be hundreds of frames deep (pytest, manager,
    # hypothesis) and best() recurses up to sum(demands) further.
    depth_now, frame = 0, sys._getframe()
    while frame is not None:
        depth_now += 1
        frame = frame.f_back
    needed_depth = depth_now + sum(demands) + 200
    if sys.getrecursionlimit() < needed_depth:
        sys.setrecursionlimit(needed_depth)

    memo: dict[tuple[int, ...], float] = {}
    chosen: dict[tuple[int, ...], tuple[int, tuple[int, ...]]] = {}
    states = 0

    class _BudgetExceeded(Exception):
        pass

    def best(demand: tuple[int, ...]) -> float:
        nonlocal states
        c0 = -1
        for c in range(n_classes):
            if demand[c]:
                c0 = c
                break
        if c0 < 0:
            return 0.0
        val = memo.get(demand)
        if val is not None:
            return val
        states += 1
        if states > max_dp_states:
            raise _BudgetExceeded
        lb_state = lower_bound(demand)
        children = np.maximum(
            np.asarray(demand, dtype=np.int64)[None, :] - covers_mat[c0], 0
        )
        floor = covers_cost[c0] + child_bounds(children)
        # Best-bound-first: the first child evaluated is almost always the
        # optimal one when the LP bound is tight, so the break below fires
        # after a single expansion for most states; rows are converted
        # lazily since most are never visited.
        expand_order = np.argsort(floor, kind="stable").tolist()
        floor_l = floor.tolist()
        cover_ids = covers[c0]
        costs_l = covers_cost_l[c0]
        best_v = math.inf
        best_p = -1
        best_child: tuple[int, ...] | None = None
        for j in expand_order:
            if floor_l[j] >= best_v - _EPS:
                break  # sorted by bound: nothing later can win either
            child = tuple(children[j].tolist())
            v = costs_l[j] + best(child)
            if v < best_v - _EPS:
                best_v = v
                best_p = cover_ids[j]
                best_child = child
                if best_v <= lb_state + _EPS:
                    break  # matched the admissible bound: provably optimal
        memo[demand] = best_v
        if best_child is not None:
            chosen[demand] = (best_p, best_child)
        return best_v

    try:
        total_cost = best(tuple(demands))
    except _BudgetExceeded:
        # Anytime fallback, mirroring bincompletion's node budget: return
        # the rounding incumbent, flagged non-optimal.
        stats.dp_states = states
        stats.optimal = False
        return ub_sol
    stats.dp_states = states
    if total_cost >= ub_cost - _EPS:
        # Nothing strictly better than the incumbent exists.
        return ub_sol

    # --- reconstruction ----------------------------------------------------
    reps_seq = []
    demand = tuple(demands)
    while any(demand):
        p, child = chosen[demand]
        reps_seq.append((pat_reps[p][1], pat_reps[p][2]))
        demand = child
    sol = materialize(reps_seq)
    assert abs(sol.cost - total_cost) < 1e-6, (sol.cost, total_cost)
    return sol
