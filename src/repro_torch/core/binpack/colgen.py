"""Branch-and-price for MC-VBP: column generation with batched DP pricing.

`solve_arcflow` enumerates every capacity-maximal pattern before pricing
them — at n>=200 with 8-10 stream classes the enumeration explodes and the
solver degrades to a budgeted anytime mode.  Column generation turns that
around: only the patterns the covering LP *asks for* are generated.

The loop:

1. seed a column pool from the FFD heuristic's bins,
2. solve the restricted master LP (`arcflow._covering_lp` — the same
   revised simplex the enumeration path uses) for duals ``y``,
3. price: per bin kind, find the pattern maximizing ``y·counts`` under the
   kind's capacity vector — a bounded multi-dimensional knapsack.  All
   kinds (and, during diving, all open branch nodes) are discretized onto
   one integer grid and solved in ONE batched DP dispatch
   (`repro_torch.kernels.knapsack`: the CUDA kernel on the card, its
   plain torch version on the CPU, bit-identical); a
   pattern with ``y·counts > cost`` is an improving column and joins the
   pool,
4. when the (conservatively discretized) DP finds nothing, an exact
   bounded DFS with per-dimension fractional-knapsack bounds confirms
   convergence or supplies the column the grid missed,
5. certify: duals are scaled by the Farley factor ``min_k cost_k / z_k``
   (``z_k`` = the kind's exact pricing optimum when the DFS proved it,
   else the DFS root fractional bound), which makes ``pattern·y <= cost``
   hold for EVERY feasible pattern — so ``demand·y`` is an admissible
   lower bound whether or not pricing fully converged,
6. branch on fractional pattern multiplicities: dive a frontier of
   residual-demand nodes (each child commits one copy of a fractional
   column), pruning with the certified bound; each level prices every
   open node x bin kind in the same single batched dispatch, enriching
   the pool with columns tailored to integer residuals,
7. finish with `arcflow.covering_search` over the pool — the exact
   demand-lattice DP with reduced-cost column fixing shared with the
   enumeration path — and certify the final gap against the scaled-dual
   bound.

The `ColumnPool` stores columns keyed by `arcflow.class_key`, so columns
persist across fleet churn exactly the way dual prices do: a column is a
physical packing of *stream classes* into a bin type, valid for any fleet
over the same catalog (projecting onto the current fleet's classes only
removes items, which keeps the pattern feasible).  `dual_prices` runs the
same loop with capacity-capped (demand-free) pricing bounds, yielding
class prices that stay admissible under ANY fleet churn — the controller
plugs them into the same certification slot as `arcflow.dual_prices`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .arcflow import (
    ArcflowStats,
    _covering_lp,
    class_key,
    covering_search,
    group_items,
)
from ...device import resolve_device
from ...kernels import knapsack as _knap
from .heuristics import first_fit_decreasing
from .problem import BinType, InfeasibleError, Problem, Solution, build_solution

__all__ = [
    "ColumnPool",
    "solve_colgen",
    "dual_prices",
    "batched_dual_prices",
]

_EPS = 1e-9
#: Pricing improvement threshold: a column must beat its bin cost by this.
_PRICE_EPS = 1e-7
#: Per-entry copy clamp for churn-safe (demand-free) pricing; classes whose
#: physical fit bound exceeds it are priced 0, mirroring arcflow.dual_prices.
_FIT_CLAMP = 4096


# --------------------------------------------------------------------------
# column pool
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _PoolColumn:
    """One packing pattern: (class_key, choice index) -> count, in a bin."""

    bt_name: str
    entries: tuple[tuple[bytes, int, int], ...]  # sorted (key, choice, count)


class ColumnPool:
    """Churn-persistent column store keyed by item-class identity.

    Bound to a catalog signature (bin type names, capacities, utilization
    cap); a capacity change clears the pool, a pure *price* change does
    not (column costs are re-read from the live catalog at projection
    time, so repricing the catalog automatically reprices every column).
    Columns survive fleet churn: classes absent from the current fleet
    are projected away, which only removes items from the pattern and
    therefore preserves feasibility.
    """

    def __init__(self, max_columns: int = 20_000):
        self.max_columns = max_columns
        self._sig: tuple | None = None
        self._cols: dict[_PoolColumn, None] = {}  # insertion-ordered set
        self.columns_added = 0  # lifetime counter (stats/debugging)

    def __len__(self) -> int:
        return len(self._cols)

    @staticmethod
    def _catalog_sig(problem: Problem) -> tuple:
        return (
            round(problem.utilization_cap, 9),
            tuple(sorted(
                (bt.name, tuple(round(float(c), 9) for c in bt.capacity))
                for bt in problem.bin_types
            )),
        )

    def ensure(self, problem: Problem) -> None:
        """Bind to the problem's catalog; clear on a capacity change."""
        sig = self._catalog_sig(problem)
        if sig != self._sig:
            self._sig = sig
            self._cols.clear()

    def add(
        self,
        problem: Problem,
        bt: BinType,
        entries: dict[tuple[bytes, int], int],
        class_reqs_by_key: dict[bytes, np.ndarray],
    ) -> bool:
        """Insert one column; returns True when it is new.

        The pattern is re-verified against the bin's effective capacity
        (defensive: DP discretization and DFS pricing both construct
        feasible patterns, but a column pool must never hold an
        infeasible one).
        """
        entries = {k: int(c) for k, c in entries.items() if c > 0}
        if not entries:
            return False
        cap = np.asarray(problem.effective_capacity(bt), dtype=np.float64)
        used = np.zeros_like(cap)
        for (key, choice_i), cnt in entries.items():
            req = np.asarray(class_reqs_by_key[key][choice_i], dtype=np.float64)
            used = used + cnt * req
        if not (used <= cap + 1e-6).all():
            return False
        col = _PoolColumn(
            bt.name,
            tuple(sorted((k, j, c) for (k, j), c in entries.items())),
        )
        if col in self._cols:
            return False
        self._cols[col] = None
        self.columns_added += 1
        if len(self._cols) > self.max_columns:  # FIFO eviction
            oldest = next(iter(self._cols))
            del self._cols[oldest]
        return True

    def project(
        self,
        problem: Problem,
        keys: Sequence[bytes],
        demands: "Sequence[int] | None" = None,
    ) -> tuple[list[list[int]], list[float], list[tuple[float, BinType, tuple]]]:
        """Columns as per-class count vectors over THIS problem's classes.

        Classes not in ``keys`` are dropped from the pattern (free
        disposal keeps it feasible); duplicate count vectors keep the
        cheapest representative, mirroring `arcflow._pattern_columns`.
        ``demands`` additionally clips each count at the class demand —
        also free disposal, and it matters for the master LP: an
        unclipped capacity-capped column (e.g. a `_seed_singletons`
        column holding 6 copies against a demand of 3) covers demand
        at a fictitiously low per-unit cost and relaxes the root LP
        below the demand-capped covering LP the certificate is measured
        against.  The churn pricer (`dual_prices`) projects UNclipped:
        its certificate must stay admissible for fleets with other
        demands.  Returns ``(pat_counts, pat_costs, pat_reps)`` in the
        layout `arcflow.covering_search` consumes.
        """
        key_idx = {k: i for i, k in enumerate(keys)}
        bt_by_name = {bt.name: bt for bt in problem.bin_types}
        n_classes = len(keys)
        best: dict[tuple[int, ...], tuple[float, BinType, tuple]] = {}
        for col in self._cols:
            bt = bt_by_name.get(col.bt_name)
            if bt is None:
                continue
            vec = [0] * n_classes
            patt = []
            for key, choice_i, cnt in col.entries:
                c = key_idx.get(key)
                if c is not None:
                    vec[c] += cnt
                    patt.append(((c, choice_i), cnt))
            if demands is not None:
                vec = [min(v, int(d)) for v, d in zip(vec, demands)]
            if not patt or not any(vec):
                continue
            tup = tuple(vec)
            old = best.get(tup)
            if old is None or bt.cost < old[0] - _EPS:
                best[tup] = (bt.cost, bt, tuple(sorted(patt)))
        pat_counts = [list(k) for k in best]
        pat_costs = [v[0] for v in best.values()]
        pat_reps = list(best.values())
        return pat_counts, pat_costs, pat_reps


# --------------------------------------------------------------------------
# discretization for the batched DP pricer
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _PricingGrid:
    """Per-kind integer pricing knapsacks on one shared state lattice."""

    entries: list[tuple[int, int]]  # (class, choice) per pricing entry
    entry_class: np.ndarray  # (E,) class index per entry
    entry_reqs: np.ndarray  # (E, D) real-valued requirements
    cap_levels: np.ndarray  # (K, D) capacity in grid units
    weights: np.ndarray  # (K, E, D) entry weight in grid units
    fit: np.ndarray  # (K, E) max copies by grid capacity (0 = no fit)


def _discretize(
    problem: Problem,
    class_reqs: Sequence[np.ndarray],
    grid_states: int,
) -> _PricingGrid:
    """Round the pricing knapsacks onto a shared integer grid.

    Per-dimension level counts are allocated from a total state budget in
    proportion to how many distinct fit counts the dimension can resolve
    (``log2`` of the largest per-kind copy count); each kind then uses
    its own unit ``cap_kd / levels_d``, so every kind gets the full grid
    resolution in every dimension.  Weights round UP (``ceil`` with a
    relative nudge), so a DP-feasible pattern is always feasible in real
    capacities — the grid only under-approximates, never cheats; the
    exact DFS pricer covers whatever resolution it loses.
    """
    caps = np.asarray(
        [problem.effective_capacity(bt) for bt in problem.bin_types],
        dtype=np.float64,
    )  # (K, D)
    n_kinds, dim = caps.shape
    entries = [(c, j) for c, r in enumerate(class_reqs) for j in range(len(r))]
    e_n = len(entries)
    reqs = np.zeros((e_n, dim))
    for e, (c, j) in enumerate(entries):
        reqs[e] = np.asarray(class_reqs[c][j], dtype=np.float64)

    # Per-dim resolution need: the largest copy count any kind can tell
    # apart in that dimension (capped — past a few hundred the grid stops
    # paying for itself and the DFS backstop takes over).
    need = np.zeros(dim)
    for d in range(dim):
        pos = reqs[:, d] > _EPS
        if not pos.any():
            continue
        r_min = reqs[pos, d].min()
        for k in range(n_kinds):
            if caps[k, d] > _EPS:
                need[d] = max(need[d], min(caps[k, d] / r_min, 512.0))
    bits = np.log2(need + 1.0)
    budget_bits = math.log2(max(grid_states, 2))
    if bits.sum() > budget_bits:
        bits = bits * (budget_bits / bits.sum())
    levels = np.maximum(np.floor(2.0 ** bits).astype(np.int64) - 1, 0)
    levels[need <= _EPS] = 0  # dimension never binds: collapse it

    cap_levels = np.zeros((n_kinds, dim), dtype=np.int64)
    weights = np.zeros((n_kinds, e_n, dim), dtype=np.int64)
    fit = np.zeros((n_kinds, e_n), dtype=np.int64)
    for k in range(n_kinds):
        feasible = np.ones(e_n, dtype=bool)
        for d in range(dim):
            if caps[k, d] <= _EPS or levels[d] == 0:
                # dimension unusable on the grid: entries demanding it
                # are priced by the exact DFS instead
                feasible &= reqs[:, d] <= _EPS
                continue
            cap_levels[k, d] = levels[d]
            unit = caps[k, d] / float(levels[d])
            w = np.ceil(reqs[:, d] / unit * (1.0 + 1e-12)).astype(np.int64)
            w = np.maximum(w, (reqs[:, d] > _EPS).astype(np.int64))
            weights[k, :, d] = w
            feasible &= w <= levels[d]
        with np.errstate(divide="ignore"):
            per_dim = np.where(
                weights[k] > 0,
                cap_levels[k][None, :] // np.maximum(weights[k], 1),
                np.iinfo(np.int64).max,
            ).min(axis=1)
        fit[k] = np.where(feasible, np.minimum(per_dim, _FIT_CLAMP), 0)
    return _PricingGrid(
        entries=entries,
        entry_class=np.asarray([c for c, _ in entries], dtype=np.int64),
        entry_reqs=reqs,
        cap_levels=cap_levels,
        weights=weights,
        fit=fit,
    )


def _price_dp(
    grid: _PricingGrid,
    duals: np.ndarray,  # (N, C) one dual vector per open node
    resid: np.ndarray | None,  # (N, C) demand caps, or None = capacity-only
    device,
) -> tuple[np.ndarray, np.ndarray]:
    """ONE batched dispatch pricing every (node, kind) knapsack.

    Returns ``(best (N, K), counts (N, K, E))``.  This is the hot path:
    during diving the whole frontier x catalog is a single kernel call.
    """
    n_nodes, _ = duals.shape
    n_kinds, e_n, _ = grid.weights.shape
    values = duals[:, grid.entry_class]  # (N, E)
    values_b = np.repeat(values, n_kinds, axis=0)  # (N*K, E)
    weights_b = np.tile(grid.weights, (n_nodes, 1, 1))
    caps_b = np.tile(grid.cap_levels, (n_nodes, 1))
    bounds = np.tile(grid.fit, (n_nodes, 1))  # (N*K, E)
    if resid is not None:
        dem = resid[:, grid.entry_class]  # (N, E)
        bounds = np.minimum(bounds, np.repeat(dem, n_kinds, axis=0))
    res = _knap.price_knapsacks(values_b, weights_b, bounds, caps_b, device=device)
    best = res.best.reshape(n_nodes, n_kinds)
    counts = res.counts.reshape(n_nodes, n_kinds, e_n)
    return best, counts


# --------------------------------------------------------------------------
# exact DFS pricer (convergence proof / certification backstop)
# --------------------------------------------------------------------------

class _Budget(Exception):
    pass


def _exact_knapsack(
    cap: np.ndarray,  # (D,) real capacity
    reqs: np.ndarray,  # (E, D) real requirements
    vals: np.ndarray,  # (E,) entry values (<= 0 entries are ignored)
    ubs: np.ndarray,  # (E,) finite copy bounds
    node_budget: int = 100_000,
    entry_class: np.ndarray | None = None,  # (E,) class of each entry
    class_caps: np.ndarray | None = None,  # (C,) joint per-class copy caps
    improve_above: float | None = None,  # also harvest patterns above this
    max_extra: int = 8,
) -> tuple[float, np.ndarray, bool, float, list[np.ndarray]]:
    """Exact bounded multi-dim knapsack by DFS with fractional bounds.

    Returns ``(value, counts, proven, root_bound, extras)``.
    ``root_bound`` is an admissible upper bound on the true optimum
    computed from the per-dimension fractional-knapsack relaxation (min
    over dimensions) — it is what Farley scaling falls back to when the
    node budget trips and ``proven`` comes back False.  With
    ``node_budget=0`` this is a pure bound evaluation.  ``class_caps``
    bounds the TOTAL copies across all entries of one class (a class's
    choices share its demand): it is what keeps the demand-capped
    certificate tight rather than counting each choice against the
    demand separately.  When ``improve_above`` is set, up to
    ``max_extra`` distinct patterns scoring above it are harvested from
    the search (multiple pricing: one DFS feeds several columns per
    round, which collapses the colgen tail).
    """
    e_all = vals.shape[0]
    counts_out = np.zeros(e_all, dtype=np.int64)
    cap = np.asarray(cap, dtype=np.float64)
    keep = (
        (vals > _EPS)
        & (ubs > 0)
        & (reqs <= cap[None, :] + _EPS).all(axis=1)
    )
    idx = np.where(keep)[0]
    if idx.size == 0:
        return 0.0, counts_out, True, 0.0, []
    active = np.where(cap > _EPS)[0]
    # Densest-first: value per tightest relative footprint.
    rel = np.zeros((idx.size, cap.size))
    if active.size:
        rel[:, active] = reqs[np.ix_(idx, active)] / cap[active][None, :]
    foot = np.maximum(rel.max(axis=1), 1e-12)
    order = idx[np.argsort(-(vals[idx] / foot), kind="stable")]
    r = reqs[order]
    v = vals[order]
    u = ubs[order].astype(np.int64)
    e_n = order.size
    ec = entry_class[order] if entry_class is not None else None
    class_rem = (
        class_caps.astype(np.int64).copy() if class_caps is not None else None
    )

    def suffix_bound(resid: np.ndarray, start: int) -> float:
        """min over dims of the per-dim fractional knapsack relaxation."""
        if active.size == 0:  # nothing binds: bounds alone cap the value
            return float((v[start:] * u[start:]).sum())
        bound = math.inf
        for d in active:
            total = 0.0
            room = float(resid[d])
            load: list[tuple[float, float, float, int]] = []
            for e in range(start, e_n):
                rd = float(r[e, d])
                if rd <= _EPS:
                    total += float(v[e]) * int(u[e])  # free in this dim
                else:
                    load.append((v[e] / rd, float(v[e]), rd, int(u[e])))
            load.sort(key=lambda t: -t[0])
            for _dens, ve, rd, ue in load:
                if room <= _EPS:
                    break
                take = min(float(ue), room / rd)
                total += ve * take
                room -= take * rd
            if total < bound:
                bound = total
        return bound

    root_bound = suffix_bound(cap, 0)
    best_val = 0.0
    best_cnt = np.zeros(e_n, dtype=np.int64)
    cur = np.zeros(e_n, dtype=np.int64)
    nodes = 0
    proven = True
    found: dict[tuple[int, ...], float] = {}

    def rec(e: int, resid: np.ndarray, acc: float) -> None:
        nonlocal best_val, best_cnt, nodes, proven
        if acc > best_val + _EPS:
            best_val = acc
            best_cnt = cur.copy()
        if improve_above is not None and acc > improve_above:
            key = tuple(cur.tolist())
            if key not in found:
                if len(found) >= max_extra:
                    worst = min(found, key=found.get)  # type: ignore[arg-type]
                    if found[worst] < acc:
                        del found[worst]
                        found[key] = acc
                else:
                    found[key] = acc
        if e >= e_n:
            return
        nodes += 1
        if nodes > node_budget:
            proven = False
            raise _Budget
        if acc + suffix_bound(resid, e) <= best_val + _EPS:
            return  # cannot strictly improve past float tolerance
        pos = r[e] > _EPS
        if pos.any():
            m = int(math.floor((resid[pos] / r[e, pos]).min() + 1e-9))
        else:
            m = int(u[e])
        m = min(m, int(u[e]))
        cls = int(ec[e]) if class_rem is not None else -1
        if class_rem is not None:
            m = min(m, int(class_rem[cls]))
        for k in range(max(m, 0), -1, -1):
            cur[e] = k
            if class_rem is not None:
                class_rem[cls] -= k
            rec(e + 1, resid - k * r[e], acc + k * v[e])
            if class_rem is not None:
                class_rem[cls] += k
        cur[e] = 0

    try:
        rec(0, cap.copy(), 0.0)
    except _Budget:
        pass
    counts_out[order] = best_cnt
    extras = []
    for key in found:
        full = np.zeros(e_all, dtype=np.int64)
        full[order] = np.asarray(key, dtype=np.int64)
        extras.append(full)
    # The DFS prunes at <= best + eps, so "proven" means optimal up to
    # eps; root_bound (>= the true optimum unconditionally) absorbs that
    # slack in the certificate.
    return (
        float(best_val), counts_out, proven,
        float(max(root_bound, best_val)), extras,
    )


# --------------------------------------------------------------------------
# root column generation + certification
# --------------------------------------------------------------------------

def _counts_to_entries(
    counts: np.ndarray, grid: _PricingGrid, keys: Sequence[bytes]
) -> dict[tuple[bytes, int], int]:
    out: dict[tuple[bytes, int], int] = {}
    for e in np.where(counts > 0)[0].tolist():
        c, j = grid.entries[e]
        out[(keys[c], j)] = out.get((keys[c], j), 0) + int(counts[e])
    return out


def _exact_fit_bounds(
    caps: Sequence[np.ndarray], grid: _PricingGrid
) -> np.ndarray:
    """Real-valued per-(kind, entry) copy bounds for the exact pricer."""
    e_n = len(grid.entries)
    fit = np.zeros((len(caps), e_n), dtype=np.int64)
    for k, cap in enumerate(caps):
        for e in range(e_n):
            re_ = grid.entry_reqs[e]
            pos = re_ > _EPS
            if not (re_ <= cap + _EPS).all():
                continue  # does not fit even once
            if not pos.any():
                fit[k, e] = _FIT_CLAMP
            else:
                fit[k, e] = min(
                    int(math.floor((cap[pos] / re_[pos]).min() + 1e-9)),
                    _FIT_CLAMP,
                )
    return fit


@dataclasses.dataclass
class _RootResult:
    dual_y: np.ndarray  # last master duals (pool-admissible, unscaled)
    lp_primal: np.ndarray  # last master fractional multiplicities
    pat_counts: list[list[int]]
    pat_costs: list[float]
    pat_reps: list[tuple[float, BinType, tuple]]
    y_cert: np.ndarray  # Farley-scaled duals: admissible for ALL patterns
    converged: bool  # True when exact pricing PROVED no improving column


def _root_colgen(
    problem: Problem,
    pool: ColumnPool,
    grid: _PricingGrid,
    keys: Sequence[bytes],
    class_reqs_by_key: dict[bytes, np.ndarray],
    lp_demand: np.ndarray,  # (C,) master RHS (real demands; may hold zeros)
    stats: ArcflowStats,
    *,
    demand_cap: np.ndarray | None,  # (C,) pricing copy caps, or None
    zero_price: np.ndarray,  # (C,) bool: classes forced to price 0
    max_rounds: int,
    device,
    exact_budget: int,
) -> _RootResult:
    """LP / price / add until no improving column (or rounds exhausted).

    ``demand_cap`` bounds per-class copies in pricing: with the fleet's
    demands the certificate is integer-solution-admissible (what
    `covering_search` needs); with None pricing is capacity-capped and
    the certificate is admissible for ANY fleet over this catalog.
    """
    costs_k = np.asarray([bt.cost for bt in problem.bin_types])
    caps = [
        np.asarray(problem.effective_capacity(bt), dtype=np.float64)
        for bt in problem.bin_types
    ]
    n_classes = len(keys)
    exact_fit = _exact_fit_bounds(caps, grid)
    if demand_cap is not None:
        exact_fit = np.minimum(
            exact_fit, demand_cap[grid.entry_class][None, :]
        )

    y = np.zeros(n_classes)
    x = np.zeros(0)
    pat_counts: list[list[int]] = []
    pat_costs: list[float] = []
    pat_reps: list = []
    exact_results: list[tuple[float, np.ndarray, bool, float]] | None = None
    converged = False
    for _round in range(max_rounds):
        pat_counts, pat_costs, pat_reps = pool.project(
            problem, keys, demands=demand_cap
        )
        pat_mat = np.asarray(pat_counts, dtype=np.float64).reshape(
            len(pat_counts), n_classes
        )
        y, x = _covering_lp(
            pat_mat, np.asarray(pat_costs, dtype=np.float64), lp_demand
        )
        y = np.where(zero_price, 0.0, y)
        stats.pricing_rounds += 1
        exact_results = None
        added = 0
        resid = None if demand_cap is None else demand_cap[None, :]
        best, counts = _price_dp(grid, y[None, :], resid, device)
        for k, bt in enumerate(problem.bin_types):
            if best[0, k] > costs_k[k] + _PRICE_EPS:
                ent = _counts_to_entries(counts[0, k], grid, keys)
                if pool.add(problem, bt, ent, class_reqs_by_key):
                    added += 1
        if added:
            stats.columns_generated += added
            continue
        # The grid found nothing: ask the exact pricer (also produces the
        # per-kind bounds the Farley certificate needs).  Multiple
        # pricing: every distinct improving pattern the DFS visited joins
        # the pool, not just the argmax — one exact pass per kind feeds
        # many columns, collapsing the convergence tail.
        exact_results = []
        vals = y[grid.entry_class]
        for k, bt in enumerate(problem.bin_types):
            res = _exact_knapsack(
                caps[k], grid.entry_reqs, vals,
                exact_fit[k].astype(np.float64), exact_budget,
                grid.entry_class, demand_cap,
                improve_above=float(costs_k[k]) + _PRICE_EPS,
            )
            exact_results.append(res)
            val, cnt, _proven, _rb, extras = res
            if val > costs_k[k] + _PRICE_EPS:
                for pat in [cnt] + extras:
                    ent = _counts_to_entries(pat, grid, keys)
                    if pool.add(problem, bt, ent, class_reqs_by_key):
                        added += 1
        if added:
            stats.columns_generated += added
            continue
        converged = all(p for _v, _c, p, _b, _x in exact_results)
        break
    if exact_results is None:
        # Rounds exhausted while the DP was still improving: take a pure
        # bound pass (node_budget=0) so the certificate stays honest.
        vals = y[grid.entry_class]
        exact_results = [
            _exact_knapsack(
                caps[k], grid.entry_reqs, vals,
                exact_fit[k].astype(np.float64), 0,
                grid.entry_class, demand_cap,
            )
            for k in range(len(caps))
        ]
        converged = False
    # Pool the per-kind pricing argmaxes even when not strictly
    # improving: the integer optimum's columns typically sit at reduced
    # cost EXACTLY zero at the LP optimum, so they never clear the
    # improvement threshold — yet the final covering search needs them.
    for k, bt in enumerate(problem.bin_types):
        _val, cnt, _proven, _rb, _extras = exact_results[k]
        if cnt.any():
            ent = _counts_to_entries(cnt, grid, keys)
            if pool.add(problem, bt, ent, class_reqs_by_key):
                stats.columns_generated += 1
    # Farley scaling: y/z_k violates no kind's pricing problem, so
    # pattern·y_cert <= cost for EVERY pattern within the pricing caps.
    scale = 1.0
    for k, (val, _cnt, proven, root_bound, _extras) in enumerate(exact_results):
        z = (val + 1e-9) if proven else root_bound
        if z > _EPS and costs_k[k] < z:
            scale = min(scale, max(float(costs_k[k]), 0.0) / z)
    y_cert = y * max(scale, 0.0)
    return _RootResult(y, x, pat_counts, pat_costs, pat_reps, y_cert, converged)


# --------------------------------------------------------------------------
# seeding
# --------------------------------------------------------------------------

def _seed_pool_from_solution(
    problem: Problem,
    pool: ColumnPool,
    sol: Solution,
    item_class: np.ndarray,  # (n_items,) class index per item
    keys: Sequence[bytes],
    class_reqs_by_key: dict[bytes, np.ndarray],
) -> int:
    """Add one column per bin of a feasible solution; returns # added."""
    per_bin: dict[int, dict[tuple[bytes, int], int]] = {}
    for a in sol.assignments:
        ent = per_bin.setdefault(a.bin_index, {})
        k = (keys[int(item_class[a.item_index])], a.choice_index)
        ent[k] = ent.get(k, 0) + 1
    added = 0
    for b_i, ent in per_bin.items():
        bt = sol.bins[b_i].bin_type
        if pool.add(problem, bt, ent, class_reqs_by_key):
            added += 1
    return added


def _seed_singletons(
    problem: Problem,
    pool: ColumnPool,
    class_reqs: Sequence[np.ndarray],
    keys: Sequence[bytes],
    class_reqs_by_key: dict[bytes, np.ndarray],
) -> np.ndarray:
    """One cheapest singleton column per class; returns coverable mask."""
    coverable = np.zeros(len(keys), dtype=bool)
    for c, reqs in enumerate(class_reqs):
        best: tuple[float, BinType, int] | None = None
        for bt in problem.bin_types:
            cap = problem.effective_capacity(bt)
            for j in range(len(reqs)):
                if (np.asarray(reqs[j]) <= cap + _EPS).all():
                    if best is None or bt.cost < best[0] - _EPS:
                        best = (bt.cost, bt, j)
        if best is not None:
            coverable[c] = True
            pool.add(
                problem, best[1], {(keys[c], best[2]): 1}, class_reqs_by_key
            )
    return coverable


def _item_class_map(
    members: Sequence[Sequence[int]], n_items: int
) -> np.ndarray:
    item_class = np.zeros(n_items, dtype=np.int64)
    for c, mem in enumerate(members):
        for i in mem:
            item_class[i] = c
    return item_class


# --------------------------------------------------------------------------
# diving (pool enrichment on integer residuals)
# --------------------------------------------------------------------------

def _materialize(
    problem: Problem,
    members: Sequence[Sequence[int]],
    demands: Sequence[int],
    reps_seq: Sequence[tuple[BinType, tuple]],
) -> Solution | None:
    """Open one bin per (bin type, pattern); assign with free disposal.

    Mirrors `covering_search`'s internal materializer; returns None when
    the sequence does not cover all demand.
    """
    n_classes = len(demands)
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
                placements.append((remaining[class_i].pop(), choice_i, bin_i))
            demand[class_i] -= take
            if take:
                used_bin = True
        if not used_bin:
            opened.pop()
    if any(demand):
        return None
    return build_solution(problem, placements, opened)


def _dive(
    problem: Problem,
    pool: ColumnPool,
    grid: _PricingGrid,
    keys: Sequence[bytes],
    class_reqs_by_key: dict[bytes, np.ndarray],
    demands: Sequence[int],
    root: _RootResult,
    incumbent_cost: float,
    stats: ArcflowStats,
    *,
    device,
    max_levels: int = 60,
    width: int = 2,
    frontier_cap: int = 6,
) -> tuple[float, tuple | None]:
    """Branch on fractional multiplicities: enrich the pool AND complete
    integer solutions.

    Each node holds a residual demand vector, the cost committed so far,
    and the committed (bin type, pattern) sequence.  Per level, every
    node re-solves the restricted master on its residual, the whole
    frontier x catalog is priced in ONE batched DP dispatch (columns
    tailored to integer residuals join the pool), and children commit
    the LP's full integral part plus one copy of a fractional column —
    floor-commit diving, so depth is logarithmic in the bin count rather
    than linear.  Nodes are pruned against the certified root bound
    (``committed + resid·y_cert >= incumbent``).  Returns the best
    completed ``(cost, reps)`` — `solve_colgen` materializes it as the
    covering search's upper-bound hint.
    """
    n_classes = len(keys)
    costs_k = np.asarray([bt.cost for bt in problem.bin_types])
    dem0 = np.asarray(demands, dtype=np.int64)
    # node: (committed cost, residual demand, committed reps tuple)
    frontier: list[tuple[float, np.ndarray, tuple]] = [(0.0, dem0, ())]
    best_complete = incumbent_cost
    best_reps: tuple | None = None
    for _level in range(max_levels):
        live: list[tuple[float, np.ndarray, tuple]] = []
        for committed, resid, reps in frontier:
            if not resid.any():
                if committed < best_complete - 1e-9:
                    best_complete = committed
                    best_reps = reps
                continue
            if committed + float(resid @ root.y_cert) >= best_complete - 1e-9:
                continue
            live.append((committed, resid, reps))
        if not live:
            break
        pat_counts, pat_costs, pat_reps = pool.project(
            problem, keys, demands=demands
        )
        pat_mat = np.asarray(pat_counts, dtype=np.float64).reshape(
            len(pat_counts), n_classes
        )
        pat_vecs = pat_mat.astype(np.int64)
        pat_cost_arr = np.asarray(pat_costs, dtype=np.float64)
        duals = np.zeros((len(live), n_classes))
        primals = []
        for i, (_committed, resid, _reps) in enumerate(live):
            y_n, x_n = _covering_lp(
                pat_mat, pat_cost_arr, resid.astype(np.float64)
            )
            duals[i] = y_n
            primals.append(x_n)
        stats.pricing_rounds += 1
        resid_mat = np.stack([r for _c, r, _rp in live])
        added = 0
        best, counts = _price_dp(grid, duals, resid_mat, device)
        for i in range(len(live)):
            for k, bt in enumerate(problem.bin_types):
                if best[i, k] > costs_k[k] + _PRICE_EPS:
                    ent = _counts_to_entries(counts[i, k], grid, keys)
                    if pool.add(problem, bt, ent, class_reqs_by_key):
                        added += 1
        stats.columns_generated += added
        # Children: commit the LP's integral part wholesale, then one
        # copy of each of the `width` most-fractional columns.
        children: dict[tuple[int, ...], tuple[float, tuple]] = {}

        def offer(resid: np.ndarray, cost: float, reps: tuple) -> None:
            ckey = tuple(resid.tolist())
            old = children.get(ckey)
            if old is None or cost < old[0] - 1e-12:
                children[ckey] = (cost, reps)

        for (committed, resid, reps), x_n in zip(live, primals):
            floor = np.floor(x_n + 1e-9).astype(np.int64)
            base_cost = committed
            base_resid = resid
            base_reps = reps
            whole = np.where(floor > 0)[0]
            for p in whole.tolist():
                cnt = int(floor[p])
                base_cost += cnt * float(pat_cost_arr[p])
                base_resid = np.maximum(base_resid - cnt * pat_vecs[p], 0)
                base_reps = base_reps + (
                    (pat_reps[p][1], pat_reps[p][2]),
                ) * cnt
            frac = x_n - np.floor(x_n + 1e-9)
            cand = np.where(frac > 1e-6)[0]
            if cand.size:
                cand = cand[np.argsort(-frac[cand], kind="stable")][:width]
                for p in cand.tolist():
                    offer(
                        np.maximum(base_resid - pat_vecs[p], 0),
                        base_cost + float(pat_cost_arr[p]),
                        base_reps + ((pat_reps[p][1], pat_reps[p][2]),),
                    )
            if whole.size:
                offer(base_resid, base_cost, base_reps)
        frontier = sorted(
            (
                (cost, np.asarray(ckey, dtype=np.int64), reps)
                for ckey, (cost, reps) in children.items()
            ),
            key=lambda t: t[0] + float(t[1] @ root.y_cert),
        )[:frontier_cap]
        if not frontier:
            break
    return best_complete, best_reps


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def solve_colgen(
    problem: Problem,
    *,
    pool: ColumnPool | None = None,
    incumbent: Solution | None = None,
    max_dp_states: int = 2_000_000,
    max_rounds: int = 200,
    grid_states: int = 32_768,
    exact_budget: int = 100_000,
    dive: bool = True,
    device=None,
) -> tuple[Solution, ArcflowStats]:
    """Branch-and-price MC-VBP solve with a certified optimality gap.

    Drop-in alternative to `arcflow.solve_arcflow` for many-class fleets:
    instead of enumerating every capacity-maximal pattern, columns are
    generated on demand by a batched knapsack-DP pricer (plus an exact
    DFS backstop), the pool is enriched by a fractional-multiplicity
    dive, and the final solution comes from the shared
    `arcflow.covering_search` over the generated pool.

    ``stats.lp_bound`` is ALWAYS an admissible lower bound on the integer
    optimum (Farley-scaled duals), so ``cost / lp_bound - 1`` is a
    certified gap even when pricing did not fully converge.
    ``stats.optimal`` is True only when the final cost meets that bound.
    Pass a ``pool`` kept from a previous solve of any fleet over the same
    catalog to warm-start pricing (columns persist across churn); pass an
    ``incumbent`` solution of THIS problem to seed the upper bound.
    Pricing runs on ``device`` (default: the card; see `resolve_device`).
    """
    device = resolve_device(device)
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

    if pool is None:
        pool = ColumnPool()
    pool.ensure(problem)
    keys = [class_key(r) for r in class_reqs]
    class_reqs_by_key = dict(zip(keys, class_reqs))
    item_class = _item_class_map(members, len(problem.items))

    # Seed: FFD bins (guarantees every class is covered by some column)
    # plus per-class cheapest singletons (LP never degenerates).
    ffd_sol = first_fit_decreasing(problem)
    _seed_pool_from_solution(
        problem, pool, ffd_sol, item_class, keys, class_reqs_by_key
    )
    _seed_singletons(problem, pool, class_reqs, keys, class_reqs_by_key)

    grid = _discretize(problem, class_reqs, grid_states)
    demands_f = np.asarray(demands, dtype=np.float64)
    dem_arr = np.asarray(demands, dtype=np.int64)
    root = _root_colgen(
        problem, pool, grid, keys, class_reqs_by_key, demands_f, stats,
        demand_cap=dem_arr,
        zero_price=np.zeros(n_classes, dtype=bool),
        max_rounds=max_rounds, device=device, exact_budget=exact_budget,
    )
    cert_lb = float(demands_f @ root.y_cert)

    ub = ffd_sol.cost
    if incumbent is not None and incumbent.cost < ub:
        ub = incumbent.cost
    dive_hint: Solution | None = None
    frac = root.lp_primal - np.floor(root.lp_primal + 1e-9)
    if dive and (frac > 1e-6).any() and ub > cert_lb + 1e-9:
        _dive_cost, dive_reps = _dive(
            problem, pool, grid, keys, class_reqs_by_key, demands,
            root, ub, stats, device=device,
        )
        if dive_reps is not None:
            dive_hint = _materialize(problem, members, demands, dive_reps)

    # Final master over the full enriched pool, then the shared exact
    # covering search (its duals are pool-admissible by _covering_lp's
    # exit projection, which is what its internal pruning needs).
    pat_counts, pat_costs, pat_reps = pool.project(
        problem, keys, demands=demands
    )
    stats.n_patterns = len(pat_counts)
    pat_mat = np.asarray(pat_counts, dtype=np.float64).reshape(
        len(pat_counts), n_classes
    )
    dual_y, lp_primal = _covering_lp(
        pat_mat, np.asarray(pat_costs, dtype=np.float64), demands_f
    )
    sol = covering_search(
        problem, class_reqs, demands, members,
        pat_counts, pat_costs, pat_reps,
        dual_y, lp_primal, max_dp_states, stats,
        ub_hint=dive_hint,
    )
    if incumbent is not None and incumbent.cost < sol.cost - _EPS:
        sol = incumbent
    if ffd_sol.cost < sol.cost - _EPS:
        sol = ffd_sol
    stats.lp_bound = cert_lb
    # Global optimality needs the certified bound, not optimality over
    # the pool: a better column outside the pool can always exist unless
    # the cost meets the admissible lower bound.
    stats.optimal = stats.optimal and (
        sol.cost <= cert_lb + max(1e-6, 1e-9 * abs(cert_lb))
    )
    return sol, stats


def dual_prices(
    problem: Problem,
    pool: ColumnPool | None = None,
    *,
    max_rounds: int = 40,
    grid_states: int = 32_768,
    exact_budget: int = 50_000,
    device=None,
) -> tuple[dict[bytes, float], float]:
    """Colgen counterpart of `arcflow.dual_prices`: churn-safe class prices.

    Same contract: returns ``(prices, lp_value)`` with ``pattern·y <=
    cost`` for EVERY capacity-feasible packing over this catalog, so the
    prices stay admissible for ANY fleet over the same bin types (price
    unseen classes at 0).  Unlike the arcflow version — which returns
    all-zeros once pattern enumeration trips its cap — this one scales to
    many classes: pricing is capacity-capped (fleet demands never enter
    the admissibility argument) and the Farley certificate holds even
    when pricing stops early.  Classes whose physical per-bin copy bound
    exceeds ``_FIT_CLAMP`` are priced 0, mirroring arcflow.  Pricing runs
    on ``device`` (default: the card).
    """
    device = resolve_device(device)
    class_reqs, demands, _members = group_items(problem)
    n_classes = len(class_reqs)
    if n_classes == 0:
        return {}, 0.0
    if pool is None:
        pool = ColumnPool()
    pool.ensure(problem)
    keys = [class_key(r) for r in class_reqs]
    class_reqs_by_key = dict(zip(keys, class_reqs))
    stats = ArcflowStats()

    coverable = _seed_singletons(
        problem, pool, class_reqs, keys, class_reqs_by_key
    )
    grid = _discretize(problem, class_reqs, grid_states)
    zero_price = _zero_price_mask(problem, class_reqs, coverable)

    # Master RHS: the live fleet's demands (uncoverable classes enter at
    # 0 so the LP stays bounded); admissibility never depends on them.
    lp_demand = np.asarray(demands, dtype=np.float64)
    lp_demand[~coverable] = 0.0
    root = _root_colgen(
        problem, pool, grid, keys, class_reqs_by_key, lp_demand, stats,
        demand_cap=None,
        zero_price=zero_price,
        max_rounds=max_rounds, device=device, exact_budget=exact_budget,
    )
    demands_f = np.asarray(demands, dtype=np.float64)
    prices = {k: float(y) for k, y in zip(keys, root.y_cert.tolist())}
    return prices, float(demands_f @ root.y_cert)


def _zero_price_mask(
    problem: Problem,
    class_reqs: Sequence[np.ndarray],
    coverable: np.ndarray,
) -> np.ndarray:
    """Classes only 0 is a safe price for.

    A class whose copy count is physically unbounded (or beyond the
    clamp) could pack denser than anything pricing explores: only 0 is
    a safe price for it.  Same r_min rule as arcflow.dual_prices.
    """
    caps = np.asarray(
        [problem.effective_capacity(bt) for bt in problem.bin_types]
    )
    zero_price = ~np.asarray(coverable, dtype=bool)
    for c, reqs in enumerate(class_reqs):
        r_min = np.asarray(reqs, dtype=np.float64).min(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_bin = np.where(
                r_min[None, :] > _EPS,
                np.floor(caps / np.maximum(r_min[None, :], 1e-300) + _EPS),
                np.inf,
            ).min(axis=-1)
        best = float(per_bin.max()) if per_bin.size else 0.0
        if not np.isfinite(best) or best > float(_FIT_CLAMP):
            zero_price[c] = True
    return zero_price


def batched_dual_prices(
    problems: Sequence[Problem],
    pool: ColumnPool | None = None,
    *,
    max_rounds: int = 24,
    grid_states: int = 8_192,
    exact_budget: int = 5_000,
    device=None,
    stats_out: dict | None = None,
) -> list[tuple[dict[bytes, float], float]]:
    """Churn-safe class prices for MANY same-catalog problems at once.

    The sharded controller's one-dispatch certification: every cell
    prices over the SAME catalog, so all cells share one pricing grid,
    one column pool, and — per colgen round — ONE batched
    `price_knapsacks` dispatch covering every (cell, bin kind) knapsack.
    Per-cell restricted-master LPs stay separate (each cell's *demands*
    differ, and `rebalance` arbitrages on per-cell price differences),
    but column generation is fleet-global: a column any cell discovers
    immediately warm-starts every other cell's master.

    Each returned ``(prices, lp_value)`` satisfies `dual_prices`'
    admissibility contract — ``pattern·y <= cost`` for every
    capacity-feasible packing over the catalog — via the same per-cell
    Farley scaling.  When the grid prices a cell out, one budgeted DFS
    per DISTINCT dual vector (cells at the same LP corner share it)
    either supplies the columns the grid's resolution missed or PROVES
    the cell's duals globally optimal — in which case the cell freezes
    with its certificate and drops out of later rounds, so warm pools
    converge in 1-2 rounds and cold pools pay the round count only for
    cells still moving.  A tripped DFS budget keeps the cell active and
    certifies with the fractional root bound at exit.

    Problems over mixed catalogs fall back to serial `dual_prices` per
    problem.  ``stats_out`` (optional dict) accumulates
    ``pricing_dispatches`` / ``pricing_rounds`` counters.  Pricing runs on
    ``device`` (default: the card).
    """
    device = resolve_device(device)
    problems = list(problems)
    if not problems:
        return []
    sig0 = ColumnPool._catalog_sig(problems[0])
    if any(ColumnPool._catalog_sig(p) != sig0 for p in problems[1:]):
        out = []
        for p in problems:
            out.append(
                dual_prices(p, pool, max_rounds=max_rounds, device=device)
            )
            if stats_out is not None:
                stats_out["pricing_dispatches"] = (
                    stats_out.get("pricing_dispatches", 0) + 1
                )
        return out
    if pool is None:
        pool = ColumnPool()
    ref = problems[0]
    pool.ensure(ref)

    # Union the cells' class sets (first-appearance order: stable).
    union_keys: list[bytes] = []
    union_reqs: list[np.ndarray] = []
    class_reqs_by_key: dict[bytes, np.ndarray] = {}
    per_cell: list[tuple[list[bytes], np.ndarray] | None] = []
    for p in problems:
        class_reqs, demands, _members = group_items(p)
        if not len(class_reqs):
            per_cell.append(None)
            continue
        keys = [class_key(r) for r in class_reqs]
        for k, r in zip(keys, class_reqs):
            if k not in class_reqs_by_key:
                class_reqs_by_key[k] = r
                union_keys.append(k)
                union_reqs.append(r)
        per_cell.append((keys, np.asarray(demands, dtype=np.float64)))
    n_classes = len(union_keys)
    if n_classes == 0:
        return [({}, 0.0) for _ in problems]
    key_idx = {k: i for i, k in enumerate(union_keys)}

    coverable = _seed_singletons(
        ref, pool, union_reqs, union_keys, class_reqs_by_key
    )
    grid = _discretize(ref, union_reqs, grid_states)
    zero_price = _zero_price_mask(ref, union_reqs, coverable)

    # Per-cell master RHS over the union classes (absent classes at 0).
    rows = [i for i, pc in enumerate(per_cell) if pc is not None]
    lp_demands = np.zeros((len(rows), n_classes))
    for row, i in enumerate(rows):
        keys, demands = per_cell[i]  # type: ignore[misc]
        for k, d in zip(keys, demands):
            lp_demands[row, key_idx[k]] = d
    lp_demands[:, ~coverable] = 0.0

    costs_k = np.asarray([bt.cost for bt in ref.bin_types])
    caps = [
        np.asarray(ref.effective_capacity(bt), dtype=np.float64)
        for bt in ref.bin_types
    ]
    exact_fit = _exact_fit_bounds(caps, grid)

    n_rows = lp_demands.shape[0]
    Y = np.zeros((n_rows, n_classes))
    # A cell whose DFS PROVES no improving pattern exists for its duals
    # has converged globally: no column any other cell generates later
    # can be violated by (or improve) its y, so it freezes and drops out
    # of subsequent LP solves and pricing dispatches.  Its proven
    # pricing optima double as its Farley certificate (scale ~1).
    active = list(range(n_rows))
    scale_rows = np.ones(n_rows)
    # Budgeted-DFS pricing per DISTINCT dual vector: cells at the same
    # LP corner share one DFS.  value: (improving columns, scale, proven)
    dfs_cache: dict[bytes, tuple[bool, float, bool]] = {}

    def _dfs_price(y: np.ndarray) -> tuple[bool, float, bool]:
        sig = y.tobytes()
        hit = dfs_cache.get(sig)
        if hit is not None:
            return hit
        vals = y[grid.entry_class]
        found = False
        scale = 1.0
        proven_all = True
        for k, bt in enumerate(ref.bin_types):
            val, cnt, proven, rb, extras = _exact_knapsack(
                caps[k], grid.entry_reqs, vals,
                exact_fit[k].astype(np.float64), exact_budget,
                grid.entry_class, None,
                improve_above=float(costs_k[k]) + _PRICE_EPS,
            )
            proven_all &= proven
            if val > costs_k[k] + _PRICE_EPS:
                for pat in [cnt] + extras:
                    ent = _counts_to_entries(pat, grid, union_keys)
                    if pool.add(ref, bt, ent, class_reqs_by_key):
                        found = True
            z = (val + 1e-9) if proven else rb
            if z > _EPS and costs_k[k] < z:
                scale = min(scale, max(float(costs_k[k]), 0.0) / z)
        out = (found, max(scale, 0.0), proven_all)
        dfs_cache[sig] = out
        return out

    for _round in range(max_rounds):
        if not active:
            break
        pat_counts, pat_costs, _reps = pool.project(ref, union_keys)
        if not pat_counts:
            break  # nothing coverable: every price is 0
        pat_mat = np.asarray(pat_counts, dtype=np.float64).reshape(
            len(pat_counts), n_classes
        )
        pat_cost_arr = np.asarray(pat_costs, dtype=np.float64)
        # Cells with identical demand vectors share one LP solve.
        lp_cache: dict[bytes, np.ndarray] = {}
        for row in active:
            dem_sig = lp_demands[row].tobytes()
            y = lp_cache.get(dem_sig)
            if y is None:
                y, _x = _covering_lp(pat_mat, pat_cost_arr, lp_demands[row])
                y = np.where(zero_price, 0.0, y)
                lp_cache[dem_sig] = y
            Y[row] = y
        # ONE dispatch: every active cell x bin kind priced together.
        best, counts = _price_dp(grid, Y[active], None, device)
        dfs_cache.clear()  # the pool changed since last round's DFS runs
        if stats_out is not None:
            stats_out["pricing_dispatches"] = (
                stats_out.get("pricing_dispatches", 0) + 1
            )
            stats_out["pricing_rounds"] = (
                stats_out.get("pricing_rounds", 0) + 1
            )
        still_active: list[int] = []
        for b_row, row in enumerate(active):
            dp_found = False
            for k, bt in enumerate(ref.bin_types):
                if best[b_row, k] > costs_k[k] + _PRICE_EPS:
                    ent = _counts_to_entries(
                        counts[b_row, k], grid, union_keys
                    )
                    pool.add(ref, bt, ent, class_reqs_by_key)
                    dp_found = True
            if dp_found:
                still_active.append(row)
                continue
            # Grid priced out for this cell: budgeted DFS either finds
            # the columns the grid missed (stay active) or proves
            # convergence (freeze with its certificate).
            found, scale, proven = _dfs_price(Y[row])
            if found:
                still_active.append(row)
            elif proven:
                scale_rows[row] = scale
            else:
                still_active.append(row)  # budget tripped: keep trying
        active = still_active

    # Cells still active at exit certify with whatever scale their last
    # duals support (budgeted DFS / fractional root bounds — admissible
    # either way).
    for row in active:
        _found, scale, _proven = _dfs_price(Y[row])
        scale_rows[row] = scale

    results: list[tuple[dict[bytes, float], float]] = []
    row = 0
    for pc in per_cell:
        if pc is None:
            results.append(({}, 0.0))
            continue
        y_cert = Y[row] * scale_rows[row]
        keys, demands = pc
        own = np.asarray([key_idx[k] for k in keys], dtype=np.int64)
        prices = {k: float(y_cert[key_idx[k]]) for k in keys}
        results.append((prices, float(demands @ y_cert[own])))
        row += 1
    return results
