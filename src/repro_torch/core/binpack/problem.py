"""Multiple-choice vector bin packing (MC-VBP) problem model.

This is the paper's formulation (Kaseb et al. 2018, section 3.2):

* A *bin type* has an hourly cost and a capacity vector (one entry per
  resource dimension, e.g. [CPU cores, memory GB, GPU cores, GPU GB]).
  Unlimited copies of each bin type may be opened.
* An *item* (a data stream) has one or more *choices*; each choice is a
  requirement vector of the same dimension (e.g. "run on CPU" vs "run on
  GPU k").  Exactly one choice must be selected per item.
* Goal: open bins and assign every item (with one selected choice) so that
  no bin dimension overflows and total bin cost is minimal.

All quantities are floats; solvers treat `capacity * utilization_cap` as
the effective capacity (the paper de-rates to 90%).

`Problem.tensors()` returns a `ProblemTensors` cache — one padded
`(n_items, max_choices, dim)` requirement tensor plus derived per-item /
per-bin-type arrays — computed once per `Problem` and shared by every
solver (bin-completion, FFD/BFD, arc-flow) so the hot allocation path
never re-stacks Python requirement lists.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "BinType",
    "Choice",
    "Item",
    "Problem",
    "ProblemTensors",
    "Assignment",
    "OpenBin",
    "Solution",
    "InfeasibleError",
]


class InfeasibleError(ValueError):
    """Raised when no feasible packing exists (paper Table 6: 'Fail')."""


@dataclasses.dataclass(frozen=True)
class BinType:
    """A cloud instance type: capacity vector + hourly cost.

    ``cost`` is what the solvers *minimize*; for on-demand types it is the
    hourly rent.  Spot/preemptible variants carry an interruption
    ``hazard`` (expected preemptions per instance-hour; 0.0 = never
    preempted, the on-demand contract) and may price ``cost`` at a
    *risk-adjusted effective* rate while ``rent`` keeps the true billed
    $/hr (see `core.policy.risk_adjusted_catalog`) — billing always runs
    on `billed_rent`, so inflating the decision cost never inflates the
    ledger.
    """

    name: str
    capacity: tuple[float, ...]
    cost: float
    hazard: float = 0.0  # preemptions per instance-hour (0 = on-demand)
    rent: float | None = None  # true billed $/hr when cost is risk-adjusted

    def __post_init__(self) -> None:
        if self.cost < 0:
            raise ValueError(f"bin {self.name}: negative cost")
        if any(c < 0 for c in self.capacity):
            raise ValueError(f"bin {self.name}: negative capacity")
        if self.hazard < 0 or self.hazard != self.hazard:
            raise ValueError(f"bin {self.name}: hazard must be >= 0")
        if self.rent is not None and self.rent < 0:
            raise ValueError(f"bin {self.name}: negative rent")

    @property
    def dim(self) -> int:
        return len(self.capacity)

    @property
    def is_spot(self) -> bool:
        return self.hazard > 0.0

    @property
    def billed_rent(self) -> float:
        """The $/hr the cloud actually bills (``cost`` unless risk-adjusted)."""
        return self.cost if self.rent is None else self.rent


@dataclasses.dataclass(frozen=True)
class Choice:
    """One way of executing an item (e.g. 'on the CPU' / 'on GPU #2')."""

    label: str
    requirement: tuple[float, ...]

    def __post_init__(self) -> None:
        if any(r < 0 for r in self.requirement):
            raise ValueError(f"choice {self.label}: negative requirement")

    @property
    def dim(self) -> int:
        return len(self.requirement)


@dataclasses.dataclass(frozen=True)
class Item:
    """A data stream with its multiple-choice requirement vectors."""

    name: str
    choices: tuple[Choice, ...]

    def __post_init__(self) -> None:
        if not self.choices:
            raise ValueError(f"item {self.name}: no choices")


@dataclasses.dataclass(frozen=True)
class Problem:
    bin_types: tuple[BinType, ...]
    items: tuple[Item, ...]
    utilization_cap: float = 0.9  # paper: keep every utilization <= 90%

    def __post_init__(self) -> None:
        dims = {b.dim for b in self.bin_types} | {
            c.dim for it in self.items for c in it.choices
        }
        if len(dims) > 1:
            raise ValueError(f"inconsistent dimensions: {sorted(dims)}")
        if not self.bin_types:
            raise ValueError("no bin types")
        if not 0 < self.utilization_cap <= 1:
            raise ValueError("utilization_cap must be in (0, 1]")

    @property
    def dim(self) -> int:
        return self.bin_types[0].dim

    def effective_capacity(self, bin_type: BinType) -> np.ndarray:
        return np.asarray(bin_type.capacity, dtype=np.float64) * self.utilization_cap

    def choice_matrix(self) -> list[np.ndarray]:
        """Per item: (n_choices, dim) requirement array."""
        return [
            np.asarray([c.requirement for c in it.choices], dtype=np.float64)
            for it in self.items
        ]

    def feasible_somewhere(self, item: Item) -> bool:
        """True if at least one (choice, bin type) pair can host the item alone."""
        for choice in item.choices:
            req = np.asarray(choice.requirement)
            for bt in self.bin_types:
                if np.all(req <= self.effective_capacity(bt) + 1e-9):
                    return True
        return False

    def tensors(self) -> "ProblemTensors":
        """The solver-shared vectorized view, built once and cached.

        The instance is frozen, so the cache is stashed with
        ``object.__setattr__`` — field equality/hashing are unaffected.
        """
        cached = self.__dict__.get("_tensors")
        if cached is None:
            cached = ProblemTensors.build(self)
            object.__setattr__(self, "_tensors", cached)
        return cached


@dataclasses.dataclass(frozen=True)
class ProblemTensors:
    """Precomputed dense representation of a `Problem`, shared by all solvers.

    Padded choice slots hold ``+inf`` requirements so they fail every fit
    test without extra masking; reductions that must ignore padding use
    `choice_mask`.
    """

    req: np.ndarray  # (n_items, max_choices, dim), +inf padded
    choice_mask: np.ndarray  # (n_items, max_choices) bool
    n_choices: np.ndarray  # (n_items,) int
    req_sum: np.ndarray  # (n_items, max_choices) total demand per choice
    min_req: np.ndarray  # (n_items, dim) per-dim min over valid choices
    caps: np.ndarray  # (n_bin_types, dim) effective capacities
    cap_sums: np.ndarray  # (n_bin_types,)
    costs: np.ndarray  # (n_bin_types,)
    frac: np.ndarray  # (n_items, max_choices, n_bin_types) max util fraction
    fits_alone: np.ndarray  # (n_items, max_choices, n_bin_types) bool, abs eps
    cheapest_host: np.ndarray  # (n_items,) min cost hosting the item alone
    best_density: np.ndarray  # (dim,) best capacity-per-dollar over bin types

    @staticmethod
    def build(problem: Problem) -> "ProblemTensors":
        n = len(problem.items)
        dim = problem.dim
        n_bt = len(problem.bin_types)
        max_c = max((len(it.choices) for it in problem.items), default=1)
        req = np.full((n, max_c, dim), np.inf, dtype=np.float64)
        mask = np.zeros((n, max_c), dtype=bool)
        for i, it in enumerate(problem.items):
            for c, ch in enumerate(it.choices):
                req[i, c] = ch.requirement
                mask[i, c] = True
        caps = np.asarray(
            [bt.capacity for bt in problem.bin_types], dtype=np.float64
        ).reshape(n_bt, dim) * problem.utilization_cap
        costs = np.asarray([bt.cost for bt in problem.bin_types], dtype=np.float64)
        if dim and n:
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(
                    caps[None, None, :, :] > 0,
                    req[:, :, None, :] / np.maximum(caps[None, None, :, :], 1e-300),
                    np.where(req[:, :, None, :] > 0, np.inf, 0.0),
                )
            frac = ratio.max(axis=-1)
            min_req = req.min(axis=1)
            with np.errstate(invalid="ignore"):
                fits_alone = np.all(
                    req[:, :, None, :] <= caps[None, None, :, :] + 1e-9, axis=-1
                )
        else:
            frac = np.zeros((n, max_c, n_bt))
            min_req = np.zeros((n, dim))
            fits_alone = np.broadcast_to(mask[:, :, None], (n, max_c, n_bt)).copy()
        host_cost = np.where(fits_alone, costs[None, None, :], np.inf)
        cheapest_host = (
            host_cost.min(axis=(1, 2)) if n else np.zeros(0, dtype=np.float64)
        )
        return ProblemTensors(
            req=req,
            choice_mask=mask,
            n_choices=mask.sum(axis=1),
            req_sum=req.sum(axis=-1) if dim else np.zeros((n, max_c)),
            min_req=min_req,
            caps=caps,
            cap_sums=caps.sum(axis=-1) if dim else np.zeros(n_bt),
            costs=costs,
            frac=frac,
            fits_alone=fits_alone,
            cheapest_host=cheapest_host,
            best_density=ProblemTensors._best_density(caps, costs),
        )

    @staticmethod
    def _best_density(caps: np.ndarray, costs: np.ndarray) -> np.ndarray:
        """(dim,) best capacity-per-dollar per dimension over the catalog:
        the admissible density bound's denominator, shared by the solvers.
        A zero-cost bin type with capacity in a dim makes that dim free
        (+inf).  Dominated bin types never beat the max, so computing over
        the full catalog matches computing over the non-dominated subset."""
        dim = caps.shape[1] if caps.ndim == 2 else 0
        best = np.zeros(dim)
        for t in range(caps.shape[0]):
            cost_t = float(costs[t])
            if cost_t <= 1e-9:
                best = np.where(caps[t] > 0, np.inf, best)
            else:
                best = np.maximum(best, caps[t] / cost_t)
        return best

    def min_frac(self, eps: float) -> np.ndarray:
        """(n_items,) min utilization fraction over (choice, bin type) pairs
        whose fraction is within `1 + eps`; `inf` where nothing fits."""
        ok = np.where(self.frac <= 1.0 + eps, self.frac, np.inf)
        return ok.min(axis=(1, 2)) if ok.size else np.full(ok.shape[0], np.inf)

    def drop_items(self, keep: Sequence[int]) -> "ProblemTensors":
        """Slice the item axis down to `keep` (in the given order).

        The complement of `append_items`: together they let a live
        controller carry one tensor build across fleet-churn events
        (remove departed streams, append joined ones) instead of
        re-deriving the full `(n, C, dim)` stack from the object model.
        Bin-type arrays are shared, per-item arrays are numpy slices.
        """
        idx = np.asarray(list(keep), dtype=np.intp)
        return ProblemTensors(
            req=self.req[idx],
            choice_mask=self.choice_mask[idx],
            n_choices=self.n_choices[idx],
            req_sum=self.req_sum[idx],
            min_req=self.min_req[idx],
            caps=self.caps,
            cap_sums=self.cap_sums,
            costs=self.costs,
            frac=self.frac[idx],
            fits_alone=self.fits_alone[idx],
            cheapest_host=self.cheapest_host[idx],
            best_density=self.best_density,
        )

    def append_items(self, other: "ProblemTensors") -> "ProblemTensors":
        """Concatenate another tensor set's items after this one's.

        Both sides must be built over the same bin types (caps/costs are
        taken from `self` and asserted equal).  Choice axes are padded to
        the wider of the two with the canonical +inf/False padding, so the
        result is semantically identical to a cold `build` of the combined
        problem (solvers never read padded slots).
        """
        assert self.caps.shape == other.caps.shape and np.array_equal(
            self.caps, other.caps
        ), "append_items requires identical bin types"
        assert np.array_equal(self.costs, other.costs), (
            "append_items requires identical bin costs"
        )
        max_c = max(self.req.shape[1], other.req.shape[1])

        def _pad(t: "ProblemTensors"):
            extra = max_c - t.req.shape[1]
            if extra == 0:
                return t.req, t.choice_mask, t.req_sum, t.frac, t.fits_alone
            n, _, dim = t.req.shape
            n_bt = t.frac.shape[2]
            pad3 = np.full((n, extra, dim), np.inf)
            padm = np.zeros((n, extra), dtype=bool)
            pad2 = np.full((n, extra), np.inf)
            padf = np.full((n, extra, n_bt), np.inf)
            padb = np.zeros((n, extra, n_bt), dtype=bool)
            return (
                np.concatenate([t.req, pad3], axis=1),
                np.concatenate([t.choice_mask, padm], axis=1),
                np.concatenate([t.req_sum, pad2], axis=1),
                np.concatenate([t.frac, padf], axis=1),
                np.concatenate([t.fits_alone, padb], axis=1),
            )

        a, b = _pad(self), _pad(other)
        return ProblemTensors(
            req=np.concatenate([a[0], b[0]], axis=0),
            choice_mask=np.concatenate([a[1], b[1]], axis=0),
            n_choices=np.concatenate([self.n_choices, other.n_choices]),
            req_sum=np.concatenate([a[2], b[2]], axis=0),
            min_req=np.concatenate([self.min_req, other.min_req], axis=0),
            caps=self.caps,
            cap_sums=self.cap_sums,
            costs=self.costs,
            frac=np.concatenate([a[3], b[3]], axis=0),
            fits_alone=np.concatenate([a[4], b[4]], axis=0),
            cheapest_host=np.concatenate([self.cheapest_host, other.cheapest_host]),
            best_density=self.best_density,
        )

    def with_costs(self, costs: Sequence[float]) -> "ProblemTensors":
        """Re-price the bin types without rebuilding geometry.

        Capacities (and therefore `frac`/`fits_alone`) are cost-invariant,
        so a live price-change event only needs the three cost-derived
        arrays recomputed — O(n·C·n_bt) instead of a full build.
        """
        new_costs = np.asarray(costs, dtype=np.float64)
        assert new_costs.shape == self.costs.shape
        host_cost = np.where(self.fits_alone, new_costs[None, None, :], np.inf)
        n = self.req.shape[0]
        return dataclasses.replace(
            self,
            costs=new_costs,
            cheapest_host=(
                host_cost.min(axis=(1, 2)) if n else np.zeros(0, dtype=np.float64)
            ),
            best_density=ProblemTensors._best_density(self.caps, new_costs),
        )

    def restrict(
        self,
        bin_indices: Sequence[int],
        choice_indices: np.ndarray,
        choice_mask: np.ndarray,
    ) -> "ProblemTensors":
        """Slice these tensors down to a sub-problem (fewer bin types and/or
        fewer choices per item) without touching the Python object model.

        `choice_indices` is `(n_items, new_max_choices)` of positions into
        this tensor's choice axis, valid where `choice_mask` is True.  Used
        by the manager's strategy sweep: ST1/ST2 are restrictions of the
        full ST3 problem, so their tensors are views of one build.
        """
        bin_idx = list(bin_indices)
        gather = np.where(choice_mask, choice_indices, 0)
        req = np.take_along_axis(self.req, gather[:, :, None], axis=1)
        req = np.where(choice_mask[:, :, None], req, np.inf)
        req_sum = np.where(
            choice_mask, np.take_along_axis(self.req_sum, gather, axis=1), np.inf
        )
        frac = np.take_along_axis(self.frac, gather[:, :, None], axis=1)[
            :, :, bin_idx
        ]
        frac = np.where(choice_mask[:, :, None], frac, np.inf)
        fits_alone = (
            np.take_along_axis(self.fits_alone, gather[:, :, None], axis=1)[
                :, :, bin_idx
            ]
            & choice_mask[:, :, None]
        )
        costs = self.costs[bin_idx]
        host_cost = np.where(fits_alone, costs[None, None, :], np.inf)
        n = req.shape[0]
        return ProblemTensors(
            req=req,
            choice_mask=choice_mask,
            n_choices=choice_mask.sum(axis=1),
            req_sum=req_sum,
            min_req=req.min(axis=1) if req.size else np.zeros((n, self.min_req.shape[1])),
            caps=self.caps[bin_idx],
            cap_sums=self.cap_sums[bin_idx],
            costs=costs,
            frac=frac,
            fits_alone=fits_alone,
            cheapest_host=(
                host_cost.min(axis=(1, 2)) if n else np.zeros(0, dtype=np.float64)
            ),
            best_density=ProblemTensors._best_density(
                self.caps[bin_idx], costs
            ),
        )


@dataclasses.dataclass(frozen=True)
class Assignment:
    """item -> (selected choice index, open-bin index)."""

    item_index: int
    choice_index: int
    bin_index: int


@dataclasses.dataclass(frozen=True)
class OpenBin:
    bin_type: BinType
    load: tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class Solution:
    problem: Problem
    bins: tuple[OpenBin, ...]
    assignments: tuple[Assignment, ...]

    @property
    def cost(self) -> float:
        return sum(b.bin_type.cost for b in self.bins)

    def bin_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for b in self.bins:
            counts[b.bin_type.name] = counts.get(b.bin_type.name, 0) + 1
        return counts

    def validate(self, atol: float = 1e-9) -> None:
        """Assert solution feasibility; raises AssertionError on violation."""
        p = self.problem
        n = len(self.assignments)
        assert n == len(p.items), "not all items assigned"
        if not n:
            for b in self.bins:
                assert np.allclose(b.load, 0.0, atol=1e-6), (
                    f"recorded load mismatch: 0 vs {b.load}"
                )
            return
        # Vectorized feasibility sweep (one np.add.at instead of a python
        # accumulation loop — this runs on every build_solution).
        item_idx = np.empty(n, dtype=np.int64)
        bin_idx = np.empty(n, dtype=np.int64)
        reqs = np.empty((n, p.dim))
        for k, a in enumerate(self.assignments):
            item_idx[k] = a.item_index
            bin_idx[k] = a.bin_index
            reqs[k] = p.items[a.item_index].choices[a.choice_index].requirement
        assert np.array_equal(
            np.sort(item_idx), np.arange(len(p.items))
        ), "item indices wrong"
        loads = np.zeros((len(self.bins), p.dim))
        np.add.at(loads, bin_idx, reqs)
        cap_cache: dict[int, np.ndarray] = {}
        caps = np.empty((len(self.bins), p.dim))
        for i, b in enumerate(self.bins):
            cap = cap_cache.get(id(b.bin_type))
            if cap is None:
                cap = cap_cache[id(b.bin_type)] = np.asarray(
                    p.effective_capacity(b.bin_type)
                )
            caps[i] = cap
        recorded = np.asarray([b.load for b in self.bins])
        if np.all(loads <= caps + atol) and np.allclose(
            loads, recorded, atol=1e-6
        ):
            return
        for i, b in enumerate(self.bins):  # diagnostics for the failure
            assert np.all(loads[i] <= caps[i] + atol), (
                f"bin {b.bin_type.name} overflows: load={loads[i]} cap={caps[i]}"
            )
            assert np.allclose(loads[i], recorded[i], atol=1e-6), (
                f"recorded load mismatch: {loads[i]} vs {b.load}"
            )


def build_solution(
    problem: Problem,
    placements: Sequence[tuple[int, int, int]],
    opened: Sequence[BinType],
) -> Solution:
    """Construct + validate a Solution from raw (item, choice, bin) triples."""
    loads = np.zeros((len(opened), problem.dim))
    if placements:
        reqs = np.asarray(
            [
                problem.items[i].choices[c].requirement
                for i, c, _ in placements
            ]
        )
        bin_is = np.fromiter(
            (b for _, _, b in placements), dtype=np.int64, count=len(placements)
        )
        np.add.at(loads, bin_is, reqs)
    # Drop unused bins, remapping indices (single pass over placements).
    used = {p[2] for p in placements}
    keep = [i for i in range(len(opened)) if i in used]
    remap = {old: new for new, old in enumerate(keep)}
    bins = tuple(
        OpenBin(bin_type=opened[i], load=tuple(loads[i].tolist())) for i in keep
    )
    assignments = tuple(
        Assignment(item_index=i, choice_index=c, bin_index=remap[b])
        for i, c, b in placements
    )
    sol = Solution(problem=problem, bins=bins, assignments=assignments)
    sol.validate()
    return sol
