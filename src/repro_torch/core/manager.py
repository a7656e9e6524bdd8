"""The cloud resource manager (the paper's contribution, end to end).

Pipeline (paper Fig. 2):

    streams + profile table + instance catalog
        → per-stream multiple-choice requirement vectors (linear FPS model)
        → multiple-choice vector bin packing problem
        → exact solve (bin-completion B&B; arc-flow cross-check available)
        → AllocationPlan: which instances to rent, which streams on which
          instance, and whether each stream runs on the CPU or accelerator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

import torch

from ..device import resolve_device
from .binpack import bincompletion, heuristics
from .binpack.problem import BinType, InfeasibleError, Item, Problem, Solution
from .profiler import ProfileTable
from .strategies import ALL_STRATEGIES, ST3, Strategy
from .streams import StreamSpec

__all__ = ["AllocationPlan", "PlacedStream", "ResourceManager"]

#: Entry points of the reference manager that later slices port, with the
#: ROADMAP.md queue A item that ports each.
_NOT_PORTED = {
    "sharded_controller": "the sharded controller is not ported yet "
    "(ROADMAP.md queue A item 3, core/shard.py)",
}


@dataclasses.dataclass(frozen=True)
class PlacedStream:
    stream: StreamSpec
    instance_index: int
    instance_type: str
    device: str  # "cpu" | "accel" — which unit analyzes the stream


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """The manager's output: paper §3.2 'This output precisely represents
    the resource allocation decisions.'"""

    strategy: str
    instances: tuple[str, ...]  # instance type name per opened instance
    placements: tuple[PlacedStream, ...]
    hourly_cost: float
    optimal: bool
    solution: Solution

    def instance_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for t in self.instances:
            counts[t] = counts.get(t, 0) + 1
        return counts

    def summary(self) -> str:
        lines = [
            f"strategy={self.strategy} hourly_cost=${self.hourly_cost:.3f} "
            f"optimal={self.optimal}",
        ]
        for i, t in enumerate(self.instances):
            members = [
                f"{p.stream.name}({p.device}@{p.stream.desired_fps}fps)"
                for p in self.placements
                if p.instance_index == i
            ]
            lines.append(f"  [{i}] {t}: " + ", ".join(members))
        return "\n".join(lines)


class ResourceManager:
    """Estimates requirements, formulates MC-VBP, solves, and plans.

    Requirements come from a profile table or from a calibration artifact
    (``calibration=``, `set_calibration`; `core.calibration`).  ``device``
    is where the device work runs — branch-and-price's pricing DP and the
    live controllers' what-if scan and placement scores: the card by
    default (raises when there is none), the CPU only when asked for.

    `allocate` plans through the live re-planning controller
    (`controller`), which `replan` then folds churn events into.  The
    reference's `sharded_controller` is not ported yet and raises
    ``NotImplementedError``.
    """

    def __init__(
        self,
        catalog: Sequence[BinType],
        profiles: "ProfileTable | None" = None,
        *,
        calibration: "object | None" = None,
        utilization_cap: float = 0.9,
        solver: str = "auto",  # auto | bincompletion | arcflow | colgen | heuristic
        max_nodes: int = 2_000_000,
        colgen_pool: "object | None" = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        self.catalog = tuple(catalog)
        if calibration is not None:
            # Calibrated source (core.calibration.CalibrationArtifact):
            # requirement vectors come from the artifact's measured/derived
            # profiles; the artifact must have been taken against this
            # catalog's shape (signature-checked, StaleCalibrationError).
            if profiles is not None:
                raise ValueError("pass either profiles or calibration=, not both")
            calibration.verify(self.catalog)
            profiles = calibration.profile_table()
        elif profiles is None:
            raise ValueError("ResourceManager needs profiles or calibration=")
        self.device = resolve_device(device)
        self.calibration = calibration
        self.profiles = profiles
        self.utilization_cap = utilization_cap
        self.solver = solver
        self.max_nodes = max_nodes
        # Branch-and-price column pool: catalog-keyed, so one pool can be
        # shared by every solve over the same bin types (and reused across
        # fleet churn — see `binpack.colgen.ColumnPool`).  Callers
        # (controllers) may inject their own to share columns.
        self.colgen_pool = colgen_pool
        # formulate() memo: repeated allocations of the same fleet (solver
        # cross-checks, simulator re-plans, benchmark timing loops) reuse
        # one Problem instance and therefore one ProblemTensors build.
        self._formulate_cache: dict[tuple, Problem] = {}
        # Live re-planning controllers, one per strategy name (lazy).
        self._controllers: dict[str, object] = {}

    def formulate(
        self, streams: Sequence[StreamSpec], strategy: Strategy = ST3
    ) -> Problem:
        key = (tuple(streams), strategy.name)
        cached = self._formulate_cache.get(key)
        if cached is not None:
            return cached
        bins = strategy.filter_bins(self.catalog)
        if not bins:
            raise InfeasibleError(f"{strategy.name}: no instance types remain")
        allowed = strategy.filter_choice_labels()
        items: list[Item] = []
        for s in streams:
            item = self.profiles.choices_for(s)
            if allowed is not None:
                choices = tuple(c for c in item.choices if c.label in allowed)
                if not choices:
                    raise InfeasibleError(
                        f"stream {s.name}: no {allowed} execution can reach "
                        f"{s.desired_fps} FPS"
                    )
                item = Item(name=item.name, choices=choices)
            items.append(item)
        problem = Problem(
            bin_types=bins, items=tuple(items), utilization_cap=self.utilization_cap
        )
        # Evict oldest-first (dict insertion order): wholesale clearing
        # thrashed workloads alternating between >64 fleets, rebuilding
        # every tensor cache each cycle.
        while len(self._formulate_cache) >= 64:
            self._formulate_cache.pop(next(iter(self._formulate_cache)))
        self._formulate_cache[key] = problem
        return problem

    def set_calibration(self, artifact) -> None:
        """Swap in a (re)calibrated artifact: fresh vectors.

        Verifies the artifact against this manager's catalog, replaces the
        profile table, and invalidates the formulate memo so every
        subsequent solve re-derives its requirement vectors.  Live
        controllers keep their fleet state; call their ``recalibrate()`` to
        re-solve the standing fleet under the new vectors.
        """
        artifact.verify(self.catalog)
        self.calibration = artifact
        self.profiles = artifact.profile_table()
        self._formulate_cache.clear()

    def controller(self, strategy: Strategy = ST3, **kwargs):
        """The live re-planning controller for `strategy` (one per name).

        `allocate` delegates through it, so after any allocation the
        controller holds the fleet and `replan` can fold churn events in
        incrementally (see `core.controller.FleetController`).  ``policy``
        selects the re-planning policy layer (consolidation, dual-price
        aging, autoscaling — see `core.policy`); ``billing`` installs an
        instance-lifecycle billing model (`core.lifecycle.BillingModel`:
        boot latency + billing quantum) the controller's ledger bills the
        fleet through.  Reconfiguring a live controller swaps either
        without dropping its fleet state (a swapped billing model seeds a
        fresh ledger from the live instances)."""
        ctrl = self._controllers.get(strategy.name)
        if ctrl is None:
            from .controller import FleetController

            ctrl = FleetController(self, strategy, **kwargs)
            self._controllers[strategy.name] = ctrl
        else:
            # Reconfigure in place — replacing would silently drop the
            # live fleet state a prior allocate() established.  Billing
            # swaps (global model and/or per-type map) go through
            # set_billing together so the fresh ledger sees both.
            if "billing" in kwargs or "billing_by_type" in kwargs:
                ctrl.set_billing(
                    kwargs.pop("billing", ctrl.billing),
                    by_type=kwargs.pop("billing_by_type", None),
                )
            for key, value in kwargs.items():
                if key in (
                    "gap_threshold",
                    "sub_max_nodes",
                    "policy",
                    "drain_on_notice",
                ):
                    setattr(ctrl, key, value)
                else:
                    raise TypeError(f"unknown controller option {key!r}")
        return ctrl

    def sharded_controller(self, strategy: Strategy = ST3, **kwargs):
        """The hierarchical sharded controller (not ported yet)."""
        raise NotImplementedError(_NOT_PORTED["sharded_controller"])

    def allocate(
        self, streams: Sequence[StreamSpec], strategy: Strategy = ST3
    ) -> AllocationPlan:
        """Formulate and solve one fleet under one strategy, through the
        strategy's live controller (`controller`), which then holds it."""
        return self.controller(strategy).reset(streams).plan

    def replan(self, events, strategy: Strategy = ST3, **controller_kwargs):
        """Apply fleet events to the last allocated fleet, incrementally.

        ``events`` is a `streams.TimedTrace` or a plain event sequence
        (untimed events replay at the controller's current clock).
        Returns the `ReplanResult` list (one per event); requires a prior
        `allocate` (or `controller().reset`) under the same strategy.
        Extra keyword arguments (``policy=``, ``billing=``, ...) reconfigure
        the live controller before the replay, as `controller` does.
        """
        return self.controller(strategy, **controller_kwargs).apply_events(
            list(events)
        )

    def allocate_sweep(
        self,
        streams: Sequence[StreamSpec],
        strategies: Sequence[Strategy] = ALL_STRATEGIES,
        *,
        parallel: int | bool = False,
    ) -> dict[str, AllocationPlan | None]:
        """Allocate under several strategies, building `ProblemTensors` once.

        The full (all-bins, all-choices) problem's tensor cache is built a
        single time; each restricted strategy (ST1: CPU bins/choices, ST2:
        accelerator bins/choices, ...) gets its tensors sliced from it via
        `ProblemTensors.restrict` instead of re-deriving from the object
        model.  Infeasible strategies map to None (paper Table 6 "Fail").

        With ``parallel`` (True, or a worker count) the per-strategy
        solves fan out across a thread pool: formulation and tensor
        derivation stay serial (they touch the shared memo caches), then
        the independent `_plan` calls — the expensive part — run
        concurrently on the already-cached tensors.  Results are identical
        to the serial sweep; the solves share no mutable state."""
        full = self.formulate(streams, ST3)
        full_t = full.tensors()
        plans: dict[str, AllocationPlan | None] = {}
        solvable: list[tuple[Strategy, Problem]] = []
        for strat in strategies:
            try:
                problem = self.formulate(streams, strat)
            except InfeasibleError:
                plans[strat.name] = None
                continue
            if "_tensors" not in problem.__dict__ and problem is not full:
                derived = self._restricted_tensors(full, full_t, problem, strat)
                if derived is not None:
                    object.__setattr__(problem, "_tensors", derived)
            problem.tensors()  # materialize outside the worker threads
            solvable.append((strat, problem))

        def run(strat: Strategy, problem: Problem) -> AllocationPlan | None:
            try:
                return self._plan(streams, problem, strat)
            except InfeasibleError:
                return None

        if parallel and len(solvable) > 1:
            import concurrent.futures

            workers = len(solvable) if parallel is True else int(parallel)
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, min(workers, len(solvable)))
            ) as pool:
                futures = [
                    pool.submit(run, strat, problem)
                    for strat, problem in solvable
                ]
                for (strat, _), fut in zip(solvable, futures):
                    plans[strat.name] = fut.result()
        else:
            for strat, problem in solvable:
                plans[strat.name] = run(strat, problem)
        # Preserve the caller's strategy order (infeasible ones were
        # recorded before the solvable batch).
        return {strat.name: plans[strat.name] for strat in strategies}

    @staticmethod
    def _restricted_tensors(full, full_t, problem, strategy):
        """Slice the full problem's tensors down to a strategy's problem."""
        bin_pos = {id(bt): i for i, bt in enumerate(full.bin_types)}
        try:
            bin_indices = [bin_pos[id(bt)] for bt in problem.bin_types]
        except KeyError:
            return None
        allowed = strategy.filter_choice_labels()
        keep = [
            (
                list(range(len(item.choices)))
                if allowed is None
                else [
                    k for k, c in enumerate(item.choices) if c.label in allowed
                ]
            )
            for item in full.items
        ]
        max_c = max((len(k) for k in keep), default=1)
        n = len(full.items)
        choice_indices = np.zeros((n, max_c), dtype=np.intp)
        choice_mask = np.zeros((n, max_c), dtype=bool)
        for i, ks in enumerate(keep):
            choice_indices[i, : len(ks)] = ks
            choice_mask[i, : len(ks)] = True
        return full_t.restrict(bin_indices, choice_indices, choice_mask)

    def _plan(
        self,
        streams: Sequence[StreamSpec],
        problem: Problem,
        strategy: Strategy,
    ) -> AllocationPlan:
        solution, optimal = self._solve(problem)
        placements = tuple(
            PlacedStream(
                stream=streams[a.item_index],
                instance_index=a.bin_index,
                instance_type=solution.bins[a.bin_index].bin_type.name,
                device=problem.items[a.item_index].choices[a.choice_index].label,
            )
            for a in solution.assignments
        )
        return AllocationPlan(
            strategy=strategy.name,
            instances=tuple(b.bin_type.name for b in solution.bins),
            placements=placements,
            hourly_cost=solution.cost,
            optimal=optimal,
            solution=solution,
        )

    def _solve(
        self, problem: Problem, incumbent: Solution | None = None
    ) -> tuple[Solution, bool]:
        """Solver selection. "auto" mirrors VPSolver's strength: when the
        fleet groups into few identical-stream classes (the common camera
        case) the arc-flow pattern DP is exact and orders of magnitude
        faster than the placement B&B; when the demand lattice is too big
        for the exact DP but the class structure still holds (hundreds of
        cameras over a handful of stream kinds), the budgeted arc-flow's
        LP-rounding incumbent beats the budgeted B&B by a wide margin, so
        it is preferred there too.  Many-class high-multiplicity fleets —
        where arc-flow's pattern *enumeration* itself explodes — route to
        branch-and-price (`binpack.colgen`), which generates only the
        columns the covering LP asks for.  Otherwise fall back to
        bin-completion, keeping whichever incumbent is cheaper.

        `incumbent` is an optional warm start (a feasible Solution of
        `problem`, e.g. a repaired previous plan): bin-completion seeds
        its upper bound with it, and the arc-flow paths return whichever
        of (their solution, the incumbent) is cheaper."""
        from .binpack import arcflow

        def merged(sol: Solution, optimal: bool) -> tuple[Solution, bool]:
            if incumbent is not None and incumbent.cost < sol.cost - 1e-9:
                return incumbent, False
            return sol, optimal

        if self.solver == "heuristic":
            return merged(heuristics.first_fit_decreasing(problem), False)
        if self.solver == "arcflow":
            sol, st = arcflow.solve_arcflow(problem)
            return merged(sol, st.optimal)
        if self.solver == "colgen":
            sol, st = self._solve_colgen(problem, incumbent)
            return merged(sol, st.optimal)
        if self.solver == "bincompletion":
            sol, st = bincompletion.solve(
                problem, max_nodes=self.max_nodes, incumbent=incumbent
            )
            return sol, st.optimal
        # auto.  math.prod: the demand lattice size is exact under arbitrary
        # precision — np.prod silently wrapped to a negative int64 on large
        # fleets and mis-routed them to arc-flow.
        classes, demands, _ = arcflow.group_items(problem)
        if len(classes) <= 6 and math.prod(d + 1 for d in demands) <= 200_000:
            sol, st = arcflow.solve_arcflow(problem)
            if st.optimal:
                return merged(sol, True)
            # Budgeted arc-flow returned its incumbent: cross-check with the
            # (also budgeted) exact B&B and keep the cheaper plan — or the
            # arc-flow plan with certified optimality if the B&B proves the
            # same cost optimal.
            bc_sol, bc_st = bincompletion.solve(
                problem, max_nodes=self.max_nodes, incumbent=incumbent
            )
            if bc_sol.cost < sol.cost - 1e-9:
                return bc_sol, bc_st.optimal
            if bc_st.optimal and bc_sol.cost <= sol.cost + 1e-9:
                return sol, True
            return merged(sol, False)
        if len(classes) <= 8 and len(problem.items) >= 4 * len(classes):
            # High-multiplicity fleet, lattice too big for the exact DP:
            # budgeted arc-flow (pattern LP + rounding) lands within ~1% of
            # the covering-LP bound where the budgeted B&B strands 15-20%
            # above it.
            sol, st = arcflow.solve_arcflow(
                problem, max_dp_states=min(self.max_nodes, 200_000)
            )
            return merged(sol, st.optimal)
        if len(problem.items) >= 2 * len(classes):
            # Many classes AND high multiplicity: pattern enumeration is
            # hopeless and the placement B&B strands far above the LP, but
            # branch-and-price generates exactly the columns the covering
            # LP wants (certified gap even when pricing is budget-capped).
            sol, st = self._solve_colgen(problem, incumbent)
            return merged(sol, st.optimal)
        sol, st = bincompletion.solve(
            problem, max_nodes=self.max_nodes, incumbent=incumbent
        )
        return sol, st.optimal

    def _solve_colgen(self, problem: Problem, incumbent: Solution | None):
        """Branch-and-price with the manager's shared (lazy) column pool.

        Budgets here are the *live* ones — tighter than `solve_colgen`'s
        defaults, because this sits on the controller re-plan path where a
        warm pool (columns survive churn) does most of the work.  The
        returned gap stays certified either way; offline/bench callers
        wanting the full squeeze call `colgen.solve_colgen` directly.
        """
        from .binpack import colgen

        if self.colgen_pool is None:
            self.colgen_pool = colgen.ColumnPool()
        return colgen.solve_colgen(
            problem,
            pool=self.colgen_pool,
            incumbent=incumbent,
            max_dp_states=min(self.max_nodes, 500_000),
            max_rounds=30,
            exact_budget=25_000,
            device=self.device,
        )
