"""Dynamic fleet controller: the re-planning *mechanism* layer.

The paper's manager runs in a *live* loop — cameras join, drop, and change
desired frame rates, and instance prices drift — yet a from-scratch MC-VBP
solve per change wastes almost all of its work: most of the fleet did not
move.  `FleetController` owns a mutable fleet and re-plans incrementally:

1. **Diff** the post-event fleet against the previous `AllocationPlan`.
   Streams on untouched instances stay put; only the event's streams (a
   join, or the re-rated stream) are *displaced*.
2. **Pin** every bin that keeps its members: the previous plan's bins
   enter `bincompletion.solve` pre-opened with their existing loads
   (``pinned=``), so the exact search only decides where the displaced
   streams go — into pinned residual capacity or fresh instances.
3. **Repair** greedily first: every (displaced stream, choice, pinned
   bin) candidate is scored in one pass (`heuristics.placement_scores`:
   the CUDA kernel's fit + slack rule on the card for large candidate
   matrices, the same arithmetic in numpy for small ones),
   and the resulting repaired solution seeds the sub-solve as its
   warm-start incumbent (``incumbent=``).
4. **Certify**: the warm plan's cost is compared against an admissible
   lower bound on the *full* problem — the covering-LP dual prices from
   `arcflow.dual_prices` (capacity-maximal patterns, so the prices stay
   admissible under churn: unseen classes price at 0) maxed with
   `bincompletion.root_lower_bound`.  Only when the certified gap exceeds
   ``gap_threshold`` does the controller fall back to a full solve —
   itself warm-started with the repaired plan as incumbent — and refresh
   the dual prices.

Tensor builds are incremental too: the new fleet's `ProblemTensors` are
derived from the previous fleet's via `drop_items`/`append_items` (and
`with_costs` for price events) instead of re-stacking the whole fleet.

`what_if` batches many hypothetical fleets (autoscaling lookahead) through
the FFD/BFD scan kernel (`kernels.pack`) in one launch and returns their
heuristic costs.

## Where it runs

The controller's device work runs on its manager's ``device`` (the card
unless the manager was given ``device="cpu"``): the what-if scan, the
repair's placement scores and, through `class_prices` and full fallbacks,
branch-and-price's knapsack pricing.  Everything else is host numpy.

## Mechanism vs. policy

Everything above is *mechanism*: event diffing, incremental
`ProblemTensors`, pinned/warm solves, and dual certification.  The
decisions of *when to migrate, when to re-price, and when to resize the
fleet* live in a pluggable policy (`core.policy.ReplanPolicy`, default
`PinningPolicy` — never migrate, the historical behaviour).  After every
`reset`/`apply` the controller hands the mechanism's `ReplanResult` to the
policy, which may invoke the mechanism back through its policy-facing
surface:

* `placement_state()` — the live fleet as dense arrays (requirements,
  owners, per-bin residuals) for batched evacuation scoring;
* `try_migrate(names)` — a bounded-migration consolidation move: free the
  named streams, pin everything else, exact-solve the ≤k-stream
  sub-problem (`bincompletion.migration_subproblem` + ``pinned=``) and
  adopt the result **only** when it certifies a strict cost reduction;
* `refresh_prices()` — recompute the covering-LP dual prices (dual-price
  aging) and return the tightened lower bound;
* `what_if(fleets)` — the batched lookahead described above.

## Time, lifecycle, and billing

The controller carries a monotone clock (``now``, hours — advanced by each
event's ``at`` timestamp) and an instance lifecycle ledger
(`core.lifecycle.LifecycleEngine`, parameterized by a `BillingModel`).
Every open bin is an instance with a lifetime: provisioned when a re-plan
first opens it (billed from that instant, serving only after the boot
latency elapses), decommissioned when a re-plan closes it — with a drain
window equal to the boot latency when the same step opened replacement
bins, so migrations double-bill while the destination boots.  The ledger
is what `simulate_churn` integrates billed cost over, and what
`try_migrate(billing_horizon=...)` certifies consolidation moves against:
under hourly billing, evacuating a bin mid-quantum saves nothing.

Acting (not merely advisory) autoscaling rides the same ledger:
`pre_provision` launches warm spare instances ahead of forecast joins
(billed immediately, RUNNING once booted), and any re-plan that opens a
new bin consumes a matching spare's uid instead of a cold boot — the
join lands on an already-warm instance.  `release_spare` retires unused
spares; `core.policy.ActingAutoscaler` drives both ends.

## Spot instances & preemption

The instance market is two-tier: spot `BinType`s carry an interruption
``hazard`` (λ preemptions per instance-hour) next to their discounted
rent.  A `streams.InstancePreempted` event is the cloud calling the
discount in: the controller resolves the victim (an explicit uid, or
per-type thinning of a sampled shock against the alive spot fleet —
`_preemption_target`), force-closes it through
`LifecycleEngine.preempt` (no drain window; billing still rounds the
final quantum up), and re-places the displaced streams through the
ordinary greedy-repair + exact-pinned-subsolve path.  Unlike a planned
migration there is no make-before-break overlap, so the replacement's
boot wait is charged to degraded time by the simulator.  Risk-aware
allocation prices that risk up front: `core.policy.risk_adjusted_catalog`
sets spot decision costs to rent + λ x re-placement penalty (billing
keeps the true rent via `BinType.billed_rent`), and
`core.policy.ActingAutoscaler` refuses to hold spares on types above its
hazard tolerance.

## Interruption notices & graceful degradation

Real clouds warn ~2 minutes ahead of a spot reclamation.  A
`streams.InstancePreemptionNotice` resolves its victim exactly like a
preemption, marks it non-accepting in the ledger
(`LifecycleEngine.notice`), and — when ``drain_on_notice`` is on — the
controller *evacuates* it immediately: the victim bin leaves the plan,
its members re-place through the ordinary repair path, and the victim
drains (still serving, still billing) until its replacements boot or the
deadline hits, whichever is first.  The paired kill then lands on an
already-empty instance: blackout became an ordinary double-billed
migration.  With ``drain_on_notice=False`` the warning is recorded but
ignored — the naive baseline the storm benchmark compares against.

Degradation is a mechanism move too: `set_stream_rung` shrinks a
stream's requirement vector to a lower rung of its `streams.SLATier`
rate ladder (an internal rate-change fold — the stream's *nominal* rate
is remembered and restored), and `park_stream`/`unpark_stream` take a
parkable stream off the fleet entirely.  The *when* — which streams,
under what pressure — is `core.policy.GracefulDegradationPolicy`'s call.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

from ..device import KernelError
from .binpack import arcflow, bincompletion, heuristics
from .binpack.problem import (
    BinType,
    InfeasibleError,
    OpenBin,
    Problem,
    Solution,
    build_solution,
)
from .lifecycle import BillingModel, LifecycleEngine
from .manager import AllocationPlan, PlacedStream
from .strategies import ST3, Strategy
from .streams import (
    FleetEvent,
    InstancePreempted,
    InstancePreemptionNotice,
    PriceChanged,
    StreamAdded,
    StreamRateChanged,
    StreamRemoved,
    StreamSpec,
    apply_events,
    fleet_key,
)

__all__ = [
    "FleetController",
    "ReplanResult",
    "MigrationResult",
    "PlacementState",
]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """One re-plan step's outcome (`FleetController.apply`)."""

    plan: AllocationPlan
    mode: str  # "reset" | "noop" | "warm" | "full"
    displaced: tuple[str, ...]  # streams that had to be (re)placed
    migrated: tuple[str, ...]  # surviving streams whose instance changed
    lower_bound: float  # certified LB on the optimal hourly cost
    gap: float  # (plan cost - lower_bound) / lower_bound
    nodes: int  # B&B nodes spent on this step
    actions: tuple[str, ...] = ()  # policy-layer actions taken on this step
    advice: dict | None = None  # autoscaler provisioning advice, if any
    at: float = 0.0  # controller clock (hours) when this step committed


@dataclasses.dataclass(frozen=True)
class MigrationResult:
    """Outcome of one `FleetController.try_migrate` consolidation move."""

    accepted: bool  # True iff the move certified a strict cost reduction
    cost_before: float  # fleet hourly cost before the move
    cost_after: float  # after (== achieved sub-solve cost; >= before if rejected)
    migrated: tuple[str, ...]  # streams whose instance changed (empty if rejected)
    nodes: int  # B&B nodes the sub-solve spent
    lower_bound: float  # certified LB on the current fleet's optimal cost
    gap: float  # (adopted plan cost - lower_bound) / lower_bound
    #: $ billed over the certification horizon if adopted, relative to not
    #: moving (negative = saving); None when no billing_horizon was given.
    billed_delta: float | None = None


@dataclasses.dataclass(frozen=True)
class PlacementState:
    """The live fleet as dense arrays (the policy layer's scoring view).

    Item axes follow ``problem.items`` order; bin axes follow the
    controller's open-bin order.  `resid` is residual *effective* capacity
    (utilization-capped), the same geometry every solver packs against.
    """

    names: tuple[str, ...]  # per item: stream name
    req: np.ndarray  # (n, C, dim) +inf-padded requirement tensor
    choice_mask: np.ndarray  # (n, C) valid-choice booleans
    owner: np.ndarray  # (n,) open-bin position hosting each item
    resid: np.ndarray  # (P, dim) per-bin residual effective capacity
    bin_costs: np.ndarray  # (P,) hourly cost of each open bin
    members: tuple[tuple[str, ...], ...]  # per bin: member stream names
    cheapest_host: np.ndarray  # (n,) cheapest cost of hosting the item alone


@dataclasses.dataclass
class _BinState:
    """One open instance: stable identity + member streams."""

    uid: int
    bin_type: BinType
    members: dict[str, str]  # stream name -> choice label ("cpu"/"accel")

    def snapshot(self) -> "_BinState":
        return _BinState(self.uid, self.bin_type, dict(self.members))


class FleetController:
    """Owns a mutable fleet; re-plans incrementally on `FleetEvent`s.

    Created via `ResourceManager.controller()` (or directly); `reset`
    establishes the fleet with a full solve, `apply`/`apply_events` folds
    churn events in.  All plans returned are full `AllocationPlan`s over
    the current fleet, validated end to end.
    """

    def __init__(
        self,
        manager,
        strategy: Strategy = ST3,
        *,
        gap_threshold: float = 0.1,
        sub_max_nodes: int = 50_000,
        policy=None,
        billing: BillingModel | None = None,
        billing_by_type: dict[str, BillingModel] | None = None,
        drain_on_notice: bool = True,
        colgen_pool=None,
    ) -> None:
        from .policy import PinningPolicy

        self.manager = manager
        self.strategy = strategy
        # Branch-and-price column pool, shared with the manager's solver
        # routing (and, under a ShardedController, with every sibling
        # cell).  Catalog-keyed, so it survives fleet churn: columns
        # generated pricing one era keep seeding the master LP in the
        # next, which is what makes colgen viable on the re-plan path.
        if colgen_pool is None:
            from .binpack import colgen

            colgen_pool = getattr(manager, "colgen_pool", None)
            if colgen_pool is None:
                colgen_pool = colgen.ColumnPool()
        self._colgen_pool = colgen_pool
        if hasattr(manager, "colgen_pool"):
            manager.colgen_pool = colgen_pool
        self.gap_threshold = gap_threshold
        self.sub_max_nodes = sub_max_nodes
        self.policy = policy if policy is not None else PinningPolicy()
        #: Act on `InstancePreemptionNotice` by evacuating the victim
        #: inside the warning window (make-before-break); False records
        #: the warning but keeps serving — the naive blackout baseline.
        self.drain_on_notice = drain_on_notice
        # Default billing is the timeless model (instant boot, continuous
        # quantum): the lifecycle ledger then reproduces snapshot costing
        # exactly and every pre-lifecycle call site behaves unchanged.
        # `billing_by_type` layers per-instance-type contracts over it
        # (spot vs on-demand), resolved by the ledger's `billing_for`.
        self.billing = billing if billing is not None else BillingModel()
        self.billing_by_type = dict(billing_by_type or {})
        self.lifecycle = LifecycleEngine(
            self.billing, billing_by_type=self.billing_by_type
        )
        self.now = 0.0  # monotone clock, hours (advanced by event `at`s)
        self._spares: dict[int, BinType] = {}  # warm spare uid -> type
        self._pending_release: set[int] = set()  # spares released end-of-event
        self._ledger_live: set[int] = set()  # bin uids at the last sync
        self._noticed: dict[int, float] = {}  # noticed uid -> kill deadline
        self._notice_ids: dict[int, int | None] = {}  # notice_id -> victim uid
        self._nominal: dict[str, float] = {}  # degraded stream -> nominal fps
        self._degraded: dict[str, int] = {}  # degraded stream -> ladder rung
        self._parked: dict[str, StreamSpec] = {}  # parked name -> nominal spec
        self._streams: list[StreamSpec] = []
        self._problem: Problem | None = None
        self._plan: AllocationPlan | None = None
        self._bins: list[_BinState] = []
        # Covering-LP class prices; None = not computed yet for this fleet
        # era (they are refreshed lazily: `reset` is on `allocate`'s hot
        # path and must not pay for pattern enumeration).
        self._prices: dict[bytes, float] | None = None
        self._uid = itertools.count()

    # ------------------------------------------------------------------ API

    @property
    def fleet(self) -> tuple[StreamSpec, ...]:
        return tuple(self._streams)

    @property
    def plan(self) -> AllocationPlan | None:
        return self._plan

    def reset(
        self, streams: Sequence[StreamSpec], *, at: float | None = None
    ) -> ReplanResult:
        """Establish the fleet with a full (cold) solve.

        ``at`` (hours) starts the lifecycle clock for a timed replay; the
        previous fleet era's ledger and warm spares are discarded and
        every opened instance is provisioned at the reset instant (it
        boots — and is billed — from there).
        """
        problem = self.manager.formulate(streams, self.strategy)
        plan = self.manager._plan(streams, problem, self.strategy)
        self._streams = list(streams)
        self._problem = problem
        if at is not None:
            self.now = at
        self._spares = {}
        self._pending_release = set()
        self.lifecycle = LifecycleEngine(
            self.billing, billing_by_type=self.billing_by_type
        )
        self._ledger_live = set()
        self._noticed = {}
        self._notice_ids = {}
        self._nominal = {}
        self._degraded = {}
        self._parked = {}
        self._adopt_solution(problem, plan.solution, match_old=False)
        self._plan = plan
        self._prices = None  # stale for the new fleet era; refreshed lazily
        self._sync_lifecycle()
        lb = bincompletion.root_lower_bound(problem)
        if plan.optimal:
            lb = max(lb, plan.hourly_cost)  # an exact solve IS a lower bound
        result = ReplanResult(
            plan=plan,
            mode="reset",
            displaced=tuple(s.name for s in streams),
            migrated=(),
            lower_bound=lb,
            gap=_gap(plan.hourly_cost, lb),
            nodes=0,
            at=self.now,
        )
        result = self.policy.on_reset(self, result)
        self._flush_spare_releases()
        self._sync_lifecycle()
        return result

    def recalibrate(self, artifact=None) -> ReplanResult:
        """Re-derive every requirement vector and re-solve the standing fleet.

        ``artifact`` (a ``core.calibration.CalibrationArtifact``) installs a
        new calibration on the manager first; without one the manager's
        formulate memo is just invalidated (its profile table already
        changed in place).  The fleet is re-established with a cold solve
        at the current clock — a kernel change is a new fleet era: every
        placement, spare, and dual price is stale against the new vectors,
        so none of the warm-start state is worth carrying over.
        """
        if artifact is not None:
            self.manager.set_calibration(artifact)
        else:
            self.manager._formulate_cache.clear()
        return self.reset(self.fleet)

    def apply_events(self, events: Sequence[FleetEvent]) -> list[ReplanResult]:
        return [self.apply(ev) for ev in events]

    def apply(self, event: FleetEvent) -> ReplanResult:
        """Fold one fleet event in; re-plan incrementally.

        The mechanism result (pin + repair + certify, see the module
        docstring) is handed to the controller's policy, which may
        consolidate, re-price, or attach provisioning advice before the
        result ships.

        Raises `InfeasibleError` when the event makes the fleet
        unplaceable (e.g. a rate no device can reach); after any exception
        mid-replan the controller's state is stale — call `reset` before
        further events.
        """
        self.now = max(self.now, event.at)
        result = self.policy.on_event(self, event, self._fold(event))
        self._flush_spare_releases()
        self._sync_lifecycle()
        return dataclasses.replace(result, at=self.now)

    def _fold(self, event: FleetEvent) -> ReplanResult:
        """The mechanism half of `apply`: fold one event, no policy."""
        if self._problem is None:
            raise RuntimeError("FleetController.apply before reset()")
        if isinstance(event, PriceChanged):
            return self._apply_price(event)
        if isinstance(event, InstancePreempted):
            return self._apply_preemption(event)
        if isinstance(event, InstancePreemptionNotice):
            return self._apply_notice(event)
        # External stream events speak for the *nominal* service level:
        # a departure or an analyst's renegotiation clears any internal
        # degradation bookkeeping for that stream, and events naming a
        # parked stream resolve against the parking lot (the stream is
        # not in the live fleet).
        if isinstance(event, StreamRemoved):
            if event.name in self._parked:
                del self._parked[event.name]
                return self._noop_result()
            self._nominal.pop(event.name, None)
            self._degraded.pop(event.name, None)
        elif isinstance(event, StreamRateChanged):
            if event.name in self._parked:
                self._parked[event.name] = dataclasses.replace(
                    self._parked[event.name], desired_fps=event.desired_fps
                )
                return self._noop_result()
            self._nominal.pop(event.name, None)
            self._degraded.pop(event.name, None)
        elif isinstance(event, StreamAdded) and event.stream.name in self._parked:
            raise ValueError(
                f"stream {event.stream.name!r} is parked; unpark it instead"
            )
        return self._fold_stream_event(event)

    def _fold_stream_event(
        self, event: FleetEvent, *, allow_full: bool = True
    ) -> ReplanResult:
        """Fold a join/leave/re-rate into the fleet and re-plan.

        Shared by external events (via `_fold`, which first reconciles
        degradation bookkeeping) and the internal degradation moves
        (`set_stream_rung`, `park_stream`, `unpark_stream`), which manage
        that bookkeeping themselves.  Degradation moves pass
        ``allow_full=False``: they are local, reversible requirement
        shrinks issued mid-storm, exactly when the controller must stay
        fast — a poor dual-certified gap then keeps the warm repair
        instead of escalating to a global re-solve (degraded fleets mix
        fractional rates into many small item classes, the worst case for
        the exact pattern solvers).
        """
        new_streams = list(apply_events(self._streams, [event]))
        if fleet_key(new_streams) == fleet_key(self._streams):
            return self._noop_result()

        # Displaced streams: appended at the fleet's tail by apply_events.
        if isinstance(event, StreamAdded):
            displaced_names = {event.stream.name}
        elif isinstance(event, StreamRateChanged):
            displaced_names = {event.name}
        else:  # StreamRemoved
            displaced_names = set()

        # Evict departed/displaced members from the bin states; bins that
        # keep at least one member are pinned, emptied bins close.
        gone = {event.name} if isinstance(event, StreamRemoved) else set()
        for b in self._bins:
            for name in displaced_names | gone:
                b.members.pop(name, None)
        self._bins = [b for b in self._bins if b.members]

        problem = self._formulate_incremental(new_streams)
        n_kept = len(new_streams) - len(displaced_names)
        return self._replan(
            problem, new_streams, n_kept, displaced_names,
            allow_full=allow_full,
        )

    def what_if(
        self, fleets: Sequence[Sequence[StreamSpec]], *, best_fit: bool = False
    ) -> np.ndarray:
        """Heuristic hourly cost of many hypothetical fleets, one dispatch.

        Autoscaling lookahead: formulate each candidate fleet (memoized by
        the manager) and push all of them through the batched FFD/BFD scan
        (`heuristics.batched_fleet_costs`, one launch on the manager's
        device).  Costs are heuristic upper bounds, cheap enough to rank
        hundreds of scenarios per tick.
        """
        problems = [
            self.manager.formulate(list(f), self.strategy) for f in fleets
        ]
        return heuristics.batched_fleet_costs(
            problems, best_fit=best_fit, device=self.manager.device
        )

    # -------------------------------------------------- policy-facing surface

    def placement_state(self) -> PlacementState:
        """The live fleet as dense arrays (see `PlacementState`).

        The requirement tensor is the cached `ProblemTensors` view (no
        re-stack) and the residuals read the current plan's already-summed
        bin loads — one O(bins · dim) pass, no per-bin load recompute.
        Policies feed this straight into the batched evacuation scoring
        (`heuristics.evacuation_scores`).
        """
        if self._problem is None or self._plan is None:
            raise RuntimeError("placement_state before reset()")
        problem = self._problem
        t = problem.tensors()
        sol_bins = self._plan.solution.bins
        assert len(sol_bins) == len(self._bins)  # _assemble keeps the order
        pos_of: dict[str, int] = {}
        resid = np.empty((len(self._bins), problem.dim))
        for b_i, b in enumerate(self._bins):
            resid[b_i] = problem.effective_capacity(b.bin_type) - np.asarray(
                sol_bins[b_i].load
            )
            for name in b.members:
                pos_of[name] = b_i
        return PlacementState(
            names=tuple(it.name for it in problem.items),
            req=t.req,
            choice_mask=t.choice_mask,
            owner=np.asarray(
                [pos_of[it.name] for it in problem.items], dtype=np.int64
            ),
            resid=resid,
            bin_costs=np.asarray([b.bin_type.cost for b in self._bins]),
            members=tuple(tuple(b.members) for b in self._bins),
            cheapest_host=t.cheapest_host,
        )

    def try_migrate(
        self,
        names: Sequence[str],
        *,
        max_nodes: int | None = None,
        min_saving: float = 0.0,
        billing_horizon: float | None = None,
    ) -> MigrationResult:
        """Attempt a bounded-migration consolidation move, transactionally.

        Frees the named streams from their bins (bins left empty close —
        that rent is the saving at stake), pins every other bin with its
        remaining load, and exact-solves the freed streams' sub-problem
        (`bincompletion.migration_subproblem` + ``pinned=``), seeded by the
        batched greedy repair.  The move is adopted **only** when the
        achieved cost beats the current plan by more than ``min_saving``
        (an exact sub-solve, so the reduction is certified); otherwise the
        bin states roll back untouched.  The *when/what* — which streams,
        how many per event — is the policy layer's decision.

        With ``billing_horizon`` (hours) the move must additionally
        certify a *billed* saving over ``[now, now + horizon]`` through
        the lifecycle ledger: closed bins only stop billing at their next
        quantum boundary (delayed by the drain window when replacements
        must boot), while cold new bins bill fresh quanta — so under
        hourly billing an evacuation that merely trims $/hr mid-quantum
        is rejected.  This flips decisions the instantaneous rate test
        accepts.
        """
        if self._problem is None or self._plan is None:
            raise RuntimeError("try_migrate before reset()")
        problem = self._problem
        before = self._plan.hourly_cost
        name_set = set(names)
        free_idx = [
            i for i, it in enumerate(problem.items) if it.name in name_set
        ]
        if len(free_idx) != len(name_set):
            missing = name_set - {it.name for it in problem.items}
            raise KeyError(f"no stream(s) named {sorted(missing)!r}")
        lb = self._lower_bound(problem)
        if not free_idx:
            return MigrationResult(
                accepted=False,
                cost_before=before,
                cost_after=before,
                migrated=(),
                nodes=0,
                lower_bound=lb,
                gap=_gap(before, lb),
            )
        snapshot = [b.snapshot() for b in self._bins]
        for b in self._bins:
            for name in name_set:
                b.members.pop(name, None)
        pinned_states = [b for b in self._bins if b.members]
        self._bins = pinned_states
        by_name = {s.name: s for s in self._streams}
        pinned = [
            OpenBin(
                bin_type=b.bin_type,
                load=self._bin_load(b, self._streams, by_name),
            )
            for b in pinned_states
        ]
        sub = bincompletion.migration_subproblem(problem, free_idx)
        repair_placements, repair_opened = self._greedy_repair(sub, pinned)
        incumbent = bincompletion.pinned_solution(
            sub, pinned, repair_placements, repair_opened
        )
        sol, stats = bincompletion.solve(
            sub,
            max_nodes=max_nodes if max_nodes is not None else self.sub_max_nodes,
            incumbent=incumbent,
            pinned=pinned,
        )
        if sol.cost >= before - max(min_saving, _EPS):
            self._bins = snapshot  # reject: roll the bin states back
            return MigrationResult(
                accepted=False,
                cost_before=before,
                cost_after=sol.cost,
                migrated=(),
                nodes=stats.nodes,
                lower_bound=lb,
                gap=_gap(before, lb),
            )
        billed_delta = None
        if billing_horizon is not None:
            pinned_uids = {b.uid for b in pinned_states}
            closed = [b.uid for b in snapshot if b.uid not in pinned_uids]
            new_types = [b.bin_type for b in sol.bins[len(pinned_states):]]
            billed_delta = self._billed_migration_delta(
                closed, new_types, billing_horizon
            )
            if billed_delta >= -max(min_saving * billing_horizon, _EPS):
                self._bins = snapshot  # rate-cheaper but billed-pointless
                return MigrationResult(
                    accepted=False,
                    cost_before=before,
                    cost_after=sol.cost,
                    migrated=(),
                    nodes=stats.nodes,
                    lower_bound=lb,
                    gap=_gap(before, lb),
                    billed_delta=billed_delta,
                )
        old_uid_of = {n: b.uid for b in snapshot for n in b.members}
        self._adopt_pinned_solution(pinned_states, sub, sol)
        gap = _gap(sol.cost, lb)
        self._plan = self._assemble(problem, optimal=gap <= _EPS)
        migrated = tuple(
            sorted(
                n
                for n, uid in self._uid_map().items()
                if n in old_uid_of and uid != old_uid_of[n]
            )
        )
        return MigrationResult(
            accepted=True,
            cost_before=before,
            cost_after=self._plan.hourly_cost,
            migrated=migrated,
            nodes=stats.nodes,
            lower_bound=lb,
            gap=gap,
            billed_delta=billed_delta,
        )

    def try_swap(
        self,
        name_a: str,
        name_b: str,
        *,
        max_nodes: int | None = None,
        min_saving: float = 0.0,
        billing_horizon: float | None = None,
    ) -> MigrationResult:
        """Attempt a certified two-bin stream exchange (partial-bin move).

        Frees exactly two streams hosted by *different* bins and
        exact-solves their joint re-placement against everything else
        pinned — the k=2 exchange whole-bin evacuation cannot express:
        each bin keeps its other members, so the freed pair may trade
        places (stream A into B's freed slack and vice versa) or cascade
        one of them onto a third bin, closing a bin no single whole-bin
        evacuation could empty within budget.  Mechanically this is
        `try_migrate` on the pair, so adoption carries the same strict
        certified-saving and optional billed-delta gates and rejected
        moves roll back untouched.
        """
        if name_a == name_b:
            raise ValueError(f"swap needs two distinct streams, got {name_a!r} twice")
        uid_of = self._uid_map()
        missing = [n for n in (name_a, name_b) if n not in uid_of]
        if missing:
            raise KeyError(f"no stream(s) named {sorted(missing)!r}")
        if uid_of[name_a] == uid_of[name_b]:
            raise ValueError(
                f"streams {name_a!r} and {name_b!r} share an instance; "
                "a swap exchanges streams between two bins"
            )
        return self.try_migrate(
            [name_a, name_b],
            max_nodes=max_nodes,
            min_saving=min_saving,
            billing_horizon=billing_horizon,
        )

    def refresh_prices(self) -> float:
        """Re-derive the covering-LP dual prices for the current fleet era
        (the dual-price-aging policy's lever) and return the refreshed
        certified lower bound."""
        if self._problem is None:
            raise RuntimeError("refresh_prices before reset()")
        self._refresh_prices(self._problem)
        return self._lower_bound(self._problem)

    def install_prices(self, prices: dict[bytes, float]) -> float:
        """Adopt externally derived class prices; return the refreshed LB.

        The sharded controller's one-dispatch certification hook: prices
        for every cell come out of ONE batched pricing run
        (`colgen.batched_dual_prices`) and are installed per cell here
        instead of each cell re-deriving its own.  The caller owns the
        admissibility contract (``pattern·y <= cost`` for every packing
        over this catalog — what `class_prices` guarantees); the bound
        still maxes against the density LB, so an empty or weak price
        map can only loosen, never break, the certificate.
        """
        if self._problem is None:
            raise RuntimeError("install_prices before reset()")
        self._prices = dict(prices)
        return self._lower_bound(self._problem)

    # ------------------------------------------------ graceful degradation

    @property
    def degraded_rungs(self) -> dict[str, int]:
        """Streams currently served below nominal (name -> ladder rung)."""
        return dict(self._degraded)

    @property
    def parked(self) -> dict[str, StreamSpec]:
        """Streams parked off the fleet (name -> nominal-rate spec)."""
        return dict(self._parked)

    def nominal_fps(self, name: str) -> float:
        """A live stream's *nominal* rate (its contract rate, not the
        possibly-degraded rate currently served)."""
        if name in self._nominal:
            return self._nominal[name]
        spec = next((s for s in self._streams if s.name == name), None)
        if spec is None:
            raise KeyError(f"no stream named {name!r}")
        return spec.desired_fps

    def set_stream_rung(self, name: str, rung: int) -> ReplanResult:
        """Serve ``name`` at rung ``rung`` of its tier's rate ladder.

        Rung 0 is full (nominal) rate; higher rungs shrink the stream's
        requirement vector via an internal rate-change fold — the
        mechanism's degradation move, re-planned through the ordinary
        incremental path.  The nominal rate is remembered so later calls
        (including restores back to rung 0) ladder off the contract rate,
        never off an already-degraded one; an *external*
        `StreamRateChanged` resets the contract and clears the rung.
        """
        if name in self._parked:
            raise ValueError(f"stream {name!r} is parked; unpark it first")
        spec = next((s for s in self._streams if s.name == name), None)
        if spec is None:
            raise KeyError(f"no stream named {name!r}")
        ladder = spec.tier.rate_ladder
        if not 0 <= rung < len(ladder):
            raise ValueError(
                f"stream {name!r}: rung {rung} outside tier "
                f"{spec.tier.name} ladder of {len(ladder)}"
            )
        nominal = self._nominal.get(name, spec.desired_fps)
        fps = nominal * ladder[rung]
        if rung == 0:
            self._nominal.pop(name, None)
            self._degraded.pop(name, None)
        else:
            self._nominal[name] = nominal
            self._degraded[name] = rung
        if abs(fps - spec.desired_fps) <= _EPS * max(1.0, nominal):
            return self._noop_result()
        return self._fold_stream_event(
            StreamRateChanged(name, fps, at=self.now), allow_full=False
        )

    def park_stream(self, name: str) -> ReplanResult:
        """Take a parkable stream off the fleet entirely (last resort).

        The stream's nominal-rate spec is remembered in the parking lot;
        `unpark_stream` re-joins it at full rate.  Only tiers with
        ``parkable=True`` may be parked.  Parked time is full blackout —
        the simulator charges it against the tier's budget and penalty.
        """
        if name in self._parked:
            raise ValueError(f"stream {name!r} is already parked")
        spec = next((s for s in self._streams if s.name == name), None)
        if spec is None:
            raise KeyError(f"no stream named {name!r}")
        if not spec.tier.parkable:
            raise ValueError(
                f"stream {name!r}: tier {spec.tier.name} is not parkable"
            )
        nominal = self._nominal.pop(name, spec.desired_fps)
        self._degraded.pop(name, None)
        self._parked[name] = dataclasses.replace(spec, desired_fps=nominal)
        return self._fold_stream_event(
            StreamRemoved(name, at=self.now), allow_full=False
        )

    def unpark_stream(self, name: str) -> ReplanResult:
        """Re-join a parked stream at its nominal rate."""
        if name not in self._parked:
            raise KeyError(f"no parked stream named {name!r}")
        spec = self._parked.pop(name)
        return self._fold_stream_event(
            StreamAdded(spec, at=self.now), allow_full=False
        )

    # -------------------------------------------------- lifecycle & billing

    @property
    def instance_uids(self) -> tuple[int, ...]:
        """Stable instance uids, aligned with ``plan.instances`` order —
        the join key between placements and the lifecycle ledger."""
        return tuple(b.uid for b in self._bins)

    @property
    def spares(self) -> dict[int, BinType]:
        """Warm spare instances currently held (uid -> type), a copy."""
        return dict(self._spares)

    def pre_provision(self, bin_type: BinType, *, count: int = 1) -> tuple[int, ...]:
        """Launch ``count`` warm spare instances of ``bin_type`` now.

        Spares are billed from this instant (debited through the
        lifecycle ledger) and carry no streams; the next re-plan that
        opens a bin of the same type consumes a spare's uid instead of
        cold-booting, so forecast joins land on already-warm capacity.
        The acting autoscaler's lever.
        """
        uids = []
        for _ in range(count):
            uid = next(self._uid)
            self.lifecycle.provision(
                uid, bin_type.name, bin_type.billed_rent, self.now
            )
            self._spares[uid] = bin_type
            uids.append(uid)
        return tuple(uids)

    def release_spare(self, uid: int) -> None:
        """Retire an unused warm spare (its billed quanta stay billed)."""
        if uid not in self._spares:
            raise KeyError(f"no spare with uid {uid}")
        del self._spares[uid]
        self._pending_release.discard(uid)
        self.lifecycle.decommission(uid, self.now)

    def defer_release_spare(self, uid: int) -> None:
        """Mark a warm spare for release at the *end* of the current event.

        `release_spare` retires the spare immediately, which races the
        rest of the same replay step: a policy running after the release
        (or a re-plan it triggers) can no longer consume the spare even
        though it is still billed for the quantum.  A deferred release
        keeps the spare consumable until the event finishes folding; the
        controller flushes the marks after the policy hook returns, and a
        mark on a spare that a re-plan consumed in the meantime simply
        evaporates.
        """
        if uid not in self._spares:
            raise KeyError(f"no spare with uid {uid}")
        self._pending_release.add(uid)

    def _flush_spare_releases(self) -> None:
        """End-of-event: retire the spares still marked and unconsumed."""
        for uid in sorted(self._pending_release):
            if uid in self._spares:
                del self._spares[uid]
                self.lifecycle.decommission(uid, self.now)
        self._pending_release.clear()

    def stream_requirements(self, stream: StreamSpec) -> list[np.ndarray]:
        """Strategy-filtered requirement vectors, one per execution choice."""
        item = self.manager.profiles.choices_for(stream)
        allowed = self.strategy.filter_choice_labels()
        return [
            np.asarray(c.requirement, dtype=np.float64)
            for c in item.choices
            if allowed is None or c.label in allowed
        ]

    def host_candidates(self, stream: StreamSpec) -> tuple[BinType, ...]:
        """Instance types (under this controller's strategy) able to host
        ``stream`` alone, cheapest first — the spare-type menu an
        autoscaler provisions from for a forecast join."""
        reqs = self.stream_requirements(stream)
        cap = self.manager.utilization_cap
        out = []
        for bt in self.strategy.filter_bins(self.manager.catalog):
            eff = np.asarray(bt.capacity, dtype=np.float64) * cap
            if any(np.all(req <= eff + _EPS) for req in reqs):
                out.append(bt)
        if not out:
            raise InfeasibleError(
                f"stream {stream.name}: no {self.strategy.name} instance "
                f"can host it alone"
            )
        return tuple(sorted(out, key=lambda b: b.cost))

    def cheapest_host_bin(self, stream: StreamSpec) -> BinType:
        """Cheapest instance type able to host ``stream`` alone."""
        return self.host_candidates(stream)[0]

    def open_host_bin(self, stream: StreamSpec) -> BinType:
        """The instance type the packer's open rule would launch for
        ``stream`` — `heuristics.open_cost_score` (cheap bins the stream
        nearly fills beat expensive bins it barely dents), the same rule
        the greedy repair applies when a displaced stream fits no pinned
        residual.  The spare type an acting autoscaler holds warm, so
        consumed spares match what re-plans actually open."""
        reqs = self.stream_requirements(stream)
        cap = self.manager.utilization_cap
        best: BinType | None = None
        best_score = np.inf
        for bt in self.strategy.filter_bins(self.manager.catalog):
            eff = np.asarray(bt.capacity, dtype=np.float64) * cap
            for req in reqs:
                if np.any(req > eff + _EPS):
                    continue
                with np.errstate(divide="ignore", invalid="ignore"):
                    frac = np.max(
                        np.where(eff > 0, req / np.maximum(eff, 1e-300), 0.0)
                    )
                score = float(heuristics.open_cost_score(bt.cost, frac))
                if score < best_score:
                    best_score, best = score, bt
        if best is None:
            raise InfeasibleError(
                f"stream {stream.name}: no {self.strategy.name} instance "
                f"can host it alone"
            )
        return best

    def set_billing(
        self,
        billing: BillingModel,
        *,
        by_type: dict[str, BillingModel] | None = None,
    ) -> None:
        """Swap the billing model on a live controller.

        A fresh ledger is seeded with the current bins as already-RUNNING
        at ``now`` (their boot is history — only forward billing changes);
        held spares re-provision under the new model.  ``by_type`` swaps
        the per-instance-type contract map as well (None keeps the
        current map; pass ``{}`` to clear it).
        """
        self.billing = billing
        if by_type is not None:
            self.billing_by_type = dict(by_type)
        eng = LifecycleEngine(billing, billing_by_type=self.billing_by_type)
        for b in self._bins:
            eng.adopt_running(
                b.uid, b.bin_type.name, b.bin_type.billed_rent, self.now
            )
        for uid, bt in self._spares.items():
            eng.provision(uid, bt.name, bt.billed_rent, self.now)
        self.lifecycle = eng
        self._ledger_live = {b.uid for b in self._bins}

    def _sync_lifecycle(self) -> None:
        """Reconcile the lifecycle ledger with the post-step bin states.

        Bins the step opened cold are provisioned now (they boot from
        here); bins it closed decommission — draining until every bin
        that *arrived* this step (cold open or consumed spare) is done
        booting, because the departing streams keep running on the old
        instance until the replacement serves (the double-billing
        migration window; a fully booted spare drains nothing).  Idle
        spares are ledger-resident already and reconcile only on
        consumption.
        """
        eng = self.lifecycle
        live = {b.uid: b.bin_type for b in self._bins}
        for uid in [u for u in live if u not in eng]:
            eng.provision(uid, live[uid].name, live[uid].billed_rent, self.now)
        drain_until = self.now
        for uid in live:
            if uid not in self._ledger_live:
                drain_until = max(drain_until, eng.record(uid).running_at)
        for rec in eng.records():
            if (
                rec.terminated_at is None
                and rec.uid not in live
                and rec.uid not in self._spares
            ):
                # A noticed victim drains no longer than its reclamation
                # deadline — the cloud takes the instance back then no
                # matter how long the replacements still need to boot.
                deadline = self._noticed.get(rec.uid)
                end = drain_until if deadline is None else min(drain_until, deadline)
                eng.decommission(rec.uid, self.now, drain_until=end)
        self._ledger_live = set(live)

    def _alloc_uid(self, bin_type: BinType) -> tuple[int, BinType]:
        """Uid (and final type) for a newly opened bin.

        Consume a warm spare of the same type when one is held (the bin
        inherits its ledger record — and its already-elapsed boot), else
        mint a cold uid.  Among matching spares, the one with the
        earliest ``running_at`` wins (ties keep pool order): a
        fully-booted spare must never idle while a still-PROVISIONING one
        is handed to the join — consuming spares in bare dict-insertion
        order broke the "join lands warm" promise whenever the pool held
        mixed boot stages.

        Cross-type substitution: when the open rule landed on a cold
        *spot* type and no same-type spare is held, a capacity-compatible
        **on-demand** spare (hazard-free, every capacity dimension at
        least the requested type's) absorbs the open instead — the bin is
        re-typed to the spare's contract, trading the spot discount for
        an already-billed warm boot and zero interruption risk.  The
        returned `BinType` is the one the bin must carry.
        """

        def pick(match) -> int | None:
            best: int | None = None
            best_running = float("inf")
            for uid, bt in self._spares.items():
                if not match(bt) or not self.lifecycle.accepting(uid, self.now):
                    continue
                running_at = self.lifecycle.record(uid).running_at
                if running_at < best_running:
                    best, best_running = uid, running_at
            return best

        best = pick(lambda bt: bt.name == bin_type.name)
        if best is not None:
            del self._spares[best]
            self._pending_release.discard(best)
            return best, bin_type
        if bin_type.hazard > 0.0:
            req = np.asarray(bin_type.capacity, dtype=np.float64)
            best = pick(
                lambda bt: bt.hazard <= 0.0
                and len(bt.capacity) == len(bin_type.capacity)
                and bool(
                    np.all(np.asarray(bt.capacity, dtype=np.float64) >= req - _EPS)
                )
            )
            if best is not None:
                spare_type = self._spares.pop(best)
                self._pending_release.discard(best)
                return best, spare_type
        return next(self._uid), bin_type

    def _billed_migration_delta(
        self,
        closed_uids: Sequence[int],
        new_types: Sequence[BinType],
        horizon: float,
    ) -> float:
        """$ billed over ``[now, now+horizon]`` if a move is adopted minus
        billed if it is not (negative = the move saves billed dollars).

        Closed bins save only past their next quantum boundary (the
        in-progress quantum is sunk), the close delayed by a drain window
        when replacements must boot; each cold new bin bills fresh quanta
        for the whole horizon (it could close earlier, so this is the
        conservative side).  Spare-held credit is ignored, likewise
        conservative.  Billing contracts resolve per instance type, and
        new bins price at ``bt.cost`` — the *decision* cost, which under a
        risk-adjusted catalog already carries the spot-hazard premium, so
        the certification weighs eviction risk, not just rent.
        """
        end = self.now + horizon
        boot = max(
            (
                self.lifecycle.billing_for(bt.name).boot_hours
                for bt in new_types
            ),
            default=0.0,
        )
        saving = sum(
            self.lifecycle.termination_saving(uid, self.now + boot, end)
            for uid in closed_uids
            if uid in self.lifecycle
        )
        cost_new = sum(
            self.lifecycle.billing_for(bt.name).billed_hours(max(0.0, horizon))
            * bt.cost
            for bt in new_types
        )
        return cost_new - saving

    # ------------------------------------------------------------ internals

    def _replan(
        self,
        problem: Problem,
        new_streams: list[StreamSpec],
        n_kept: int,
        displaced_names: set[str],
        allow_full: bool = True,
    ) -> ReplanResult:
        old_uid_of = self._uid_map()
        pinned_bins = list(self._bins)
        by_name = {s.name: s for s in new_streams}
        pinned = [
            OpenBin(
                bin_type=b.bin_type,
                load=self._bin_load(b, new_streams, by_name),
            )
            for b in pinned_bins
        ]
        n_total = len(new_streams)
        sub_problem = bincompletion.migration_subproblem(
            problem, range(n_kept, n_total)
        )

        # Greedy repair scored in one batched dispatch, then the exact
        # pinned sub-solve seeded with it as warm-start incumbent.
        repair_placements, repair_opened = self._greedy_repair(
            sub_problem, pinned
        )
        incumbent = bincompletion.pinned_solution(
            sub_problem, pinned, repair_placements, repair_opened
        )
        sol, stats = bincompletion.solve(
            sub_problem,
            max_nodes=self.sub_max_nodes,
            incumbent=incumbent,
            pinned=pinned,
        )
        nodes = stats.nodes
        lb = self._lower_bound(problem)
        gap = _gap(sol.cost, lb)

        # Adopt the warm (pinned) solution into the bin states; the full
        # fallback then reads it back as its warm-start incumbent.
        self._adopt_pinned_solution(pinned_bins, sub_problem, sol)
        if gap <= self.gap_threshold or not allow_full:
            mode = "warm"
            optimal = gap <= _EPS  # only a met lower bound certifies globally
        else:
            mode = "full"
            # Warm-started full re-solve through the manager's solver
            # routing, then refresh the dual prices for the new era.
            full_incumbent = self._full_solution(problem, new_streams)
            full_sol, optimal = self.manager._solve(
                problem, incumbent=full_incumbent
            )
            self._adopt_solution(problem, full_sol, match_old=True)
            self._refresh_prices(problem)
            lb = self._lower_bound(problem)
            gap = _gap(full_sol.cost, lb)

        self._streams = new_streams
        self._problem = problem
        self._plan = self._assemble(problem, optimal=optimal)
        migrated = tuple(
            name
            for name, uid in self._uid_map().items()
            if name in old_uid_of
            and name not in displaced_names
            and uid != old_uid_of[name]
        )
        return ReplanResult(
            plan=self._plan,
            mode=mode,
            displaced=tuple(sorted(displaced_names)),
            migrated=migrated,
            lower_bound=lb,
            gap=gap,
            nodes=nodes,
        )

    def _apply_price(self, event: PriceChanged) -> ReplanResult:
        """Re-price the catalog; keep the plan if its gap stays certified.

        The catalog lives on the (shared) manager, so EVERY live
        controller's state is re-priced — a sibling strategy's pinned bins
        must not keep charging stale costs.  ``event.cost`` is the new
        *billed rent*: on a risk-adjusted spot entry (``rent`` set) the
        decision cost keeps its risk premium on top of the new rent —
        exact premium re-derivation needs the penalty parameters, so
        callers wanting it re-run `policy.risk_adjusted_catalog` — and
        the ledger re-prices at the new rent, never the decision cost.
        """
        mgr = self.manager
        if not any(bt.name == event.instance_type for bt in mgr.catalog):
            raise KeyError(f"no instance type {event.instance_type!r}")

        def repriced(bt: BinType) -> BinType:
            if bt.rent is None:
                return dataclasses.replace(bt, cost=event.cost)
            premium = max(0.0, bt.cost - bt.rent)
            return dataclasses.replace(
                bt, cost=event.cost + premium, rent=event.cost
            )

        mgr.catalog = tuple(
            repriced(bt) if bt.name == event.instance_type else bt
            for bt in mgr.catalog
        )
        mgr._formulate_cache.clear()  # cached Problems embed stale prices
        by_name = {bt.name: bt for bt in mgr.catalog}
        for ctrl in mgr._controllers.values():
            if ctrl is not self:
                ctrl._reprice(by_name)
        self._reprice(by_name)
        # Price moves invalidate the dual prices (a cut may tighten or
        # break); refresh before certifying.
        self._refresh_prices(self._problem)
        return self._replan(
            self._problem, list(self._streams), len(self._streams), set()
        )

    def _apply_preemption(self, event: InstancePreempted) -> ReplanResult:
        """Fold a spot interruption in: force-close the victim, re-place.

        The victim resolves via `_preemption_target` (an explicit uid, or
        thinning a sampled shock against the alive spot instances).  A
        miss — no alive spot instance at the sampled slot, or a stale uid
        that already terminated — is a no-op: an all-on-demand fleet
        rides out every shock unscathed.  A hit force-closes the bin
        through `LifecycleEngine.preempt` (no drain window: unlike a
        planned migration there is no make-before-break overlap) and
        re-places the displaced streams through the ordinary greedy-repair
        + exact-pinned-subsolve path; the simulator charges their
        replacement boot wait to degraded time.

        A kill carrying a ``notice_id`` resolves against whatever
        instance the matching notice hit (or misses if the notice did):
        the pair always targets the same instance, no matter what the
        policy did in between.  When that instance was already evacuated
        (drain-ahead-of-kill) the plan is untouched — the kill merely
        restates the scheduled drain end to the reclamation instant.
        """
        if event.notice_id >= 0:
            uid = self._notice_ids.pop(event.notice_id, None)
            if uid is None or uid not in self.lifecycle:
                return self._noop_result()
            rec = self.lifecycle.record(uid)
            if rec.terminated_at is not None and rec.terminated_at <= self.now:
                return self._noop_result()
        else:
            uid = self._preemption_target(event)
            if uid is None:
                return self._noop_result()
        self._noticed.pop(uid, None)
        if uid in self._spares:
            # A held warm spare dies: nothing was placed on it, so the
            # fleet plan stands — only the ledger and spare pool change.
            del self._spares[uid]
            self._pending_release.discard(uid)
            self.lifecycle.preempt(uid, self.now)
            return self._noop_result()
        victim = next((b for b in self._bins if b.uid == uid), None)
        if victim is None:
            # Already evacuated ahead of the kill (notice drain): the
            # plan stands; the drain scheduled past `now` cuts to `now`.
            rec = self.lifecycle.record(uid)
            if rec.terminated_at is None or rec.terminated_at > self.now:
                self.lifecycle.preempt(uid, self.now)
            return self._noop_result()
        displaced_names = set(victim.members)
        self.lifecycle.preempt(uid, self.now)
        self._bins = [b for b in self._bins if b.uid != uid]
        self._ledger_live.discard(uid)
        # Survivors keep their order; the displaced move to the tail —
        # the layout `_replan` expects (and `_formulate_incremental`
        # derives tensors for via a pure permutation, no re-stack).
        survivors = [s for s in self._streams if s.name not in displaced_names]
        displaced = [s for s in self._streams if s.name in displaced_names]
        new_streams = survivors + displaced
        problem = self._formulate_incremental(new_streams)
        return self._replan(
            problem, new_streams, len(survivors), displaced_names
        )

    def _apply_notice(self, event: InstancePreemptionNotice) -> ReplanResult:
        """Fold a reclamation warning in: mark the victim, maybe evacuate.

        The victim resolves exactly like a preemption's (explicit uid or
        seeded thinning — the warning precedes the kill it announces).  A
        hit is recorded in the ledger (`LifecycleEngine.notice`: the
        instance stops accepting placements but keeps serving and
        billing) and remembered under ``event.notice_id`` so the paired
        kill targets the same instance.  With ``drain_on_notice`` the
        victim is then evacuated make-before-break: a noticed spare is
        released on the spot; a noticed bin leaves the plan, its members
        re-place through the ordinary repair path, and `_sync_lifecycle`
        drains the victim until its replacements boot — clamped to the
        deadline, past which the cloud reclaims it regardless.
        """
        uid = self._preemption_target(event)
        if event.notice_id >= 0:
            self._notice_ids[event.notice_id] = uid
        if uid is None:
            return self._noop_result()
        deadline = max(event.deadline, self.now)
        self.lifecycle.notice(uid, self.now, deadline)
        self._noticed[uid] = deadline
        if not self.drain_on_notice:
            return self._noop_result()
        if uid in self._spares:
            # A doomed spare absorbs nothing — hand it back immediately
            # (billed quanta stay billed; the paired kill then no-ops).
            del self._spares[uid]
            self._pending_release.discard(uid)
            self.lifecycle.decommission(uid, self.now)
            return self._noop_result()
        victim = next(b for b in self._bins if b.uid == uid)
        displaced_names = set(victim.members)
        # No `preempt` here: the victim keeps serving its streams during
        # the drain window — leaving the plan is what evacuates it.
        self._bins = [b for b in self._bins if b.uid != uid]
        survivors = [s for s in self._streams if s.name not in displaced_names]
        displaced = [s for s in self._streams if s.name in displaced_names]
        new_streams = survivors + displaced
        problem = self._formulate_incremental(new_streams)
        return self._replan(
            problem, new_streams, len(survivors), displaced_names
        )

    def _preemption_target(self, event: InstancePreempted) -> int | None:
        """Resolve which live instance a preemption event kills, if any.

        Explicit ``uid >= 0``: that instance, provided it is still alive
        (a stale interruption for a bin the fleet already closed is a
        no-op — replays race real clouds the same way).  Sampled
        (``uid = -1``): order the alive spot instances (open bins and
        warm spares with ``hazard > 0``) by uid and take slot
        ``int(draw * pool)``; a slot beyond the spot fleet misses, and
        with a ``hazard_ref`` the slotted victim is accepted with
        probability ``hazard / hazard_ref`` via the draw's fractional
        slot position — per-type thinning, so each spot type dies at its
        own catalog hazard (see `streams.InstancePreempted`).
        """
        alive = {b.uid: b.bin_type for b in self._bins}
        alive.update(self._spares)
        if event.uid >= 0:
            if event.uid in alive and (
                event.uid not in self.lifecycle
                or self.lifecycle.record(event.uid).terminated_at is None
            ):
                return event.uid
            if event.uid in self._noticed and event.uid in self.lifecycle:
                # Evacuated ahead of its announced kill: still draining,
                # so the reclamation lands on the ledger record.
                rec = self.lifecycle.record(event.uid)
                if rec.terminated_at is None or rec.terminated_at > self.now:
                    return event.uid
            return None
        spots = sorted(u for u, bt in alive.items() if bt.hazard > 0.0)
        scaled = event.draw * event.pool
        slot = int(scaled)
        if slot >= len(spots):
            return None
        uid = spots[slot]
        if event.hazard_ref > 0.0:
            frac = scaled - slot  # uniform [0,1), independent of the slot
            if frac * event.hazard_ref >= alive[uid].hazard:
                return None
        return uid

    def _noop_result(self) -> ReplanResult:
        assert self._plan is not None and self._problem is not None
        lb = self._lower_bound(self._problem)
        return ReplanResult(
            plan=self._plan,
            mode="noop",
            displaced=(),
            migrated=(),
            lower_bound=lb,
            gap=_gap(self._plan.hourly_cost, lb),
            nodes=0,
        )

    def _reprice(self, by_name: dict[str, BinType]) -> None:
        """Adopt a re-priced catalog into this controller's live state:
        bin states point at the new `BinType`s, the cached problem is
        re-formulated with cost-only tensor updates, and the dual prices
        are marked stale.  The refreshed plan keeps its placements but is
        no longer certified (``optimal=False``).  Live lifecycle records
        (open bins and held spares) re-price too — forward billing uses
        the new rent; already-billed quanta are not restated."""
        for b in self._bins:
            b.bin_type = by_name[b.bin_type.name]
        for rec in self.lifecycle.records():
            # DRAINING records (terminated_at scheduled past `now`) still
            # bill their remaining drain span — re-price them too.
            if (
                rec.terminated_at is None or rec.terminated_at > self.now
            ) and rec.instance_type in by_name:
                self.lifecycle.reprice(
                    rec.uid, self.now, by_name[rec.instance_type].billed_rent
                )
        self._spares = {
            uid: by_name.get(bt.name, bt) for uid, bt in self._spares.items()
        }
        if self._problem is None:
            return
        old_t = self._problem.tensors()
        problem = self.manager.formulate(self._streams, self.strategy)
        if "_tensors" not in problem.__dict__:
            new_costs = [bt.cost for bt in problem.bin_types]
            object.__setattr__(problem, "_tensors", old_t.with_costs(new_costs))
        self._problem = problem
        self._prices = None
        self._plan = self._assemble(problem, optimal=False)

    def _formulate_incremental(self, new_streams: list[StreamSpec]) -> Problem:
        """Formulate the new fleet, deriving tensors from the previous ones.

        `apply_events` keeps survivors in order and appends changed/new
        streams, so the new tensor stack is `drop_items(kept positions)`
        of the old one plus a `build` over just the appended tail.
        """
        problem = self.manager.formulate(new_streams, self.strategy)
        if "_tensors" in problem.__dict__ or self._problem is None:
            return problem
        old_pos = {s: i for i, s in enumerate(self._streams)}
        split = len(new_streams)
        for k, s in enumerate(new_streams):
            if s not in old_pos:
                split = k
                break
        kept = [old_pos[s] for s in new_streams[:split]]
        tail = new_streams[split:]
        if any(s in old_pos for s in tail):
            return problem  # unexpected order; fall back to a cold build
        derived = self._problem.tensors().drop_items(kept)
        if tail:
            fragment = Problem(
                bin_types=problem.bin_types,
                items=tuple(problem.items[split:]),
                utilization_cap=problem.utilization_cap,
            )
            derived = derived.append_items(fragment.tensors())
        object.__setattr__(problem, "_tensors", derived)
        return problem

    def _greedy_repair(
        self, sub_problem: Problem, pinned: list[OpenBin]
    ) -> tuple[list[tuple[int, int, int]], list[BinType]]:
        """FFD over displaced items with the pinned residuals pre-open.

        Fit + tightness for every (item, choice, bin) candidate comes from
        one `placement_scores` call (on the manager's device); new bins
        open by the FFD cost-density rule when nothing fits.
        """
        t = sub_problem.tensors()
        k = t.req.shape[0]
        if k == 0:
            return [], []
        heuristics._check_feasible(sub_problem, t)
        order, open_score = heuristics._pack_inputs(t)
        resid: list[np.ndarray] = [
            sub_problem.effective_capacity(ob.bin_type)
            - np.asarray(ob.load, dtype=np.float64)
            for ob in pinned
        ]
        # The full (item, choice, bin) candidate matrix scores in ONE
        # call; each placement then rescores only the touched bin's column
        # (and new bins append columns) in numpy.
        scores = (
            heuristics.placement_scores(
                t.req, t.choice_mask, np.asarray(resid),
                device=self.manager.device,
            )
            if resid
            else np.full((k, t.req.shape[1], 0), np.inf)
        )
        opened: list[BinType] = []
        placements: list[tuple[int, int, int]] = []
        for item_i in order.tolist():
            row = scores[item_i]  # (C, P)
            pos = int(row.argmin()) if row.size else 0
            if row.size and np.isfinite(row.ravel()[pos]):
                choice_i, bin_i = divmod(pos, row.shape[1])
                resid[bin_i] = resid[bin_i] - t.req[item_i, choice_i]
            else:
                pos = int(open_score[item_i].argmin())
                assert np.isfinite(open_score[item_i].ravel()[pos])
                bt_i, choice_i = divmod(pos, open_score.shape[2])
                bt = sub_problem.bin_types[bt_i]
                bin_i = len(resid)
                resid.append(
                    sub_problem.effective_capacity(bt) - t.req[item_i, choice_i]
                )
                opened.append(bt)
                scores = np.concatenate(
                    [scores, np.full((k, scores.shape[1], 1), np.inf)], axis=2
                )
            placements.append((item_i, choice_i, bin_i))
            scores[:, :, bin_i] = heuristics.placement_scores_np(
                t.req, t.choice_mask, resid[bin_i][None, :]
            )[:, :, 0]
        return placements, opened

    # ---------------------------------------------------------- state plumbing

    def _bin_load(
        self,
        b: _BinState,
        streams: Sequence[StreamSpec],
        by_name: dict[str, StreamSpec] | None = None,
    ) -> tuple[float, ...]:
        """Recompute a pinned bin's load from its members' profiles.

        Callers looping over many bins pass a prebuilt ``by_name`` index;
        rebuilding it per bin is O(fleet) each and dominated large-fleet
        re-plans."""
        if by_name is None:
            by_name = {s.name: s for s in streams}
        load = np.zeros(len(b.bin_type.capacity))
        for name, label in b.members.items():
            s = by_name[name]
            prof = self.manager.profiles.get(
                s.program.program_id, str(s.frame_size), label
            )
            assert prof is not None
            load += prof.at_fps(s.desired_fps)
        return tuple(load.tolist())

    def _uid_map(self) -> dict[str, int]:
        return {
            name: b.uid for b in self._bins for name in b.members
        }

    def _adopt_solution(
        self, problem: Problem, solution: Solution, *, match_old: bool
    ) -> None:
        """Rebuild bin states from a full-fleet solution.

        With `match_old`, bins identical to a previous bin (same type and
        member set) inherit its uid so unchanged instances don't count as
        migrations under a full re-solve.
        """
        old = (
            {
                (b.bin_type.name, frozenset(b.members.items())): b.uid
                for b in self._bins
            }
            if match_old
            else {}
        )
        bins: list[_BinState] = [
            _BinState(uid=-1, bin_type=b.bin_type, members={})
            for b in solution.bins
        ]
        for a in solution.assignments:
            item = problem.items[a.item_index]
            label = item.choices[a.choice_index].label
            bins[a.bin_index].members[item.name] = label
        for b in bins:
            key = (b.bin_type.name, frozenset(b.members.items()))
            b.uid = old.get(key, -1)
            if b.uid < 0:
                b.uid, b.bin_type = self._alloc_uid(b.bin_type)
        self._bins = bins

    def _adopt_pinned_solution(
        self,
        pinned_bins: list[_BinState],
        sub_problem: Problem,
        solution: Solution,
    ) -> None:
        """Fold a pinned sub-solve back into the bin states.

        `solution` is the augmented form from `pinned_solution`: bins
        ``0..P-1`` are the pinned bins (uids preserved), later bins are
        new instances; ghost-item assignments are skipped.
        """
        n_free = len(sub_problem.items)
        n_pinned = len(pinned_bins)
        bins = list(pinned_bins)
        for b in solution.bins[n_pinned:]:
            uid, bin_type = self._alloc_uid(b.bin_type)
            bins.append(_BinState(uid=uid, bin_type=bin_type, members={}))
        for a in solution.assignments:
            if a.item_index >= n_free:
                continue  # ghost (pinned load) item
            item = sub_problem.items[a.item_index]
            label = item.choices[a.choice_index].label
            bins[a.bin_index].members[item.name] = label
        self._bins = [b for b in bins if b.members]

    def _full_solution(
        self, problem: Problem, streams: Sequence[StreamSpec]
    ) -> Solution:
        """The current bin states as a full-fleet `Solution` of `problem`."""
        name_to_idx = {s.name: i for i, s in enumerate(streams)}
        placements: list[tuple[int, int, int]] = []
        opened: list[BinType] = []
        for bin_i, b in enumerate(self._bins):
            opened.append(b.bin_type)
            for name, label in b.members.items():
                i = name_to_idx[name]
                choice_i = next(
                    c
                    for c, ch in enumerate(problem.items[i].choices)
                    if ch.label == label
                )
                placements.append((i, choice_i, bin_i))
        return build_solution(problem, placements, opened)

    def _assemble(self, problem: Problem, *, optimal: bool) -> AllocationPlan:
        """Current bin states -> validated `AllocationPlan`."""
        self._bins = [b for b in self._bins if b.members]
        streams = self._streams
        solution = self._full_solution(problem, streams)
        by_name = {s.name: s for s in streams}
        placements = tuple(
            PlacedStream(
                stream=by_name[problem.items[a.item_index].name],
                instance_index=a.bin_index,
                instance_type=solution.bins[a.bin_index].bin_type.name,
                device=problem.items[a.item_index]
                .choices[a.choice_index]
                .label,
            )
            for a in solution.assignments
        )
        return AllocationPlan(
            strategy=self.strategy.name,
            instances=tuple(b.bin_type.name for b in solution.bins),
            placements=placements,
            hourly_cost=solution.cost,
            optimal=optimal,
            solution=solution,
        )

    def _refresh_prices(self, problem: Problem) -> None:
        try:
            self._prices, _ = class_prices(
                problem, self._colgen_pool, device=self.manager.device
            )
        except KernelError:
            # A kernel that fails to build or launch, or a missing card,
            # is not a pricing blow-up: it surfaces.
            raise
        except Exception:  # pricing blow-up etc.: density bound still holds
            self._prices = {}

    def _lower_bound(self, problem: Problem) -> float:
        """Certified LB: class dual prices maxed with the density bound."""
        if self._prices is None:
            self._refresh_prices(problem)
        lb = bincompletion.root_lower_bound(problem)
        if self._prices:
            keys = arcflow.item_class_keys(problem)
            lb = max(lb, sum(self._prices.get(key, 0.0) for key in keys))
        return lb


#: Above this many item classes, arc-flow's capacity-maximal pattern
#: enumeration (the price of churn-safe duals) explodes combinatorially;
#: colgen prices the same LP by generating columns on demand instead.
_COLGEN_CLASS_CUTOFF = 8


def class_prices(
    problem: Problem, colgen_pool=None, *, device=None
) -> tuple[dict[bytes, float], float]:
    """Churn-safe per-class dual prices, routed by class count.

    Few classes: `arcflow.dual_prices` (exact pattern enumeration).  Many
    classes: `colgen.dual_prices` with a warm column pool — budgeted, but
    its Farley-scaled duals satisfy the same admissibility contract
    (``pattern · y <= pattern cost`` for every packing over the catalog),
    so callers can swap them freely.  Its pricing DP runs on ``device``
    (default: the card).
    """
    n_classes = len(arcflow.group_items(problem)[0])
    if n_classes > _COLGEN_CLASS_CUTOFF:
        from .binpack import colgen

        return colgen.dual_prices(
            problem, colgen_pool, max_rounds=12, exact_budget=10_000,
            device=device,
        )
    return arcflow.dual_prices(problem)


def _gap(cost: float, lb: float) -> float:
    if lb <= _EPS:
        return 0.0 if cost <= _EPS else float("inf")
    return max(0.0, (cost - lb) / lb)
