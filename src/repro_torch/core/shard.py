"""Hierarchical sharded controller: cells of warm-start `FleetController`s.

One flat MC-VBP solve tops out around n=500 even with warm-start
incremental re-planning; camera-network scale (the paper frames
*millions* of streams) needs partitioning.  `ShardedController`
partitions the fleet into **cells** by a pluggable key (region, tenant,
stream class — any `StreamSpec -> hashable`), runs the existing
warm-start `FleetController` per cell, and routes each `FleetEvent` to
the one cell that owns it, so a churn step costs O(cell) instead of
O(fleet) no matter how large the fleet grows.

Three mechanisms make the hierarchy more than a dict of controllers:

* **Batched cold packing / defrag** — `reset(pack="batched")` and
  `repack()` push *every* cell's fleet through ONE launch of the FFD/BFD
  scan kernel (`heuristics.batched_pack`, ``pack_scan``, one warp a
  cell): cells are embarrassingly parallel, so N per-cell heuristic
  passes collapse into a single padded-tensor kernel call.  Exact pinned
  sub-solves stay per-cell and only fire for displaced streams, exactly
  as in the flat controller.
* **Cross-cell rebalancing market** — each cell exports its covering-LP
  dual prices (`arcflow.dual_prices`, churn-reusable); `rebalance()`
  migrates streams whose class is dual-expensive at home toward cells
  that price it cheap.  Every move is *transactional*: both touched
  cells are snapshotted, the move replays as a certified remove+add, and
  anything but a strict realized saving rolls both cells back — total
  certified cost never rises.
* **Disjoint uid strides** — each cell's instance uids live in their own
  `UID_STRIDE` range, so the merged ledger/plan facade resolves any uid
  to its owning cell arithmetically and global preemption sampling
  degenerates to the flat controller's exact semantics at one cell.

With the default single-cell key the controller is bit-identical to a
flat `FleetController` (routed results are returned unmodified); the
sharded machinery only engages when a key actually partitions.

## Where it runs

The device work — the batched pack scan, the batched certification's
knapsack pricing (`colgen.batched_dual_prices`) and, through each cell's
`FleetController`, the repair's placement scores — runs on the manager's
``device`` (the card unless the manager was given ``device="cpu"``).
Pricing's catch-alls (the batched certification falling back to the
serial per-cell loop, a cell exporting no prices, a rebalance move rolled
back) keep the reference's behaviour for every error but
`device.KernelError`: a kernel that fails to build or launch, or a
missing card, surfaces instead of going on on the host.
"""
from __future__ import annotations

import copy
import dataclasses
import zlib
from typing import Callable, Hashable, Sequence

from ..device import KernelError
from .binpack import arcflow, colgen, heuristics
from .binpack.problem import Problem, Solution
from .binpack.colgen import ColumnPool
from .controller import FleetController, ReplanResult, _gap, class_prices
from .lifecycle import BillingModel, LifecycleEngine
from .manager import AllocationPlan, PlacedStream
from .strategies import ST3, Strategy
from .streams import (
    FleetEvent,
    InstancePreempted,
    InstancePreemptionNotice,
    PriceChanged,
    StreamAdded,
    StreamRemoved,
    StreamSpec,
)

__all__ = [
    "ShardedController",
    "UID_STRIDE",
    "single_cell",
    "hash_cells",
    "cells_by_program",
]

_EPS = 1e-9

#: Each cell's instance uids start at ``cell_index * UID_STRIDE`` —
#: disjoint ranges, so ``uid // UID_STRIDE`` resolves the owning cell.
UID_STRIDE = 1_000_000


# ------------------------------------------------------------------ cell keys


def single_cell(stream: StreamSpec) -> int:
    """The degenerate key: every stream in cell 0 (flat-identical)."""
    return 0


def hash_cells(n: int) -> Callable[[StreamSpec], int]:
    """Partition by a stable name hash into ``n`` cells.

    crc32, not the builtin ``hash`` — deterministic across processes, so
    replays and re-keys always produce the same partition.
    """
    if n < 1:
        raise ValueError(f"hash_cells needs n >= 1, got {n}")

    def key(stream: StreamSpec) -> int:
        return zlib.crc32(stream.name.encode()) % n

    return key


def cells_by_program(stream: StreamSpec) -> str:
    """Partition by analysis program (the paper's workload classes)."""
    return stream.program.program_id


# ------------------------------------------------------------- merged facades


class _Counter:
    """A restorable uid counter (`itertools.count` hides its cursor, and
    the rebalance snapshot/rollback needs to read and restore it)."""

    __slots__ = ("value",)

    def __init__(self, start: int) -> None:
        self.value = start

    def __next__(self) -> int:
        v = self.value
        self.value += 1
        return v


class _MergedLedger:
    """Read-only union of every cell's lifecycle ledger.

    Uids dispatch to their owning cell by stride range; aggregate queries
    (`records`, `billed_cost`, `alive`) concatenate/sum across cells.  A
    live view — cells created mid-replay appear automatically.

    Aggregates used to re-walk every cell engine per query; now the
    uid-stride -> engine map is cached, and per-cell query results are
    memoized against each engine's monotone ``version`` counter, so a
    query after one cell churned recomputes only that cell.  The owner
    calls `invalidate()` whenever an engine is *replaced* (cold adopt,
    rebalance rollback) rather than mutated — version counters cannot
    see an identity swap.
    """

    def __init__(self, owner: "ShardedController") -> None:
        self._owner = owner
        self._engines: list[LifecycleEngine] | None = None
        # per-cell memos: key -> (engine version at compute time, value)
        self._cost_memo: dict[tuple[int, float], tuple[int, float]] = {}
        self._alive_memo: dict[tuple[int, float], tuple[int, tuple]] = {}
        self._records_memo: dict[int, tuple[int, tuple]] = {}

    def invalidate(self) -> None:
        """Drop the engine map and memos (cell engines were replaced)."""
        self._engines = None
        self._cost_memo.clear()
        self._alive_memo.clear()
        self._records_memo.clear()

    def _engine_list(self) -> list[LifecycleEngine]:
        eng = self._engines
        if eng is None or len(eng) != len(self._owner._cell_list):
            eng = self._engines = [
                c.lifecycle for c in self._owner._cell_list
            ]
            self._cost_memo.clear()
            self._alive_memo.clear()
            self._records_memo.clear()
        return eng

    def _engine(self, uid: int) -> LifecycleEngine | None:
        engines = self._engine_list()
        i = uid // UID_STRIDE
        if 0 <= i < len(engines):
            return engines[i]
        return None

    def __contains__(self, uid: int) -> bool:
        eng = self._engine(uid)
        return eng is not None and uid in eng

    def record(self, uid: int):
        eng = self._engine(uid)
        if eng is None:
            raise KeyError(f"no instance with uid {uid}")
        return eng.record(uid)

    def records(self) -> tuple:
        out: list = []
        for i, eng in enumerate(self._engine_list()):
            hit = self._records_memo.get(i)
            if hit is None or hit[0] != eng.version:
                hit = (eng.version, eng.records())
                self._records_memo[i] = hit
            out.extend(hit[1])
        return tuple(out)

    def billed_cost(self, until: float) -> float:
        total = 0.0
        for i, eng in enumerate(self._engine_list()):
            key = (i, until)
            hit = self._cost_memo.get(key)
            if hit is None or hit[0] != eng.version:
                hit = (eng.version, eng.billed_cost(until))
                self._cost_memo[key] = hit
            total += hit[1]
        return total

    def billed_instance(self, uid: int, until: float) -> float:
        eng = self._engine(uid)
        if eng is None:
            raise KeyError(f"no instance with uid {uid}")
        return eng.billed_instance(uid, until)

    def alive(self, at: float) -> tuple[int, ...]:
        out: list = []
        for i, eng in enumerate(self._engine_list()):
            key = (i, at)
            hit = self._alive_memo.get(key)
            if hit is None or hit[0] != eng.version:
                hit = (eng.version, eng.alive(at))
                self._alive_memo[key] = hit
            out.extend(hit[1])
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class _MergedSolution:
    """Concatenated per-cell open bins; quacks like `Solution` for every
    downstream reader (`bins`, `cost` — the simulator and benchmarks read
    nothing else off a plan's solution)."""

    bins: tuple
    cost: float


# --------------------------------------------------------------- the controller


class ShardedController:
    """Partitioned fleet of warm-start `FleetController` cells.

    Mirrors the `FleetController` surface the simulator and policies
    consume (`reset` / `apply` / `fleet` / `plan` / `parked` /
    `degraded_rungs` / `instance_uids` / `lifecycle`), so
    `simulate_churn` replays a sharded fleet unchanged.  Per-cell
    policies come from ``policy_factory`` (policies are stateful, so each
    cell needs its own instance); autoscaler spares are therefore
    cell-local by construction.

    Routing: a stream joins the cell ``cell_key(spec)`` names and stays
    there for life (rebalance moves excepted) — later events resolve
    through the name->cell map, so a key that reads mutable fields
    (e.g. the rate) never strands a stream.  `rekey` repartitions the
    live fleet under a new key with a cold (batched) solve.
    """

    def __init__(
        self,
        manager,
        strategy: Strategy = ST3,
        *,
        cell_key: Callable[[StreamSpec], Hashable] | None = None,
        gap_threshold: float = 0.1,
        sub_max_nodes: int = 50_000,
        policy_factory: Callable[[], object] | None = None,
        billing: BillingModel | None = None,
        billing_by_type: dict[str, BillingModel] | None = None,
        drain_on_notice: bool = True,
        rebalance_every: int = 0,
        rebalance_moves: int = 4,
        rebalance_min_saving: float = 0.0,
        batch_workers: int = 0,
    ) -> None:
        self.manager = manager
        self.strategy = strategy
        self.cell_key = cell_key if cell_key is not None else single_cell
        self.gap_threshold = gap_threshold
        self.sub_max_nodes = sub_max_nodes
        self.policy_factory = policy_factory
        self.billing = billing
        self.billing_by_type = billing_by_type
        self.drain_on_notice = drain_on_notice
        #: Run the cross-cell rebalancing market every N applied events
        #: (0 = only when `rebalance()` is called explicitly).
        self.rebalance_every = rebalance_every
        self.rebalance_moves = rebalance_moves
        self.rebalance_min_saving = rebalance_min_saving
        #: Thread-pool width for fanning independent cell folds out in
        #: `apply_events` (0/1 = sequential).  The fold is bit-identical
        #: either way for arcflow-priced cells; pool-sharing colgen
        #: cells may discover columns in a different order.
        self.batch_workers = batch_workers
        self.now = 0.0
        self._cells: dict[Hashable, FleetController] = {}
        self._cell_list: list[FleetController] = []  # creation order = stride
        self._cell_of: dict[str, Hashable] = {}  # stream/parked name -> key
        self._notice_cell: dict[int, Hashable | None] = {}
        self._last_lb: dict[Hashable, float] = {}
        self._seg_cache: dict = {}  # key -> (plan, offset, shifted placements)
        self._events_since_rebalance = 0
        # ONE branch-and-price column pool for the whole shard: every
        # cell prices over the same catalog, so columns one cell
        # generates warm-start every other cell's master LP (and the
        # manager's full re-solve fallback).
        self._colgen_pool: ColumnPool = (
            getattr(manager, "colgen_pool", None) or ColumnPool()
        )
        if hasattr(manager, "colgen_pool"):
            manager.colgen_pool = self._colgen_pool
        self.lifecycle = _MergedLedger(self)
        # Observability counters, exposed via `stats()`.
        self._stats: dict = {
            "events_routed": 0,
            "events_per_cell": {},
            "event_batches": 0,
            "batch_barriers": 0,
            "seg_cache_hits": 0,
            "seg_cache_misses": 0,
            "batched_repair_dispatches": 0,
            "serial_repair_dispatches": 0,
            "pricing_dispatches": 0,
            "pricing_rounds": 0,
            "serial_price_refreshes": 0,
        }

    # ------------------------------------------------------------ properties

    @property
    def cells(self) -> dict[Hashable, FleetController]:
        """The live cells (key -> controller), a copy."""
        return dict(self._cells)

    @property
    def n_cells(self) -> int:
        return len(self._cells)

    @property
    def fleet(self) -> tuple[StreamSpec, ...]:
        out: list[StreamSpec] = []
        for c in self._cells.values():
            out.extend(c.fleet)
        return tuple(out)

    @property
    def parked(self) -> dict[str, StreamSpec]:
        out: dict[str, StreamSpec] = {}
        for c in self._cells.values():
            out.update(c.parked)
        return out

    @property
    def degraded_rungs(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for c in self._cells.values():
            out.update(c.degraded_rungs)
        return out

    @property
    def instance_uids(self) -> tuple[int, ...]:
        out: list[int] = []
        for c in self._cells.values():
            out.extend(c.instance_uids)
        return tuple(out)

    @property
    def spares(self) -> dict[int, object]:
        out: dict[int, object] = {}
        for c in self._cells.values():
            out.update(c.spares)
        return out

    @property
    def plan(self) -> AllocationPlan | None:
        if not self._cells:
            return None
        if len(self._cells) == 1:
            return next(iter(self._cells.values())).plan
        return self._merged_plan()

    def cell_of(self, name: str) -> Hashable:
        """The cell currently hosting stream ``name`` (KeyError if none)."""
        return self._cell_of[name]

    # ------------------------------------------------------------------- API

    def reset(
        self,
        streams: Sequence[StreamSpec],
        *,
        at: float | None = None,
        pack: str = "exact",
    ) -> ReplanResult:
        """Partition ``streams`` into cells and cold-start every cell.

        ``pack="exact"`` runs each cell's ordinary `FleetController.reset`
        (per-cell exact/budgeted solve — the flat path, bit-identical at
        one cell).  ``pack="batched"`` instead packs ALL cells through one
        FFD scan launch (`heuristics.batched_pack`) and adopts
        the per-cell heuristic solutions directly — the only way to
        cold-start tens of thousands of streams in seconds.
        """
        if pack not in ("exact", "batched"):
            raise ValueError(f"pack must be 'exact' or 'batched', got {pack!r}")
        if at is not None:
            self.now = at
        parts: dict[Hashable, list[StreamSpec]] = {}
        for s in streams:
            parts.setdefault(self.cell_key(s), []).append(s)
        self._cells = {}
        self._cell_list = []
        self._cell_of = {}
        self._notice_cell = {}
        self._last_lb = {}
        self._seg_cache = {}
        self._events_since_rebalance = 0
        self.lifecycle.invalidate()
        for key, part in parts.items():
            self._new_cell(key)
            for s in part:
                self._cell_of[s.name] = key
        if pack == "batched" and parts:
            results = self._batched_reset(parts)
        else:
            results = {
                key: self._cells[key].reset(part, at=self.now)
                for key, part in parts.items()
            }
        for key, r in results.items():
            self._last_lb[key] = r.lower_bound
        if len(results) == 1:
            return next(iter(results.values()))
        displaced = tuple(sorted(s.name for s in streams))
        return self._result(
            mode="reset",
            displaced=displaced,
            nodes=sum(r.nodes for r in results.values()),
        )

    def recalibrate(self, artifact=None, *, pack: str = "exact") -> ReplanResult:
        """Sharded analogue of `FleetController.recalibrate`.

        Installs ``artifact`` on the shared manager (all cells formulate
        through it), then cold-starts every cell on the standing fleet at
        the current clock.  ``pack="batched"`` re-packs all cells through
        the one-launch scan — the practical choice at 10k+ streams.
        """
        if artifact is not None:
            self.manager.set_calibration(artifact)
        else:
            self.manager._formulate_cache.clear()
        return self.reset(self.fleet, pack=pack)

    def apply(self, event: FleetEvent) -> ReplanResult:
        """Route one fleet event to its cell and fold it in.

        Stream events go to the owning cell (joins create cells lazily);
        price moves broadcast (the catalog is shared, re-pricing is
        idempotent, and every cell must refresh its plan); sampled
        preemption shocks resolve *globally* against the merged alive
        spot fleet before forwarding an explicit-uid event to the owner
        cell — at one cell this reproduces the flat controller's
        semantics draw for draw.
        """
        if not self._cells:
            raise RuntimeError("ShardedController.apply before reset()")
        self.now = max(self.now, event.at)
        self._stats["events_routed"] += 1
        if isinstance(event, PriceChanged):
            result = self._broadcast_price(event)
        elif isinstance(event, (InstancePreempted, InstancePreemptionNotice)):
            result = self._route_instance_event(event)
        else:
            result = self._route_stream_event(event)
        self._events_since_rebalance += 1
        if (
            self.rebalance_every
            and len(self._cells) > 1
            and self._events_since_rebalance >= self.rebalance_every
        ):
            self._events_since_rebalance = 0
            actions = self.rebalance(
                max_moves=self.rebalance_moves,
                min_saving=self.rebalance_min_saving,
            )
            if actions:
                result = self._result(
                    mode=result.mode,
                    displaced=result.displaced,
                    migrated=result.migrated,
                    nodes=result.nodes,
                    actions=result.actions + tuple(actions),
                    advice=result.advice,
                )
        return result

    def apply_events(
        self,
        events: Sequence[FleetEvent],
        *,
        batched: bool = True,
        with_snapshots: bool = False,
    ):
        """Fold a batch of fleet events through the batched pipeline.

        The serial loop (``batched=False``) is ``[self.apply(ev) for ev
        in events]`` — every event pays an O(fleet) merged-plan rebuild.
        The batched pipeline instead splits the batch into **runs** of
        independently-routable events: classification walks the batch in
        order doing exactly `apply`'s routing (advancing the clock,
        creating cells, updating the name->cell and notice maps), but
        only QUEUES each event on its owning cell.  Each cell then folds
        its queue through its warm controller back-to-back (optionally
        across a thread pool, ``batch_workers``), and reconstruction
        re-emits one `ReplanResult` per event in original order with the
        merged plan materialized LAZILY — segment concatenation is paid
        once per accessed plan instead of once per event.

        Events that genuinely couple cells force a **barrier** (flush
        the run, then fold eagerly through `apply`): `PriceChanged`
        broadcasts, sampled preemption shocks (uid < 0, resolved against
        the merged alive fleet), events referencing a stream removed
        earlier in the same run (its parked-vs-gone routing is unknown
        until the fold), and rebalance-market trigger points.

        Results are bit-identical to the serial loop wherever per-cell
        pricing is pure (cells at or under the arcflow class cutoff);
        cells pricing through the SHARED colgen column pool may see
        different — equally admissible — lower bounds, because folding
        order changes pool discovery order.

        ``with_snapshots=True`` additionally returns, per event, the
        merged post-event facade state the simulator replays
        (``{"uids", "rungs", "parked", "tiers"}``) as a second list.
        """
        events = list(events)
        if not events:
            return ([], []) if with_snapshots else []
        if not batched:
            if not with_snapshots:
                return [self.apply(ev) for ev in events]
            results = []
            snaps = []
            for ev in events:
                results.append(self.apply(ev))
                snaps.append(self._global_snapshot())
            return results, snaps
        if not self._cells:
            raise RuntimeError("ShardedController.apply before reset()")
        self._stats["event_batches"] += 1
        results: list[ReplanResult | None] = [None] * len(events)
        snaps: list[dict | None] | None = (
            [None] * len(events) if with_snapshots else None
        )
        run: _BatchRun | None = None
        for j, event in enumerate(events):
            if isinstance(event, StreamAdded):
                name = event.stream.name
            elif isinstance(
                event, (PriceChanged, InstancePreempted, InstancePreemptionNotice)
            ):
                name = None
            else:
                name = getattr(event, "name", None)
            sampled = (
                isinstance(
                    event, (InstancePreempted, InstancePreemptionNotice)
                )
                and event.uid < 0
                and not (
                    isinstance(event, InstancePreempted)
                    and event.notice_id >= 0
                )
            )
            barrier = (
                isinstance(event, PriceChanged)
                or sampled
                or (name is not None and run is not None and name in run.dirty)
                or (
                    self.rebalance_every
                    and self._events_since_rebalance + 1
                    >= self.rebalance_every
                )
            )
            if barrier:
                if run is not None:
                    self._fold_run(run, results, snaps)
                    run = None
                self._stats["batch_barriers"] += 1
                results[j] = self.apply(event)
                if snaps is not None:
                    snaps[j] = self._global_snapshot()
                continue
            if run is None:
                run = _BatchRun(self, with_snapshots)
            # -- classification: apply()'s routing, state updates only --
            self.now = max(self.now, event.at)
            self._stats["events_routed"] += 1
            self._events_since_rebalance += 1
            if isinstance(
                event, (InstancePreempted, InstancePreemptionNotice)
            ):
                is_notice = isinstance(event, InstancePreemptionNotice)
                if not is_notice and event.notice_id >= 0:
                    key = self._notice_cell.pop(event.notice_id, None)
                    if key is None:
                        run.noop(j, self.now)
                    else:
                        run.push(j, key, ("apply", event), self.now)
                    continue
                i = event.uid // UID_STRIDE
                if not 0 <= i < len(self._cell_list):
                    run.noop(j, self.now)
                    continue
                key = next(
                    k
                    for k, c in self._cells.items()
                    if c is self._cell_list[i]
                )
                if is_notice and event.notice_id >= 0:
                    self._notice_cell[event.notice_id] = key
                run.push(j, key, ("apply", event), self.now)
                continue
            if isinstance(event, StreamAdded):
                key = self._cell_of.get(name)
                if key is None:
                    key = self.cell_key(event.stream)
                    if key not in self._cells:
                        self._new_cell(key)
                        self._cell_of[name] = key
                        run.push(
                            j, key, ("reset", event.stream, self.now), self.now
                        )
                        continue
                self._cell_of[name] = key
                run.push(j, key, ("apply", event), self.now)
                continue
            key = self._cell_of.get(name)
            if key is None:
                if len(self._cells) == 1:
                    key = next(iter(self._cells))
                else:
                    run.noop(j, self.now)
                    continue
            if isinstance(event, StreamRemoved):
                run.dirty.add(name)
            run.push(j, key, ("apply", event), self.now)
        if run is not None:
            self._fold_run(run, results, snaps)
        if with_snapshots:
            return results, snaps
        return results

    def repack(self, *, best_fit: bool = False) -> ReplanResult:
        """Defragment every cell in ONE batched kernel launch.

        All cells' fleets go through a single launch of the FFD/BFD pack
        scan; each cell adopts its repacked solution only when it
        is strictly cheaper than the incumbent plan (uids of unchanged
        bins survive via `match_old`, so stable instances don't re-bill).
        The sharded analogue of a consolidation sweep — N serial re-packs
        collapse into one launch.
        """
        live = [
            (key, c)
            for key, c in self._cells.items()
            if c._problem is not None and c._streams
        ]
        if not live:
            return self._result(mode="noop")
        sols = heuristics.batched_pack(
            [c._problem for _, c in live],
            best_fit=best_fit,
            device=self.manager.device,
        )
        self._stats["batched_repair_dispatches"] += 1
        actions: list[str] = []
        migrated: list[str] = []
        for (key, c), sol in zip(live, sols):
            assert c._plan is not None
            before = c._plan.hourly_cost
            if sol.cost >= before - _EPS:
                continue
            old_uid = {n: b.uid for b in c._bins for n in b.members}
            c._adopt_solution(c._problem, sol, match_old=True)
            c._plan = c._assemble(c._problem, optimal=False)
            c._sync_lifecycle()
            migrated.extend(
                n
                for b in c._bins
                for n in b.members
                if n in old_uid and b.uid != old_uid[n]
            )
            actions.append(f"repack:{key}:-${before - sol.cost:.4f}")
        return self._result(
            mode="warm" if actions else "noop",
            migrated=tuple(sorted(migrated)),
            actions=tuple(actions),
        )

    def rekey(
        self, cell_key: Callable[[StreamSpec], Hashable], *, pack: str = "exact"
    ) -> ReplanResult:
        """Repartition the live fleet under a new cell key (cold restart).

        Streams are re-homed by the new key from a canonical (name-sorted)
        order, so the partition — and therefore all subsequent routing —
        depends only on the fleet's membership and the key, never on the
        event history that built it.  Parked streams and warm spares are
        discarded with the old cells (a rekey is a fleet-era boundary,
        like `reset`).
        """
        streams = sorted(self.fleet, key=lambda s: s.name)
        self.cell_key = cell_key
        return self.reset(streams, at=self.now, pack=pack)

    def rebalance(
        self, *, max_moves: int = 4, min_saving: float = 0.0
    ) -> list[str]:
        """The cross-cell market: migrate streams toward dual-cheap cells.

        Every live cell exports its covering-LP dual prices; a stream
        whose item class is priced high at home and low elsewhere is a
        candidate to move.  Each candidate move replays as a
        remove+add across a full snapshot of both cells and commits only
        on a strict realized saving (beyond ``min_saving``) — otherwise
        both cells roll back bit-for-bit, so the total certified cost of
        the sharded fleet never rises.  Returns the committed moves'
        action strings.
        """
        live = [
            (key, c)
            for key, c in self._cells.items()
            if c._problem is not None and c._streams
        ]
        if len(live) < 2 or max_moves <= 0:
            return []
        prices: dict[Hashable, dict[bytes, float]] = {}
        quotes = self._batched_prices([c._problem for _, c in live])
        if quotes is not None:
            for (key, _c), (p, _lp) in zip(live, quotes):
                prices[key] = p
        else:
            for key, c in live:
                try:
                    prices[key], _ = class_prices(
                        c._problem, self._colgen_pool, device=self.manager.device
                    )
                    self._stats["serial_price_refreshes"] += 1
                except KernelError:  # a failed kernel or no card surfaces
                    raise
                except Exception:  # pricing blow-up: cell exports nothing
                    prices[key] = {}
        cands: list[tuple[float, str, Hashable, Hashable]] = []
        for key, c in live:
            class_keys = arcflow.item_class_keys(c._problem)
            skip = set(c._nominal) | set(c._degraded)
            for item, ck in zip(c._problem.items, class_keys):
                if item.name in skip:  # degraded contracts don't travel
                    continue
                home = prices[key].get(ck, 0.0)
                if home <= _EPS:
                    continue
                best_key, best_price = None, home
                for other, _ in live:
                    if other == key:
                        continue
                    p = prices[other].get(ck, 0.0)
                    if p < best_price - _EPS:
                        best_key, best_price = other, p
                if best_key is not None:
                    cands.append((-(home - best_price), item.name, key, best_key))
        cands.sort(key=lambda t: (t[0], t[1]))
        actions: list[str] = []
        for _neg_delta, name, src, dst in cands:
            if len(actions) >= max_moves:
                break
            act = self._try_move(name, src, dst, min_saving=min_saving)
            if act is not None:
                actions.append(act)
        return actions

    def total_cost(self) -> float:
        """Current total hourly cost across all cells."""
        return sum(
            c._plan.hourly_cost
            for c in self._cells.values()
            if c._plan is not None
        )

    def refresh_prices(self, *, batched: bool = True) -> float:
        """Refresh every cell's dual prices; return the summed LB.

        With ``batched=True`` (the default) and more than one live cell,
        all cells' class duals come from ONE column-generation run whose
        pricing subproblems are stacked into single
        `kernels.knapsack.price_knapsacks` dispatches
        (`colgen.batched_dual_prices`) — the one-dispatch certification
        path.  ``batched=False`` (or a single cell) keeps the serial
        per-cell `FleetController.refresh_prices` loop.
        """
        live = [
            (key, c)
            for key, c in self._cells.items()
            if c._problem is not None
        ]
        if batched and len(live) > 1:
            quotes = self._batched_prices([c._problem for _, c in live])
            if quotes is not None:
                total = 0.0
                for (key, c), (prices, _lp) in zip(live, quotes):
                    lb = c.install_prices(prices)
                    self._last_lb[key] = lb
                    total += lb
                return total
        total = 0.0
        for key, c in live:
            lb = c.refresh_prices()
            self._stats["serial_price_refreshes"] += 1
            self._last_lb[key] = lb
            total += lb
        return total

    def stats(self) -> dict:
        """Observability counters (a copy): event routing, merged-plan
        segment-cache hits/misses, batched vs serial repair dispatches,
        and pricing-dispatch counts."""
        out = dict(self._stats)
        out["events_per_cell"] = dict(self._stats["events_per_cell"])
        return out

    # ------------------------------------------------------ batched pipeline

    def _fold_run(
        self,
        run: "_BatchRun",
        results: list,
        snaps: list | None,
    ) -> None:
        """Fold one run's queued per-cell ops, then reconstruct per-event
        results (and optional facade snapshots) in original event order."""
        keys = list(run.ops)
        pops: list[str] = []  # removed-and-not-parked names, popped post-join

        def fold_cell(key: Hashable) -> list[tuple]:
            c = self._cells[key]
            out = []
            for op in run.ops[key]:
                if op[0] == "reset":
                    r = c.reset([op[1]], at=op[2])
                else:
                    ev = op[1]
                    r = c.apply(ev)
                    if (
                        isinstance(ev, StreamRemoved)
                        and ev.name not in c.parked
                    ):
                        pops.append(ev.name)
                opsnap = None
                if snaps is not None:
                    tiers = {s.name: s.tier for s in c.fleet}
                    for s in c.parked.values():
                        tiers[s.name] = s.tier
                    opsnap = (
                        c.instance_uids,
                        dict(c.degraded_rungs),
                        dict(c.parked),
                        tiers,
                    )
                out.append((r, c.plan, opsnap))
            return out

        captures: dict[Hashable, list[tuple]] = {}
        workers = min(self.batch_workers, len(keys))
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as ex:
                for key, out in zip(keys, ex.map(fold_cell, keys)):
                    captures[key] = out
        else:
            for key in keys:
                captures[key] = fold_cell(key)
        for name in pops:
            self._cell_of.pop(name, None)
        per_cell = self._stats["events_per_cell"]
        for key in keys:
            n_ops = len(run.ops[key])
            per_cell[key] = per_cell.get(key, 0) + n_ops
            self._stats["serial_repair_dispatches"] += n_ops

        # ---- reconstruction: replay descriptors in event order --------
        cur_plan = dict(run.base_plans)
        cur_lb = dict(run.base_lb)
        cur_uids = dict(run.base_uids) if snaps is not None else None
        cur_rungs = dict(run.base_rungs) if snaps is not None else None
        cur_parked = dict(run.base_parked) if snaps is not None else None
        iters = {key: iter(captures[key]) for key in keys}
        for desc in run.descs:
            if desc[0] == "cell":
                _kind, j, key, now_j, n_at = desc
                r, plan_after, opsnap = next(iters[key])
                cur_plan[key] = plan_after
                cur_lb[key] = r.lower_bound
                tiers_j: dict = {}
                if snaps is not None:
                    cur_uids[key] = opsnap[0]
                    cur_rungs[key] = opsnap[1]
                    cur_parked[key] = opsnap[2]
                    tiers_j = opsnap[3]
                if n_at == 1:
                    results[j] = r
                else:
                    results[j] = self._recon_result(
                        cur_plan, cur_lb, now_j,
                        mode=r.mode, displaced=r.displaced,
                        migrated=r.migrated, nodes=r.nodes,
                        actions=r.actions, advice=r.advice,
                    )
            else:
                _kind, j, now_j = desc
                tiers_j = {}
                results[j] = self._recon_result(
                    cur_plan, cur_lb, now_j, mode="noop",
                )
            if snaps is not None:
                uids: list[int] = []
                for t in cur_uids.values():
                    uids.extend(t)
                rungs: dict[str, int] = {}
                for d in cur_rungs.values():
                    rungs.update(d)
                parked: dict[str, StreamSpec] = {}
                for d in cur_parked.values():
                    parked.update(d)
                snaps[j] = {
                    "uids": tuple(uids),
                    "rungs": rungs,
                    "parked": parked,
                    "tiers": tiers_j,
                }
        # The reconstruction dict has serial's exact key-insertion order
        # (new cells enter at their creation event) — adopt it, so later
        # float sums over `_last_lb.values()` match serial bit-for-bit.
        self._last_lb = cur_lb

    def _recon_result(
        self,
        cur_plan: dict,
        cur_lb: dict,
        now_j: float,
        *,
        mode: str,
        displaced: tuple[str, ...] = (),
        migrated: tuple[str, ...] = (),
        nodes: int = 0,
        actions: tuple[str, ...] = (),
        advice: dict | None = None,
    ) -> ReplanResult:
        """A merged `ReplanResult` for one mid-batch event, with the
        plan's content deferred (`_LazyMergedPlan`) — cost and LB are
        accumulated in the exact dict order `_merged_plan`/`_result`
        would use, so the numbers are bit-identical to the serial path."""
        segs = tuple(cur_plan.items())
        cost = 0.0
        for _key, plan in segs:
            if plan is None or not plan.instances:
                continue
            cost += plan.hourly_cost
        lb = sum(cur_lb.values())
        return ReplanResult(
            plan=_LazyMergedPlan(self, segs, cost),
            mode=mode,
            displaced=displaced,
            migrated=migrated,
            lower_bound=lb,
            gap=_gap(cost, lb),
            nodes=nodes,
            actions=actions,
            advice=advice,
            at=now_j,
        )

    def _global_snapshot(self) -> dict:
        """The merged facade state a serial replay reads after an event."""
        tiers = {s.name: s.tier for s in self.fleet}
        for s in self.parked.values():
            tiers[s.name] = s.tier
        return {
            "uids": self.instance_uids,
            "rungs": dict(self.degraded_rungs),
            "parked": dict(self.parked),
            "tiers": tiers,
        }

    # ------------------------------------------------------------- internals

    def _batched_prices(
        self, problems: list[Problem]
    ) -> list[tuple[dict[bytes, float], float]] | None:
        """All cells' admissible class duals from one stacked pricing run.

        Returns None after a pricing blow-up, so callers fall back to the
        serial per-cell loop (mixed catalogs take the serial path inside
        `colgen.batched_dual_prices` itself).  A `KernelError` — a kernel
        that fails to build or launch, or no card — propagates.
        """
        try:
            return colgen.batched_dual_prices(
                problems,
                self._colgen_pool,
                device=self.manager.device,
                stats_out=self._stats,
            )
        except KernelError:
            raise
        except Exception:
            return None

    def _new_cell(self, key: Hashable) -> FleetController:
        kwargs: dict = dict(
            gap_threshold=self.gap_threshold,
            sub_max_nodes=self.sub_max_nodes,
            drain_on_notice=self.drain_on_notice,
        )
        if self.policy_factory is not None:
            kwargs["policy"] = self.policy_factory()
        if self.billing is not None:
            kwargs["billing"] = self.billing
        if self.billing_by_type is not None:
            kwargs["billing_by_type"] = self.billing_by_type
        kwargs["colgen_pool"] = self._colgen_pool
        ctrl = FleetController(self.manager, self.strategy, **kwargs)
        # Cell 0 counts from 0, so a single-cell config allocates the
        # exact uid sequence the flat controller would.
        ctrl._uid = _Counter(len(self._cell_list) * UID_STRIDE)
        self._cells[key] = ctrl
        self._cell_list.append(ctrl)
        return ctrl

    def _batched_reset(
        self, parts: dict[Hashable, list[StreamSpec]]
    ) -> dict[Hashable, ReplanResult]:
        """Cold-start every cell from ONE pack scan launch."""
        keys = list(parts)
        problems = [
            self.manager.formulate(parts[k], self.strategy) for k in keys
        ]
        sols = heuristics.batched_pack(problems, device=self.manager.device)
        self._stats["batched_repair_dispatches"] += 1
        results: dict[Hashable, ReplanResult] = {}
        for key, problem, sol in zip(keys, problems, sols):
            ctrl = self._cells[key]
            results[key] = self._adopt_cold(ctrl, parts[key], problem, sol)
        return results

    def _adopt_cold(
        self,
        ctrl: FleetController,
        streams: list[StreamSpec],
        problem: Problem,
        solution: Solution,
    ) -> ReplanResult:
        """`FleetController.reset` bookkeeping around a precomputed
        solution (the batched path skips the per-cell solve)."""
        from .binpack import bincompletion

        ctrl._streams = list(streams)
        ctrl._problem = problem
        ctrl.now = self.now
        ctrl._spares = {}
        ctrl._pending_release = set()
        ctrl.lifecycle = LifecycleEngine(
            ctrl.billing, billing_by_type=ctrl.billing_by_type
        )
        ctrl._ledger_live = set()
        ctrl._noticed = {}
        ctrl._notice_ids = {}
        ctrl._nominal = {}
        ctrl._degraded = {}
        ctrl._parked = {}
        ctrl._adopt_solution(problem, solution, match_old=False)
        ctrl._plan = ctrl._assemble(problem, optimal=False)
        ctrl._prices = None
        ctrl._sync_lifecycle()
        lb = bincompletion.root_lower_bound(problem)
        result = ReplanResult(
            plan=ctrl._plan,
            mode="reset",
            displaced=tuple(s.name for s in streams),
            migrated=(),
            lower_bound=lb,
            gap=_gap(ctrl._plan.hourly_cost, lb),
            nodes=0,
            at=self.now,
        )
        result = ctrl.policy.on_reset(ctrl, result)
        ctrl._flush_spare_releases()
        ctrl._sync_lifecycle()
        self.lifecycle.invalidate()  # fresh engine identity for this cell
        return result

    def _route_stream_event(self, event: FleetEvent) -> ReplanResult:
        if isinstance(event, StreamAdded):
            name = event.stream.name
            # A name the fleet already tracks (live or parked) resolves
            # in its owning cell, flat-identically; fresh names route by
            # the key, creating the cell on first sight.
            key = self._cell_of.get(name)
            if key is None:
                key = self.cell_key(event.stream)
                if key not in self._cells:
                    ctrl = self._new_cell(key)
                    self._cell_of[name] = key
                    r = ctrl.reset([event.stream], at=self.now)
                    self._last_lb[key] = r.lower_bound
                    return self._finish(key, r)
            self._cell_of[name] = key
        else:
            name = event.name
            key = self._cell_of.get(name)
            if key is None:
                # Unknown stream: flat folds it as a no-op.
                if len(self._cells) == 1:
                    key = next(iter(self._cells))
                else:
                    return self._result(mode="noop")
        r = self._cells[key].apply(event)
        if isinstance(event, StreamRemoved) and name not in self._cells[key].parked:
            self._cell_of.pop(name, None)
        return self._finish(key, r)

    def _broadcast_price(self, event: PriceChanged) -> ReplanResult:
        # Re-pricing mutates the shared catalog idempotently, so every
        # cell folding the same event converges on the same prices; each
        # fold also re-plans that cell against the new costs.
        results: dict[Hashable, ReplanResult] = {}
        per_cell = self._stats["events_per_cell"]
        for key, c in self._cells.items():
            results[key] = c.apply(event)
            self._last_lb[key] = results[key].lower_bound
            per_cell[key] = per_cell.get(key, 0) + 1
            self._stats["serial_repair_dispatches"] += 1
        if len(results) == 1:
            return next(iter(results.values()))
        modes = {r.mode for r in results.values()}
        mode = "full" if "full" in modes else "warm" if "warm" in modes else "noop"
        displaced: list[str] = []
        migrated: list[str] = []
        actions: list[str] = []
        for r in results.values():
            displaced.extend(r.displaced)
            migrated.extend(r.migrated)
            actions.extend(r.actions)
        return self._result(
            mode=mode,
            displaced=tuple(sorted(displaced)),
            migrated=tuple(sorted(migrated)),
            nodes=sum(r.nodes for r in results.values()),
            actions=tuple(actions),
        )

    def _route_instance_event(self, event) -> ReplanResult:
        is_notice = isinstance(event, InstancePreemptionNotice)
        if not is_notice and event.notice_id >= 0:
            # A kill paired to an earlier notice lands on whatever cell
            # the notice hit — the cell's own notice map finishes the job.
            key = self._notice_cell.pop(event.notice_id, None)
            if key is None:
                return self._result(mode="noop")
            return self._finish(key, self._cells[key].apply(event))
        if event.uid >= 0:
            i = event.uid // UID_STRIDE
            if not 0 <= i < len(self._cell_list):
                return self._result(mode="noop")
            key = next(
                k for k, c in self._cells.items() if c is self._cell_list[i]
            )
            if is_notice and event.notice_id >= 0:
                self._notice_cell[event.notice_id] = key
            return self._finish(key, self._cells[key].apply(event))
        # Sampled shock: resolve against the merged alive spot fleet with
        # the flat controller's exact slot/thinning arithmetic (uids are
        # globally unique and sorted, so one cell degenerates to flat).
        alive: dict[int, tuple[Hashable, object]] = {}
        for key, c in self._cells.items():
            for b in c._bins:
                alive[b.uid] = (key, b.bin_type)
            for uid, bt in c._spares.items():
                alive[uid] = (key, bt)
        spots = sorted(u for u, (_k, bt) in alive.items() if bt.hazard > 0.0)
        scaled = event.draw * event.pool
        slot = int(scaled)
        uid = spots[slot] if slot < len(spots) else None
        if uid is not None and event.hazard_ref > 0.0:
            frac = scaled - slot
            if frac * event.hazard_ref >= alive[uid][1].hazard:
                uid = None
        if uid is None:
            if is_notice and event.notice_id >= 0:
                self._notice_cell[event.notice_id] = None
            return self._result(mode="noop")
        key = alive[uid][0]
        if is_notice and event.notice_id >= 0:
            self._notice_cell[event.notice_id] = key
        fwd = dataclasses.replace(event, uid=uid)
        return self._finish(key, self._cells[key].apply(fwd))

    def _finish(self, key: Hashable, r: ReplanResult) -> ReplanResult:
        """Fold one routed cell result into the merged view."""
        self._last_lb[key] = r.lower_bound
        per_cell = self._stats["events_per_cell"]
        per_cell[key] = per_cell.get(key, 0) + 1
        self._stats["serial_repair_dispatches"] += 1
        if len(self._cells) == 1:
            return r  # flat-identical: hand the cell's result through
        return self._result(
            mode=r.mode,
            displaced=r.displaced,
            migrated=r.migrated,
            nodes=r.nodes,
            actions=r.actions,
            advice=r.advice,
        )

    def _result(
        self,
        *,
        mode: str,
        displaced: tuple[str, ...] = (),
        migrated: tuple[str, ...] = (),
        nodes: int = 0,
        actions: tuple[str, ...] = (),
        advice: dict | None = None,
    ) -> ReplanResult:
        plan = self._merged_plan()
        lb = sum(self._last_lb.values())
        return ReplanResult(
            plan=plan,
            mode=mode,
            displaced=displaced,
            migrated=migrated,
            lower_bound=lb,
            gap=_gap(plan.hourly_cost, lb),
            nodes=nodes,
            actions=actions,
            advice=advice,
            at=self.now,
        )

    def _merged_plan(self) -> AllocationPlan:
        """Concatenate per-cell plans into one fleet-wide view."""
        return self._merged_plan_from(
            tuple((key, c.plan) for key, c in self._cells.items())
        )

    def _merged_plan_from(
        self, segs: tuple[tuple[Hashable, AllocationPlan | None], ...]
    ) -> AllocationPlan:
        """Concatenate the given per-cell plan segments into one view.

        Only the routed cell's plan object changes per event, so each
        cell's shifted placement segment is cached against (plan
        identity, bin offset) and reused until either moves.  The
        batched pipeline calls this with HISTORICAL (key, plan) pairs to
        materialize a mid-batch merged plan lazily.
        """
        instances: list[str] = []
        placements: list = []
        bins: list = []
        cost = 0.0
        offset = 0
        for key, plan in segs:
            if plan is None or not plan.instances:
                continue
            cached = self._seg_cache.get(key)
            if cached is not None and cached[0] is plan and cached[1] == offset:
                seg = cached[2]
                self._stats["seg_cache_hits"] += 1
            else:
                self._stats["seg_cache_misses"] += 1
                if offset == 0:
                    seg = plan.placements
                else:
                    # Direct construction: ~3x cheaper than
                    # dataclasses.replace on the re-shift hot path.
                    seg = tuple(
                        PlacedStream(
                            p.stream,
                            p.instance_index + offset,
                            p.instance_type,
                            p.device,
                        )
                        for p in plan.placements
                    )
                self._seg_cache[key] = (plan, offset, seg)
            placements.extend(seg)
            instances.extend(plan.instances)
            bins.extend(plan.solution.bins)
            cost += plan.hourly_cost
            offset += len(plan.instances)
        return AllocationPlan(
            strategy=self.strategy.name,
            instances=tuple(instances),
            placements=tuple(placements),
            hourly_cost=cost,
            optimal=False,
            solution=_MergedSolution(bins=tuple(bins), cost=cost),
        )

    # ----------------------------------------------------- rebalance plumbing

    def _try_move(
        self, name: str, src_key: Hashable, dst_key: Hashable, *, min_saving: float
    ) -> str | None:
        src, dst = self._cells[src_key], self._cells[dst_key]
        spec = next((s for s in src._streams if s.name == name), None)
        if spec is None or src._plan is None or dst._plan is None:
            return None
        before = src._plan.hourly_cost + dst._plan.hourly_cost
        snap_src, snap_dst = _cell_snapshot(src), _cell_snapshot(dst)
        try:
            r_src = src.apply(StreamRemoved(name, at=self.now))
            r_dst = dst.apply(StreamAdded(spec, at=self.now))
        except Exception as e:
            _cell_restore(src, snap_src)
            _cell_restore(dst, snap_dst)
            self.lifecycle.invalidate()
            if isinstance(e, KernelError):  # a failed kernel surfaces
                raise
            return None
        assert src._plan is not None and dst._plan is not None
        after = src._plan.hourly_cost + dst._plan.hourly_cost
        if after < before - max(min_saving, _EPS):
            self._cell_of[name] = dst_key
            self._last_lb[src_key] = r_src.lower_bound
            self._last_lb[dst_key] = r_dst.lower_bound
            return f"rebalance:{name}:{src_key}->{dst_key}:-${before - after:.4f}"
        _cell_restore(src, snap_src)
        _cell_restore(dst, snap_dst)
        self.lifecycle.invalidate()  # rollback swapped in deepcopied engines
        return None


class _BatchRun:
    """One run of independently-routable events inside `apply_events`.

    Captures the pre-fold base state (per-cell plan refs, LB map, and —
    when snapshots are requested — the per-cell facade state), the
    per-cell op queues, and one reconstruction descriptor per event.
    ``dirty`` holds stream names removed in this run: a later event
    referencing one forces a barrier, because parked-vs-gone routing is
    unknowable until the fold."""

    __slots__ = (
        "owner", "descs", "ops", "dirty",
        "base_plans", "base_lb", "base_uids", "base_rungs", "base_parked",
    )

    def __init__(self, owner: ShardedController, with_snapshots: bool) -> None:
        self.owner = owner
        self.descs: list[tuple] = []
        self.ops: dict[Hashable, list[tuple]] = {}
        self.dirty: set[str] = set()
        self.base_plans = {k: c.plan for k, c in owner._cells.items()}
        self.base_lb = dict(owner._last_lb)
        if with_snapshots:
            self.base_uids = {
                k: c.instance_uids for k, c in owner._cells.items()
            }
            self.base_rungs = {
                k: dict(c.degraded_rungs) for k, c in owner._cells.items()
            }
            self.base_parked = {
                k: dict(c.parked) for k, c in owner._cells.items()
            }
        else:
            self.base_uids = {}
            self.base_rungs = {}
            self.base_parked = {}

    def push(
        self, j: int, key: Hashable, op: tuple, now_j: float
    ) -> None:
        self.ops.setdefault(key, []).append(op)
        # Cell count is recorded AFTER routing (a join may have just
        # created the cell), mirroring when `_finish` reads it serially.
        self.descs.append(("cell", j, key, now_j, len(self.owner._cells)))

    def noop(self, j: int, now_j: float) -> None:
        self.descs.append(("noop", j, now_j))


class _LazyMergedPlan:
    """A merged `AllocationPlan` facade whose content is deferred.

    ``hourly_cost`` is precomputed (the accounting hot path);
    ``instances``/``placements``/``solution`` materialize through the
    owner's segment cache on first access.  Field-for-field identical to
    the eager `_merged_plan` built from the same (key, plan) segments."""

    __slots__ = ("_owner", "_segs", "_real", "strategy", "hourly_cost", "optimal")

    def __init__(
        self,
        owner: ShardedController,
        segs: tuple,
        cost: float,
    ) -> None:
        self._owner = owner
        self._segs = segs
        self._real: AllocationPlan | None = None
        self.strategy = owner.strategy.name
        self.hourly_cost = cost
        self.optimal = False

    def _materialize(self) -> AllocationPlan:
        real = self._real
        if real is None:
            real = self._real = self._owner._merged_plan_from(self._segs)
        return real

    @property
    def instances(self) -> tuple[str, ...]:
        return self._materialize().instances

    @property
    def placements(self) -> tuple:
        return self._materialize().placements

    @property
    def solution(self):
        return self._materialize().solution


def _cell_snapshot(ctrl: FleetController) -> dict:
    """Everything a rejected rebalance move must roll back — the cell's
    full mutable state, including the billing ledger and the policy's
    internal counters (policies are stateful per controller)."""
    return dict(
        now=ctrl.now,
        streams=list(ctrl._streams),
        problem=ctrl._problem,
        plan=ctrl._plan,
        bins=[b.snapshot() for b in ctrl._bins],
        prices=None if ctrl._prices is None else dict(ctrl._prices),
        lifecycle=copy.deepcopy(ctrl.lifecycle),
        ledger_live=set(ctrl._ledger_live),
        spares=dict(ctrl._spares),
        pending_release=set(ctrl._pending_release),
        noticed=dict(ctrl._noticed),
        notice_ids=dict(ctrl._notice_ids),
        nominal=dict(ctrl._nominal),
        degraded=dict(ctrl._degraded),
        parked=dict(ctrl._parked),
        policy=copy.deepcopy(ctrl.policy),
        uid=ctrl._uid.value if isinstance(ctrl._uid, _Counter) else None,
    )


def _cell_restore(ctrl: FleetController, snap: dict) -> None:
    ctrl.now = snap["now"]
    ctrl._streams = snap["streams"]
    ctrl._problem = snap["problem"]
    ctrl._plan = snap["plan"]
    ctrl._bins = snap["bins"]
    ctrl._prices = snap["prices"]
    ctrl.lifecycle = snap["lifecycle"]
    ctrl._ledger_live = snap["ledger_live"]
    ctrl._spares = snap["spares"]
    ctrl._pending_release = snap["pending_release"]
    ctrl._noticed = snap["noticed"]
    ctrl._notice_ids = snap["notice_ids"]
    ctrl._nominal = snap["nominal"]
    ctrl._degraded = snap["degraded"]
    ctrl._parked = snap["parked"]
    ctrl.policy = snap["policy"]
    if snap["uid"] is not None:
        ctrl._uid.value = snap["uid"]
