"""Stream and analysis-program abstractions (paper §3.1 factors 2 & 3).

Besides the static fleet model (`StreamSpec`), this module defines the
*fleet event* vocabulary consumed by `core.controller.FleetController`:
cameras join (`StreamAdded`), drop (`StreamRemoved`), renegotiate frame
rates (`StreamRateChanged`), the cloud re-prices instance types
(`PriceChanged`), and the cloud reclaims spot instances
(`InstancePreempted` — forced termination, seeded-sampled or by uid).
`apply_events` is the pure fleet-transition function (instance-side
events leave the stream list untouched), and `fleet_key` is the
canonical order-insensitive fingerprint used to detect no-op transitions
and key re-plan caches.

QoS is first-class: every stream carries an `SLATier` — a service
contract naming its protection rank, its legal frame-rate ladder
(descending fractions of the nominal rate the allocator may degrade it
to, paper-style 30→15→5 FPS), its blackout budget (SLA-violation
threshold on service-interruption seconds), and the dollar penalties the
simulator accrues per degraded rung-hour and blackout-hour.  The default
tier (`DEFAULT_TIER`) is inert — no ladder, no budgets, no penalties —
so single-tier fleets replay bit-identically to the pre-tier controller.

Real clouds warn before reclaiming spot capacity:
`InstancePreemptionNotice` is that warning (same sampled-victim form as
`InstancePreempted`, plus a reclamation ``deadline``), and a
``notice_id`` links a notice to its follow-up kill so the pair targets
the *same* instance across policies that do and do not act on notices.
`storm_trace` composes seeded correlated-failure scenarios
(`StormPhase`: whole-pool reclamation, notice-then-kill waves, price
spikes, flash-crowd joins) over a background churn trace — the
fault-injection harness `benchmarks/storms.py` replays identically
across policies.

For the policy layer's lookahead autoscaler, `StreamForecast` describes a
short-horizon join/leave forecast and `forecast_cone` expands it into the
lattice of hypothetical fleets (every prefix of joins crossed with every
prefix of leaves) that `FleetController.what_if` scores in one batched
dispatch.

Time is first-class: every `FleetEvent` carries a keyword-only ``at``
timestamp (hours since trace start, default ``0.0`` so untimed call sites
stay valid), and `TimedTrace` is the validated container of a monotone
event sequence plus its horizon — the input `core.simulator.simulate_churn`
replays through the instance-lifecycle billing engine
(`core.lifecycle.LifecycleEngine`).  `synthetic_timed_trace` generates the
seeded join/leave/re-rate traces the benchmarks replay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

__all__ = [
    "FrameSize",
    "StreamSpec",
    "AnalysisProgram",
    "COMMON_FRAME_SIZES",
    "SLATier",
    "DEFAULT_TIER",
    "GOLD",
    "SILVER",
    "BRONZE",
    "FleetEvent",
    "StreamAdded",
    "StreamRemoved",
    "StreamRateChanged",
    "PriceChanged",
    "InstancePreempted",
    "InstancePreemptionNotice",
    "apply_events",
    "fleet_key",
    "StreamForecast",
    "forecast_cone",
    "TimedTrace",
    "synthetic_timed_trace",
    "StormPhase",
    "storm_trace",
]


@dataclasses.dataclass(frozen=True)
class FrameSize:
    width: int
    height: int

    @property
    def pixels(self) -> int:
        return self.width * self.height

    def __str__(self) -> str:
        return f"{self.width}x{self.height}"


#: Paper §3.1.3: "there are only a few common frame sizes among network cameras".
COMMON_FRAME_SIZES = (
    FrameSize(640, 480),
    FrameSize(1280, 720),
    FrameSize(1920, 1080),
)


@dataclasses.dataclass(frozen=True)
class AnalysisProgram:
    """An analysis program (VGG-16, ZF, or any model from the zoo).

    Allocation works from previously profiled requirement tables keyed by
    ``program_id``.
    """

    name: str
    #: identifies the profile-table entry; e.g. "vgg16", "zf", "gemma2-2b".
    program_id: str


@dataclasses.dataclass(frozen=True)
class SLATier:
    """A stream's service contract: protection rank, rate ladder, budgets.

    ``rank`` orders tiers by protection: 0 is the most protected; under
    pressure the allocator sheds the *highest* rank first.  The
    ``rate_ladder`` lists the legal service levels as descending fractions
    of the stream's nominal frame rate — rung 0 is always full rate
    (``1.0``); e.g. ``(1.0, 0.5, 1/6)`` is the paper-style 30→15→5 FPS
    ladder for a 30 FPS stream.  A one-rung ladder means the stream may
    never be degraded.

    ``blackout_budget_s`` is the SLA: the cumulative *blackout* (service
    fully interrupted — preemption gaps, uncovered notice tails, parked
    time) a stream may suffer over a trace before it counts as an SLA
    violation.  ``rung_penalty`` and ``blackout_penalty`` are the utility
    penalties (`$`/stream-hour per rung below full, and `$`/stream-hour
    dark) `core.simulator.simulate_churn` accrues, making its output a
    cost-vs-QoS pair rather than a single billed number.  ``parkable``
    tiers may be taken off the fleet entirely (parked) as a last resort.
    """

    name: str
    rank: int
    rate_ladder: tuple[float, ...] = (1.0,)
    blackout_budget_s: float = float("inf")
    rung_penalty: float = 0.0
    blackout_penalty: float = 0.0
    parkable: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "rate_ladder", tuple(self.rate_ladder))
        if self.rank < 0:
            raise ValueError(f"tier {self.name}: rank must be >= 0")
        if not self.rate_ladder or self.rate_ladder[0] != 1.0:
            raise ValueError(
                f"tier {self.name}: rate ladder must start at full rate (1.0)"
            )
        for lo, hi in zip(self.rate_ladder[1:], self.rate_ladder):
            if not 0.0 < lo < hi:
                raise ValueError(
                    f"tier {self.name}: ladder must be strictly decreasing "
                    f"and positive, got {self.rate_ladder}"
                )
        if self.blackout_budget_s < 0 or self.blackout_budget_s != self.blackout_budget_s:
            raise ValueError(f"tier {self.name}: blackout budget must be >= 0")
        if self.rung_penalty < 0 or self.blackout_penalty < 0:
            raise ValueError(f"tier {self.name}: penalties must be >= 0")


#: Inert contract: no ladder, no budget, no penalties.  Fleets left on the
#: default tier replay bit-identically to the pre-tier controller.
DEFAULT_TIER = SLATier("STANDARD", rank=1)

#: Never degraded; tight blackout budget (one cold boot fits, two do not).
GOLD = SLATier(
    "GOLD", rank=0, blackout_budget_s=150.0, blackout_penalty=60.0
)
#: May halve its rate; generous blackout budget.
SILVER = SLATier(
    "SILVER",
    rank=1,
    rate_ladder=(1.0, 0.5),
    blackout_budget_s=600.0,
    rung_penalty=2.0,
    blackout_penalty=25.0,
)
#: Full 30→15→5-style ladder, unbounded budget, parkable as a last resort.
BRONZE = SLATier(
    "BRONZE",
    rank=2,
    rate_ladder=(1.0, 0.5, 1.0 / 6.0),
    rung_penalty=0.5,
    blackout_penalty=8.0,
    parkable=True,
)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """A network-camera stream to be analyzed (paper Fig. 2 inputs)."""

    name: str
    program: AnalysisProgram
    desired_fps: float
    frame_size: FrameSize = COMMON_FRAME_SIZES[0]
    tier: SLATier = DEFAULT_TIER

    def __post_init__(self) -> None:
        if self.desired_fps <= 0:
            raise ValueError(f"stream {self.name}: fps must be > 0")


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """Base class for live fleet-churn events (paper's re-allocation loop).

    ``at`` is the event's timestamp in hours since trace start.  It is
    keyword-only with a ``0.0`` default, so positional construction of the
    concrete events (``StreamAdded(spec)``) and every untimed call site
    keep working; timed traces pass ``at=`` explicitly and `TimedTrace`
    validates monotonicity.
    """

    at: float = dataclasses.field(default=0.0, kw_only=True)

    def __post_init__(self) -> None:
        if self.at < 0 or self.at != self.at:  # negative or NaN
            raise ValueError(f"event timestamp must be >= 0 hours, got {self.at}")


@dataclasses.dataclass(frozen=True)
class StreamAdded(FleetEvent):
    """A camera joined the fleet."""

    stream: StreamSpec


@dataclasses.dataclass(frozen=True)
class StreamRemoved(FleetEvent):
    """A camera (identified by stream name) left the fleet."""

    name: str


@dataclasses.dataclass(frozen=True)
class StreamRateChanged(FleetEvent):
    """An analyst changed a stream's desired frame rate."""

    name: str
    desired_fps: float

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.desired_fps <= 0:
            raise ValueError(f"event for {self.name}: fps must be > 0")


@dataclasses.dataclass(frozen=True)
class PriceChanged(FleetEvent):
    """The cloud re-priced an instance type (spot drift, new contract)."""

    instance_type: str
    cost: float

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.cost < 0:
            raise ValueError(f"{self.instance_type}: negative cost")


@dataclasses.dataclass(frozen=True)
class InstancePreempted(FleetEvent):
    """The cloud reclaimed a spot instance: forced termination, no drain.

    ``uid`` names the lifecycle ledger record of the reclaimed instance;
    ``uid = -1`` means the victim is *sampled* at replay time: the
    controller orders its alive spot instances (``BinType.hazard > 0``,
    held spares included) by uid and takes the one at slot
    ``int(draw * pool)`` — no alive spot instance at that slot means the
    shock misses (an all-on-demand fleet is never preempted).  This is
    Poisson thinning: a trace generated with shock rate
    ``hazard_ref * pool`` delivers each spot instance at most a
    ``hazard_ref``/hr interruption rate (exact while the fleet holds at
    most ``pool`` spot instances), while the pre-generated event sequence
    stays identical across the policies compared on it.

    ``hazard_ref`` > 0 additionally thins *per type*: the slotted victim
    is accepted only when the draw's fractional slot position (uniform,
    independent of the slot) falls below ``victim.hazard / hazard_ref``,
    so a type with hazard λ ≤ ``hazard_ref`` is interrupted at exactly
    λ/hr — scarce high-hazard shapes die more often than plentiful
    low-hazard ones under the *same* shock sequence.  ``hazard_ref = 0``
    (the default) accepts any slotted spot instance regardless of its
    type hazard.
    """

    uid: int = -1
    draw: float = dataclasses.field(default=0.0, kw_only=True)
    pool: int = dataclasses.field(default=1, kw_only=True)
    hazard_ref: float = dataclasses.field(default=0.0, kw_only=True)
    notice_id: int = dataclasses.field(default=-1, kw_only=True)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.uid < -1:
            raise ValueError(
                f"preemption uid must be >= 0 (or -1 = sampled), got {self.uid}"
            )
        if not 0.0 <= self.draw < 1.0:
            raise ValueError(f"preemption draw must be in [0, 1), got {self.draw}")
        if self.pool < 1:
            raise ValueError(f"preemption pool must be >= 1, got {self.pool}")
        if self.hazard_ref < 0 or self.hazard_ref != self.hazard_ref:
            raise ValueError(
                f"preemption hazard_ref must be >= 0, got {self.hazard_ref}"
            )
        if self.notice_id < -1:
            raise ValueError(
                f"notice_id must be >= 0 (or -1 = unannounced), got {self.notice_id}"
            )


@dataclasses.dataclass(frozen=True)
class InstancePreemptionNotice(FleetEvent):
    """The cloud's reclamation warning: this instance dies at ``deadline``.

    Same victim-selection form as `InstancePreempted` (explicit ``uid`` or
    seeded thinning via ``draw``/``pool``/``hazard_ref``), but the
    instance keeps running until ``deadline`` (hours, absolute; must be at
    or after ``at``).  A draining controller evacuates the victim inside
    the window — make-before-break — converting what would have been a
    preemption blackout into an ordinary double-billed migration; a naive
    controller ignores the warning and eats the blackout when the kill
    lands.

    ``notice_id`` pairs the warning with its follow-up
    `InstancePreempted(notice_id=...)` so both target the *same* resolved
    instance at replay time regardless of what the policy did in between
    (and a kill whose notice missed — or was a false alarm that never
    fires — stays a no-op).  A notice is never itself a termination: an
    instance noticed but never killed keeps billing.
    """

    uid: int = -1
    deadline: float = dataclasses.field(default=0.0, kw_only=True)
    draw: float = dataclasses.field(default=0.0, kw_only=True)
    pool: int = dataclasses.field(default=1, kw_only=True)
    hazard_ref: float = dataclasses.field(default=0.0, kw_only=True)
    notice_id: int = dataclasses.field(default=-1, kw_only=True)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.uid < -1:
            raise ValueError(
                f"notice uid must be >= 0 (or -1 = sampled), got {self.uid}"
            )
        if self.deadline < self.at or self.deadline != self.deadline:
            raise ValueError(
                f"notice deadline must be >= event time {self.at}, "
                f"got {self.deadline}"
            )
        if not 0.0 <= self.draw < 1.0:
            raise ValueError(f"notice draw must be in [0, 1), got {self.draw}")
        if self.pool < 1:
            raise ValueError(f"notice pool must be >= 1, got {self.pool}")
        if self.hazard_ref < 0 or self.hazard_ref != self.hazard_ref:
            raise ValueError(f"notice hazard_ref must be >= 0, got {self.hazard_ref}")
        if self.notice_id < -1:
            raise ValueError(
                f"notice_id must be >= 0 (or -1 = unpaired), got {self.notice_id}"
            )


def apply_events(
    streams: Sequence[StreamSpec], events: Iterable[FleetEvent]
) -> tuple[StreamSpec, ...]:
    """Pure fleet-transition function: fold events into a new stream tuple.

    Stream order is preserved for surviving streams; added and re-rated
    streams append at the end (the order the controller's incremental
    tensor path expects).  Price events do not change the stream list.
    """
    fleet = list(streams)
    for ev in events:
        if isinstance(ev, StreamAdded):
            if any(s.name == ev.stream.name for s in fleet):
                raise ValueError(f"duplicate stream name {ev.stream.name!r}")
            fleet.append(ev.stream)
        elif isinstance(ev, StreamRemoved):
            survivors = [s for s in fleet if s.name != ev.name]
            if len(survivors) == len(fleet):
                raise KeyError(f"no stream named {ev.name!r}")
            fleet = survivors
        elif isinstance(ev, StreamRateChanged):
            hit = [s for s in fleet if s.name == ev.name]
            if not hit:
                raise KeyError(f"no stream named {ev.name!r}")
            fleet = [s for s in fleet if s.name != ev.name]
            fleet.append(dataclasses.replace(hit[0], desired_fps=ev.desired_fps))
        elif isinstance(
            ev, (PriceChanged, InstancePreempted, InstancePreemptionNotice)
        ):
            pass  # instance-side events; the controller folds them in
        else:
            raise TypeError(f"unknown fleet event {ev!r}")
    return tuple(fleet)


@dataclasses.dataclass(frozen=True)
class StreamForecast:
    """A short-horizon join/leave forecast (autoscaling lookahead input).

    ``joins`` are expected arrivals in most-likely-first order; ``leaves``
    are expected departures (stream names), likewise ordered.  The
    forecast's *cone* is every fleet reachable by folding in a prefix of
    each — the uncertainty lattice a lookahead autoscaler provisions over.
    """

    joins: tuple[StreamSpec, ...] = ()
    leaves: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        names = [s.name for s in self.joins]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate forecast join names: {names}")
        if len(set(self.leaves)) != len(self.leaves):
            raise ValueError(f"duplicate forecast leaves: {self.leaves}")


def forecast_cone(
    streams: Sequence[StreamSpec], forecast: StreamForecast
) -> list[tuple[StreamSpec, ...]]:
    """Expand a forecast into its fleet cone, joins-major row order.

    Returns ``(len(joins)+1) * (len(leaves)+1)`` fleets: entry
    ``j * (L+1) + l`` is the current fleet with the first ``j`` forecast
    joins added and the first ``l`` forecast leaves removed — the grid the
    autoscaler's cheapest-provisioning-path DP walks.  Leaves must name
    live streams; joins must not collide with live names.
    """
    base = tuple(streams)
    live = {s.name for s in base}
    for s in forecast.joins:
        if s.name in live:
            raise ValueError(f"forecast join duplicates live stream {s.name!r}")
    for name in forecast.leaves:
        if name not in live:
            raise KeyError(f"forecast leave names no live stream {name!r}")
    fleets: list[tuple[StreamSpec, ...]] = []
    for j in range(len(forecast.joins) + 1):
        joined = base + forecast.joins[:j]
        for leave_count in range(len(forecast.leaves) + 1):
            gone = set(forecast.leaves[:leave_count])
            fleets.append(tuple(s for s in joined if s.name not in gone))
    return fleets


@dataclasses.dataclass(frozen=True)
class TimedTrace:
    """A validated, time-ordered churn trace: events + replay horizon.

    ``events`` must carry non-decreasing ``at`` timestamps (hours);
    ``horizon`` is the instant the replay is accounted up to (billing the
    final fleet's open instances included) and must not precede the last
    event.  Iterating a trace yields its events, so every consumer of a
    plain ``Sequence[FleetEvent]`` accepts a `TimedTrace` unchanged.
    """

    events: tuple[FleetEvent, ...]
    horizon: float = 0.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))
        last = 0.0
        for ev in self.events:
            if ev.at < last:
                raise ValueError(
                    f"trace timestamps must be non-decreasing: "
                    f"{ev!r} after t={last}"
                )
            last = ev.at
        if self.horizon < last:
            object.__setattr__(self, "horizon", last)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def times(self) -> tuple[float, ...]:
        return tuple(ev.at for ev in self.events)

    @classmethod
    def coerce(cls, events: "TimedTrace | Iterable[FleetEvent]") -> "TimedTrace":
        """Accept a `TimedTrace` or a plain event sequence (shim).

        Untimed sequences (every ``at`` left at the 0.0 default) are valid
        degenerate traces — all events at t=0, zero horizon — preserving
        the historical untimed `simulate_churn` semantics.  New call sites
        should construct a `TimedTrace` directly; the bare-sequence form
        is kept for backward compatibility and may eventually go away.
        """
        if isinstance(events, cls):
            return events
        return cls(events=tuple(events))


def synthetic_timed_trace(
    streams: Sequence[StreamSpec],
    rng,
    *,
    n_events: int,
    mean_gap_hours: float = 0.05,
    p_join: float = 0.3,
    p_leave: float = 0.25,
    make_join: "Callable[[int], StreamSpec] | None" = None,
    rerate_fps: "Callable[[StreamSpec], Sequence[float]] | None" = None,
    burst: int = 1,
    tail_hours: float | None = None,
    preemption_hazard: float = 0.0,
    hazard_pool: int = 64,
    price_drift: float = 0.0,
    price_drift_types: "Sequence[tuple[str, float]] | None" = None,
    price_drift_gap_hours: float = 0.25,
    calibration: "object | None" = None,
) -> TimedTrace:
    """Generate a seeded timed churn trace against a pure fleet replay.

    Event kinds roll join/leave/re-rate with probabilities ``p_join`` /
    ``p_leave`` / remainder; inter-arrival gaps are exponential with mean
    ``mean_gap_hours`` (so timestamps land off quantum boundaries, the
    case billing quantization has to handle).  ``burst`` > 1 emits joins
    in back-to-back bursts sharing one timestamp — the arrival pattern a
    pre-provisioning autoscaler is judged on.  ``make_join(i)`` builds the
    i-th joining stream (default: clone of a random live stream under a
    fresh name); ``rerate_fps(s)`` lists a stream's renegotiable rates
    (default: keep its current rate — a no-op event).  The trace is
    pre-generated against a replayed fleet copy so every policy compared
    on it sees the identical sequence.

    ``preemption_hazard`` overlays a seeded spot-interruption process:
    `InstancePreempted` shocks arrive as a Poisson stream at rate
    ``preemption_hazard * hazard_pool`` over the trace span, each
    carrying a uniform ``draw`` the replaying controller thins against
    its alive spot instances (see `InstancePreempted`).
    ``calibration`` (opt-in, a ``core.calibration.CalibrationArtifact``)
    sources the trace from calibrated profiles: the initial fleet and every
    generated join are validated against the artifact (unknown programs or
    rates beyond the calibrated max raise at *generation* time, not deep in
    a replay), and ``rerate_fps`` candidate lists are filtered to
    calibrated-feasible rates (falling back to the current rate when none
    survive).  The rng draw count is unchanged, so traces with and without
    a calibration source stay draw-aligned; ``calibration=None`` is
    bit-identical to the pre-calibration generator.

    ``preemption_hazard`` is the *reference* (maximum) per-instance
    interruption rate: a spot type with ``hazard = λ ≤ preemption_hazard``
    is interrupted at exactly λ/hr regardless of how many spot instances
    each compared policy actually holds (exact up to ``hazard_pool`` of
    them; types with λ above the reference clamp to it).  The shocks are
    drawn *after* the churn sequence from the same rng, so
    ``preemption_hazard=0`` leaves the churn draws — and the trace —
    bit-identical to the pre-spot generator.

    ``price_drift`` overlays a seeded spot-price random walk:
    `PriceChanged` events every ``price_drift_gap_hours`` for each
    ``(instance_type, base_cost)`` in ``price_drift_types``, following a
    geometric walk with per-√hour volatility ``price_drift`` (floored at
    5% of base, so prices never collapse to free capacity).  The walk
    shares the trace's rng and horizon with the hazard overlay — price
    risk and reclamation risk replay *coupled* in one trace — and its
    draws come after both the churn sequence and the hazard shocks, so
    ``price_drift=0`` (with any hazard) leaves the trace bit-identical.
    """
    fleet = list(streams)
    if calibration is not None:
        for s in fleet:
            calibration.check_stream(s)
    events: list[FleetEvent] = []
    t = 0.0
    i = 0
    while len(events) < n_events:
        t += float(rng.exponential(mean_gap_hours))
        roll = float(rng.rand())
        if roll < p_join or not fleet:
            for _ in range(min(burst, n_events - len(events))):
                if make_join is not None:
                    spec = make_join(i)
                elif fleet:
                    src = fleet[rng.randint(len(fleet))]
                    spec = dataclasses.replace(src, name=f"j{i}")
                else:
                    raise ValueError(
                        "fleet is empty and no make_join was given — "
                        "the default join clones a random live stream"
                    )
                if calibration is not None:
                    calibration.check_stream(spec)
                events.append(StreamAdded(spec, at=t))
                fleet.append(spec)
                i += 1
        elif roll < p_join + p_leave:
            events.append(StreamRemoved(fleet[rng.randint(len(fleet))].name, at=t))
            fleet = list(apply_events(fleet, [events[-1]]))
        else:
            s = fleet[rng.randint(len(fleet))]
            rates = (
                list(rerate_fps(s)) if rerate_fps is not None else [s.desired_fps]
            )
            if calibration is not None:
                cap = calibration.max_feasible_fps(
                    s.program.program_id, str(s.frame_size)
                )
                rates = [r for r in rates if r <= cap + 1e-9] or [s.desired_fps]
            fps = float(rates[rng.randint(len(rates))])
            events.append(StreamRateChanged(s.name, fps, at=t))
            fleet = list(apply_events(fleet, [events[-1]]))
    horizon = t + (
        tail_hours if tail_hours is not None else 2.0 * mean_gap_hours
    )
    if preemption_hazard > 0.0:
        if hazard_pool < 1:
            raise ValueError(f"hazard_pool must be >= 1, got {hazard_pool}")
        shocks: list[FleetEvent] = []
        rate = preemption_hazard * hazard_pool
        ts = 0.0
        while True:
            ts += float(rng.exponential(1.0 / rate))
            if ts >= horizon:
                break
            shocks.append(
                InstancePreempted(
                    at=ts,
                    draw=float(rng.rand()),
                    pool=hazard_pool,
                    hazard_ref=preemption_hazard,
                )
            )
        # Stable merge: churn events keep their relative order at ties.
        events = sorted(events + shocks, key=lambda ev: ev.at)
    if price_drift > 0.0:
        if not price_drift_types:
            raise ValueError(
                "price_drift needs price_drift_types: [(instance_type, "
                "base_cost), ...] naming the walking spot pools"
            )
        if price_drift_gap_hours <= 0.0:
            raise ValueError(
                f"price_drift_gap_hours must be > 0, got {price_drift_gap_hours}"
            )
        # Drawn after churn AND hazard from the same rng: drift=0 keeps
        # both earlier overlays bit-identical; drift>0 couples all three.
        walks: list[FleetEvent] = []
        level = {name: float(base) for name, base in price_drift_types}
        floor = {name: 0.05 * float(base) for name, base in price_drift_types}
        sigma = price_drift * math.sqrt(price_drift_gap_hours)
        tp = price_drift_gap_hours
        while tp < horizon:
            for name, _base in price_drift_types:
                level[name] = max(
                    floor[name],
                    level[name] * math.exp(sigma * float(rng.randn())),
                )
                walks.append(
                    PriceChanged(name, round(level[name], 6), at=tp)
                )
            tp += price_drift_gap_hours
        events = sorted(events + walks, key=lambda ev: ev.at)
    return TimedTrace(events=tuple(events), horizon=horizon)


_STORM_KINDS = ("reclaim", "notice", "false_alarm", "flash_crowd", "price")


@dataclasses.dataclass(frozen=True)
class StormPhase:
    """One correlated-failure wave inside a `storm_trace` scenario.

    ``kind`` selects the wave shape: ``"reclaim"`` is ``count`` sampled
    no-warning kills at ``at``; ``"notice"`` is ``count`` reclamation
    warnings at ``at`` each paired (by ``notice_id``) with a kill at
    ``at + notice_hours``; ``"false_alarm"`` is warnings that never fire;
    ``"flash_crowd"`` is ``count`` simultaneous joins; ``"price"``
    re-prices ``instance_type`` to ``cost``.
    """

    kind: str
    at: float
    count: int = 1
    notice_hours: float = 2.5 / 60.0
    instance_type: str = ""
    cost: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in _STORM_KINDS:
            raise ValueError(f"unknown storm phase kind {self.kind!r}")
        if self.at < 0 or self.at != self.at:
            raise ValueError(f"storm phase time must be >= 0, got {self.at}")
        if self.count < 1:
            raise ValueError(f"storm phase count must be >= 1, got {self.count}")
        if self.notice_hours < 0:
            raise ValueError(f"notice_hours must be >= 0, got {self.notice_hours}")
        if self.kind == "price" and not self.instance_type:
            raise ValueError("price phase needs an instance_type")
        if self.cost < 0:
            raise ValueError(f"storm phase cost must be >= 0, got {self.cost}")


def storm_trace(
    streams: Sequence[StreamSpec],
    rng,
    *,
    phases: Sequence[StormPhase],
    n_background: int = 0,
    mean_gap_hours: float = 0.05,
    p_join: float = 0.3,
    p_leave: float = 0.25,
    make_join: "Callable[[int], StreamSpec] | None" = None,
    rerate_fps: "Callable[[StreamSpec], Sequence[float]] | None" = None,
    hazard_pool: int = 64,
    hazard_ref: float = 0.0,
    tail_hours: float | None = None,
    calibration: "object | None" = None,
) -> TimedTrace:
    """Compose a seeded fault-injection storm over a background churn trace.

    The background join/leave/re-rate stream is generated first via
    `synthetic_timed_trace` (``n_background`` events, no hazard overlay),
    then each `StormPhase` injects its correlated wave; the merge is a
    stable sort by timestamp, so the same seed always yields the same
    trace and every policy replayed on it sees the identical sequence.
    Phase draws come from the same ``rng`` *after* the background churn,
    so two scenarios differing only in phases share their background.

    ``calibration`` (opt-in) flows through to the background generator and
    additionally validates every flash-crowd join against the artifact —
    see `synthetic_timed_trace`.

    ``flash_crowd`` joins use ``make_join`` (required for that kind) with
    indices continuing after the background joins, so names never collide.
    Notice/kill pairs share a ``notice_id``: the kill resolves against
    whatever instance the notice hit, keeping notice-then-kill semantics
    identical across draining and non-draining controllers.
    """
    bg = synthetic_timed_trace(
        streams,
        rng,
        n_events=n_background,
        mean_gap_hours=mean_gap_hours,
        p_join=p_join,
        p_leave=p_leave,
        make_join=make_join,
        rerate_fps=rerate_fps,
        tail_hours=0.0,
        calibration=calibration,
    )
    events = list(bg.events)
    join_index = sum(1 for ev in events if isinstance(ev, StreamAdded))
    notice_id = 0
    injected: list[FleetEvent] = []
    last = max((ev.at for ev in events), default=0.0)
    for phase in phases:
        last = max(last, phase.at)
        if phase.kind == "flash_crowd":
            if make_join is None:
                raise ValueError("flash_crowd phase needs make_join")
            for _ in range(phase.count):
                spec = make_join(join_index)
                if calibration is not None:
                    calibration.check_stream(spec)
                injected.append(StreamAdded(spec, at=phase.at))
                join_index += 1
        elif phase.kind == "price":
            injected.append(
                PriceChanged(phase.instance_type, phase.cost, at=phase.at)
            )
        elif phase.kind == "reclaim":
            for _ in range(phase.count):
                injected.append(
                    InstancePreempted(
                        at=phase.at,
                        draw=float(rng.rand()),
                        pool=hazard_pool,
                        hazard_ref=hazard_ref,
                    )
                )
        else:  # "notice" | "false_alarm"
            deadline = phase.at + phase.notice_hours
            last = max(last, deadline)
            for _ in range(phase.count):
                draw = float(rng.rand())
                injected.append(
                    InstancePreemptionNotice(
                        at=phase.at,
                        deadline=deadline,
                        draw=draw,
                        pool=hazard_pool,
                        hazard_ref=hazard_ref,
                        notice_id=notice_id,
                    )
                )
                if phase.kind == "notice":
                    injected.append(
                        InstancePreempted(at=deadline, notice_id=notice_id)
                    )
                notice_id += 1
    merged = sorted(events + injected, key=lambda ev: ev.at)
    horizon = last + (
        tail_hours if tail_hours is not None else 2.0 * mean_gap_hours
    )
    return TimedTrace(events=tuple(merged), horizon=horizon)


def fleet_key(streams: Sequence[StreamSpec]) -> tuple[StreamSpec, ...]:
    """Canonical (order-insensitive) fingerprint of a fleet.

    Two fleets with the same streams in different orders map to the same
    key; `StreamSpec` is frozen/hashable, so the key is directly usable in
    dicts and sets.
    """
    return tuple(sorted(streams, key=lambda s: (s.name, s.desired_fps)))
