"""Fleet execution simulator (validates the 90%-utilization rule, Fig 5/6).

Models the paper's observed behaviour: analysis performance (actual/desired
frame rate, averaged over streams) stays at 100% while every resource on an
instance is under-utilized, and degrades proportionally once a compute
resource saturates — the streams on that instance share the saturated
resource fairly, so each achieves ``cap/load`` of its desired rate.

`simulate_churn` replays a live event trace through a manager's
`FleetController` as a discrete-event simulation over the controller's
instance-lifecycle ledger (`core.lifecycle`): the trace is a
`streams.TimedTrace` (plain untimed event sequences are shimmed — see the
docstring), each step advances the clock to the event's ``at``, and the
output carries *billed* cost over time (quantum round-up, boot-latency
double-billing and warm spares included) next to the historical $/hr
snapshot record, plus per-instance lifetime records and the
degraded-performance seconds streams spend waiting out instance boots.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .binpack.problem import BinType
from .manager import AllocationPlan
from .profiler import DIM_ACC, DIM_CPU, ProfileTable

__all__ = [
    "InstanceLoad",
    "simulate_plan",
    "simulate_instance",
    "simulate_churn",
    "fleet_fragmentation",
]

_COMPUTE_DIMS = (DIM_CPU, DIM_ACC)


@dataclasses.dataclass(frozen=True)
class InstanceLoad:
    instance_type: str
    utilization: tuple[float, ...]  # per dim, fraction of raw capacity
    performance: float  # avg actual/desired frame rate of its streams
    residual: tuple[float, ...] = ()  # per dim, unused raw capacity


def simulate_instance(
    bin_type: BinType, requirement_vectors: Sequence[np.ndarray]
) -> InstanceLoad:
    cap = np.asarray(bin_type.capacity, dtype=np.float64)
    load = np.sum(requirement_vectors, axis=0) if requirement_vectors else np.zeros_like(cap)
    with np.errstate(divide="ignore", invalid="ignore"):
        util = np.where(cap > 0, load / np.maximum(cap, 1e-300), 0.0)
    # Saturated compute resources are shared fairly: every stream on this
    # instance runs at cap/load of its desired rate for the worst compute dim.
    slowdown = 1.0
    for d in _COMPUTE_DIMS:
        if util[d] > 1.0:
            slowdown = min(slowdown, 1.0 / util[d])
    return InstanceLoad(
        instance_type=bin_type.name,
        utilization=tuple(util.tolist()),
        performance=slowdown,
        residual=tuple(np.maximum(cap - load, 0.0).tolist()),
    )


def fleet_fragmentation(instances: Sequence[InstanceLoad]) -> dict:
    """Per-dim residual-capacity dispersion of a fleet (0 = consolidated).

    For each resource dimension with total residual ``R_d > 0`` across the
    open instances, dispersion is ``1 - max_i(resid[i, d]) / R_d``: zero
    when all free capacity sits in one instance (a future stream can use
    it whole), approaching ``1 - 1/N`` when it is shredded evenly across
    ``N`` instances (plenty of paid-for capacity, none of it usable by a
    large stream).  ``overall`` averages the dims that have residual at
    all.  This is the drift signal pure-pinning controllers accumulate and
    consolidation policies are judged by.
    """
    if not instances:
        return {"per_dim": (), "overall": 0.0}
    # A hand-built InstanceLoad may carry the default empty residual;
    # treat it as "no free capacity" rather than raggedly crashing the
    # stack below (simulate_instance always fills the field).
    dim = max((len(i.residual) for i in instances), default=0)
    if dim == 0:
        return {"per_dim": (), "overall": 0.0}
    if len(instances) == 1:
        # A single instance holds all free capacity by definition: zero
        # dispersion, clamped explicitly (the max/total ratio is 0/0-prone
        # when that lone residual is zero or non-finite).
        return {"per_dim": (0.0,) * dim, "overall": 0.0}
    resid = np.zeros((len(instances), dim))
    for row, inst in enumerate(instances):
        if inst.residual:
            resid[row] = inst.residual
    # Overloaded bins report negative residual in hand-built loads and
    # non-finite entries can leak from degenerate profiles; both would
    # drive the ratio (and the mean) to NaN — clamp to "no free capacity".
    resid = np.clip(np.nan_to_num(resid, nan=0.0, posinf=0.0, neginf=0.0), 0.0, None)
    totals = resid.sum(axis=0)  # (dim,)
    per_dim = np.where(
        totals > 1e-12, 1.0 - resid.max(axis=0) / np.maximum(totals, 1e-300), 0.0
    )
    per_dim = np.clip(per_dim, 0.0, 1.0)
    active = totals > 1e-12
    overall = float(per_dim[active].mean()) if active.any() else 0.0
    return {"per_dim": tuple(per_dim.tolist()), "overall": overall}


def simulate_plan(
    plan: AllocationPlan, profiles: ProfileTable, *, target: float = 0.9
) -> dict:
    """Returns overall performance + per-instance utilizations for a plan.

    ``target`` is the performance floor `meets_target` is judged against
    (paper: 90%).  Callers planning with a non-default utilization cap
    should pass their manager's ``utilization_cap`` here so the packing
    cap and the performance target cannot silently diverge.

    Placements are bucketed by instance in one pass — the former
    per-instance rescan was O(instances x placements), which dominated
    repeated re-plan/simulate loops on large fleets."""
    by_instance: list[list[np.ndarray]] = [[] for _ in plan.solution.bins]
    for p in plan.placements:
        prof = profiles.get(
            p.stream.program.program_id, str(p.stream.frame_size), p.device
        )
        assert prof is not None
        by_instance[p.instance_index].append(prof.at_fps(p.stream.desired_fps))
    per_instance: list[InstanceLoad] = []
    perf_by_stream: list[float] = []
    for bin_, reqs in zip(plan.solution.bins, by_instance):
        info = simulate_instance(bin_.bin_type, reqs)
        per_instance.append(info)
        perf_by_stream += [info.performance] * len(reqs)
    overall = float(np.mean(perf_by_stream)) if perf_by_stream else 1.0
    return {
        "overall_performance": overall,
        "instances": per_instance,
        "meets_target": overall >= target,  # paper: >= 90% by default
        "fragmentation": fleet_fragmentation(per_instance),
    }


def simulate_churn(
    manager,
    initial_streams: Sequence,
    events,
    profiles: ProfileTable,
    *,
    strategy=None,
    target: float | None = None,
    policy=None,
    billing=None,
    billing_by_type=None,
    horizon: float | None = None,
    drain_on_notice: bool | None = None,
    cell_key=None,
    policy_factory=None,
    rebalance_every: int = 0,
    reset_pack: str = "exact",
) -> dict:
    """Replay a churn trace through the manager's live controller as a
    discrete-event simulation over the instance-lifecycle ledger.

    ``events`` is a `streams.TimedTrace` (the first-class form) or, as a
    deprecated shim, any plain ``Sequence[FleetEvent]`` — untimed events
    all land at t=0 with a zero horizon, which preserves the historical
    snapshot-only semantics exactly; new call sites should construct a
    `TimedTrace`.  Establishes `initial_streams` with a cold solve at
    t=0, folds every `FleetEvent` in via warm-start incremental
    re-planning at its ``at`` timestamp, and records per step: hourly
    cost, certified optimality gap, re-plan mode (warm vs full fallback),
    stream migrations, residual-capacity fragmentation, policy actions
    (consolidations, re-pricings, autoscaler provisioning — see
    `core.policy`), simulated performance against ``target`` (defaulting
    to the manager's ``utilization_cap``), and the cumulative *billed*
    cost from the lifecycle ledger.

    ``billing`` installs a `core.lifecycle.BillingModel` on the
    controller (boot latency, billing quantum); with it the output's
    ``billed_cost`` is the fleet's quantum-rounded bill at the horizon —
    always >= ``snapshot_cost_integral``, the timeless $/hr integral —
    and ``degraded_stream_seconds`` totals the stream-seconds newly
    placed streams spend waiting for their instance to finish booting
    (migrating streams keep serving on their draining source, so only
    first placements degrade — the metric warm pre-provisioning buys
    down).  ``policy`` installs a re-planning policy for the replay
    (e.g. ``ConsolidationPolicy(3)``).  ``billing_by_type`` lays
    per-instance-type contracts over the global model (spot vs on-demand
    — see `LifecycleEngine.billing_for`).

    Spot interruptions (`streams.InstancePreempted`) are first-class
    fleet events: a preempted bin's streams are *down* until their
    replacement serves (no make-before-break hand-off), so their
    replacement boot wait is charged to ``degraded_stream_seconds`` —
    and broken out separately as
    ``preemption_degraded_stream_seconds``, next to the ``preemptions``
    count off the ledger's ``preempted_at`` markers.

    SLA accounting (zero-notice single-tier replays are unaffected):
    ``blackout_stream_seconds`` totals the stream-seconds streams spend
    fully dark — preemption waits, the *uncovered tail* of an
    interruption-notice drain (the victim serves until its
    ``terminated_at``; only the gap to the replacement's ``running_at``
    is dark — zero when the notice window covers the boot, widened when
    the paired kill lands *before* the scheduled drain end), parked
    time, and un-park boot waits.  ``drain_on_notice=False`` replays a
    naive controller that sits on notices until the kill.  Per-stream
    blackout rolls up by `streams.SLATier` into ``sla`` (streams,
    budget ``violations``, blackout / reduced-rate / parked exposure)
    and ``sla_violations``; ``utility_penalty`` integrates each tier's
    ``rung_penalty`` over reduced-rate hours plus ``blackout_penalty``
    over blackout hours, pricing graceful degradation against blackout
    in one scalar.
    """
    from .streams import InstancePreempted, TimedTrace
    from .strategies import ST3

    trace = TimedTrace.coerce(events)
    if horizon is None:
        horizon = trace.horizon
    strategy = strategy or ST3
    if target is None:
        target = manager.utilization_cap
    kwargs = {}
    if billing is not None:
        kwargs["billing"] = billing
    if billing_by_type is not None:
        kwargs["billing_by_type"] = billing_by_type
    if drain_on_notice is not None:
        kwargs["drain_on_notice"] = drain_on_notice
    if cell_key is not None or policy_factory is not None:
        # Sharded replay: partition into cells of warm-start controllers
        # (see `core.shard.ShardedController`).  ``policy_factory`` (one
        # fresh policy per cell — policies are stateful) replaces
        # ``policy``; the rest of the replay reads the identical facade.
        if policy is not None:
            raise TypeError(
                "sharded simulate_churn takes policy_factory, not policy "
                "(each cell needs its own policy instance)"
            )
        if policy_factory is not None:
            kwargs["policy_factory"] = policy_factory
        if cell_key is not None:
            kwargs["cell_key"] = cell_key
        ctrl = manager.sharded_controller(
            strategy, rebalance_every=rebalance_every, **kwargs
        )
    else:
        if policy is not None:
            kwargs["policy"] = policy
        ctrl = manager.controller(strategy, **kwargs)
    tiers: dict = {}  # stream name -> SLATier, sticky across removals

    def note_tiers() -> None:
        for s in ctrl.fleet:
            tiers[s.name] = s.tier
        for s in ctrl.parked.values():
            tiers[s.name] = s.tier

    if cell_key is not None or policy_factory is not None:
        results = [ctrl.reset(initial_streams, at=0.0, pack=reset_pack)]
    else:
        results = [ctrl.reset(initial_streams, at=0.0)]
    uid_steps = [ctrl.instance_uids]
    preempted_steps: list[tuple[str, ...]] = [()]
    event_names = ["init"]
    rung_steps = [ctrl.degraded_rungs]
    park_steps = [ctrl.parked]
    note_tiers()
    if cell_key is not None or policy_factory is not None:
        # Sharded replay: the whole trace goes through the batched
        # event pipeline (cross-cell barriers split it internally), and
        # the per-step facade state the accounting loop needs comes back
        # as snapshots instead of per-event property walks.
        trace = list(trace)
        step_results, step_snaps = ctrl.apply_events(
            trace, with_snapshots=True
        )
        for ev, r, snap in zip(trace, step_results, step_snaps):
            results.append(r)
            uid_steps.append(snap["uids"])
            event_names.append(type(ev).__name__)
            rung_steps.append(snap["rungs"])
            park_steps.append(snap["parked"])
            tiers.update(snap["tiers"])
            preempted_steps.append(
                r.displaced if isinstance(ev, InstancePreempted) else ()
            )
        note_tiers()
    else:
        for ev in trace:
            results.append(ctrl.apply(ev))
            uid_steps.append(ctrl.instance_uids)
            event_names.append(type(ev).__name__)
            rung_steps.append(ctrl.degraded_rungs)
            park_steps.append(ctrl.parked)
            note_tiers()
            preempted_steps.append(
                results[-1].displaced
                if isinstance(ev, InstancePreempted)
                else ()
            )
    ledger = ctrl.lifecycle
    times = [r.at for r in results]
    ends = times[1:] + [max(horizon, times[-1])]

    timeline = []
    misses = 0
    degraded_hours = 0.0
    preempt_degraded_hours = 0.0
    rents: list[float] = []  # per step: true billed $/hr of the open fleet
    served: set = set()  # stream names that have been placed before
    degraded_until: dict = {}  # stream -> end of its already-charged wait
    blackout_by: dict[str, float] = {}  # stream -> fully-dark hours
    rung_hours_by: dict[str, float] = {}  # stream -> reduced-rate hours
    parked_hours_by: dict[str, float] = {}  # stream -> parked hours
    utility_penalty = 0.0
    notice_tail_hours = 0.0
    prev_uid_set: set[int] = set()
    prev_host: dict[str, int] = {}

    def charge_blackout(name: str, hours: float) -> None:
        nonlocal utility_penalty
        if hours <= 0.0:
            return
        blackout_by[name] = blackout_by.get(name, 0.0) + hours
        tier = tiers.get(name)
        if tier is not None:
            utility_penalty += tier.blackout_penalty * hours

    for step, (r, uids, hit, t0, t1) in enumerate(
        zip(results, uid_steps, preempted_steps, times, ends)
    ):
        sim = simulate_plan(r.plan, profiles, target=target)
        if not sim["meets_target"]:
            misses += 1
        rungs = rung_steps[step]
        parked = park_steps[step]
        unparked = {
            a.split(":", 1)[1] for a in r.actions if a.startswith("unpark:")
        }
        step_notice_tail = 0.0
        # Stream-hours *new* streams spend waiting for their instance to
        # boot — the post-join degraded window pre-provisioned spares
        # eliminate.  Streams that merely migrate keep serving on their
        # draining source until the destination boots (make-before-break;
        # the ledger's drain window bills that overlap), so they do not
        # degrade.  Streams a preemption displaced are the exception:
        # their source instance is already gone, so they wait out their
        # replacement's remaining boot exactly like a fresh placement.
        # A wait window already charged is never charged twice: when a
        # still-booting replacement is itself preempted, only the extra
        # wait past the previously charged window counts
        # (``degraded_until`` clamps the start of each new charge).
        step_boot_wait = 0.0
        step_preempt_wait = 0.0
        step_unpark_wait = 0.0
        hit_names = set(hit)
        for p in r.plan.placements:
            name = p.stream.name
            down_until = degraded_until.get(name, 0.0)
            if (
                name in hit_names
                or name in unparked
                or name not in served
                or down_until > t0
            ):
                # Fresh placements and preemption victims wait out their
                # instance's boot; a stream *still* waiting one out
                # (``down_until > t0``) that a re-plan moved to a
                # later-booting instance waits the extension too — for an
                # unmoved stream the instance's running_at equals the
                # charged window's end, so the extension is zero.  Waits
                # are charged up front at placement time and never
                # refunded (a later move onto running capacity keeps the
                # original charge): deliberately conservative, and the
                # per-step rows stay comparable across versions.
                rec = ledger.record(uids[p.instance_index])
                since = max(t0, down_until)
                wait = max(0.0, rec.running_at - since)
                if wait > 0.0:
                    degraded_until[name] = rec.running_at
                if name in hit_names:
                    step_preempt_wait += wait
                    charge_blackout(name, wait)
                elif name in unparked:
                    # An un-parked stream was dark while parked and stays
                    # dark until its new instance serves — its boot wait
                    # is blackout, not a mere degraded join.
                    step_unpark_wait += wait
                    charge_blackout(name, wait)
                else:
                    step_boot_wait += wait
        served.update(p.stream.name for p in r.plan.placements)
        # Notice-drain tails: a victim evacuated on an interruption
        # notice keeps serving its old streams until its ``terminated_at``
        # (make-before-break against the clock); only the gap from that
        # end to the replacement's ``running_at`` is dark.  With a notice
        # window longer than the boot the tail is zero — the conversion
        # the drain buys.  ``terminated_at`` is read from the *final*
        # ledger, so a paired kill that lands before the scheduled drain
        # end (restating the termination backwards) widens the tail
        # charged here — up-front charging, consistent with how boot
        # waits are assessed at placement time and never refunded.
        cur_uid_set = set(uids)
        step_notice_victims = 0
        for vuid in prev_uid_set - cur_uid_set:
            if vuid not in ledger:
                continue
            vrec = ledger.record(vuid)
            if (
                vrec.noticed_at is None
                or vrec.noticed_at != r.at
                or vrec.terminated_at is None
            ):
                continue
            step_notice_victims += 1
            planned_end = vrec.terminated_at
            for p in r.plan.placements:
                name = p.stream.name
                if prev_host.get(name) != vuid:
                    continue
                repl_running = ledger.record(uids[p.instance_index]).running_at
                start = max(planned_end, degraded_until.get(name, 0.0))
                tail = max(0.0, repl_running - start)
                if tail > 0.0:
                    degraded_until[name] = repl_running
                    step_notice_tail += tail
                    charge_blackout(name, tail)
        prev_uid_set = cur_uid_set
        prev_host = {
            p.stream.name: uids[p.instance_index]
            for p in r.plan.placements
        }
        # Parked streams are fully dark for the whole step interval;
        # reduced-rate streams accrue rung-weighted utility penalty.
        dt = t1 - t0
        for name in parked:
            parked_hours_by[name] = parked_hours_by.get(name, 0.0) + dt
            charge_blackout(name, dt)
        for name, rung in rungs.items():
            rung_hours_by[name] = rung_hours_by.get(name, 0.0) + dt
            tier = tiers.get(name)
            if tier is not None:
                utility_penalty += tier.rung_penalty * rung * dt
        step_boot_wait += step_preempt_wait + step_unpark_wait
        degraded_hours += step_boot_wait + step_notice_tail
        preempt_degraded_hours += step_preempt_wait
        notice_tail_hours += step_notice_tail
        rents.append(
            sum(b.bin_type.billed_rent for b in r.plan.solution.bins)
        )
        timeline.append(
            {
                "step": step,
                "at": t0,
                "event": event_names[step],
                "mode": r.mode,
                # `cost` is the plan's *decision* cost (the solver
                # objective — hazard-inflated under a risk-adjusted
                # catalog); `rent_cost` is the open fleet's true billed
                # $/hr.  They coincide on un-adjusted catalogs.
                "cost": r.plan.hourly_cost,
                "rent_cost": rents[-1],
                "billed": ledger.billed_cost(t0),
                "gap": r.gap,
                "lower_bound": r.lower_bound,
                "instances": len(r.plan.instances),
                "streams": len(r.plan.placements),
                "migrations": len(r.migrated),
                "boot_wait_stream_hours": step_boot_wait,
                "notice_tail_stream_hours": step_notice_tail,
                "notice_victims": step_notice_victims,
                "preempted_streams": list(hit),
                "displaced": list(r.displaced),
                "parked": len(parked),
                "degraded_streams": len(rungs),
                "performance": sim["overall_performance"],
                "fragmentation": sim["fragmentation"]["overall"],
                "actions": list(r.actions),
                "advice": r.advice,
            }
        )
    costs = [t["cost"] for t in timeline]
    frags = [t["fragmentation"] for t in timeline]
    # The snapshot integral is *dollars*: it prices open bins at their
    # true billed rent (`BinType.billed_rent`), not the plan's decision
    # cost — under a risk-adjusted catalog the two differ, and only the
    # rent integral keeps the invariant billed_cost >= integral.  With
    # un-adjusted catalogs rent == cost, so this is bit-identical to the
    # historical cost integral.
    integral = float(
        sum(c * (t1 - t0) for c, t0, t1 in zip(rents, times, ends))
    )
    billed = ledger.billed_cost(max(horizon, times[-1]))
    # Per-tier SLA rollup: every stream that ever existed counts against
    # its tier (removal does not forgive an already-blown budget).
    sla: dict[str, dict] = {}
    sla_violations = 0
    for name, tier in sorted(tiers.items()):
        bucket = sla.setdefault(
            tier.name,
            {
                "streams": 0,
                "violations": 0,
                "blackout_stream_seconds": 0.0,
                "rung_stream_hours": 0.0,
                "parked_stream_hours": 0.0,
            },
        )
        bucket["streams"] += 1
        dark_s = blackout_by.get(name, 0.0) * 3600.0
        bucket["blackout_stream_seconds"] += dark_s
        bucket["rung_stream_hours"] += rung_hours_by.get(name, 0.0)
        bucket["parked_stream_hours"] += parked_hours_by.get(name, 0.0)
        if dark_s > tier.blackout_budget_s:
            bucket["violations"] += 1
            sla_violations += 1
    return {
        "timeline": timeline,
        "mean_cost": float(np.mean(costs)) if costs else 0.0,
        "final_cost": costs[-1] if costs else 0.0,
        "total_migrations": sum(t["migrations"] for t in timeline),
        "consolidations": sum(
            any(a.startswith("consolidate") for a in t["actions"])
            for t in timeline
        ),
        "mean_fragmentation": float(np.mean(frags)) if frags else 0.0,
        "final_fragmentation": frags[-1] if frags else 0.0,
        "warm_steps": sum(t["mode"] == "warm" for t in timeline),
        "full_steps": sum(t["mode"] == "full" for t in timeline),
        "target": target,
        "target_misses": misses,
        # ---- lifecycle & billing (new in the timed-trace refactor) ----
        "horizon": max(horizon, times[-1]),
        "billed_cost": billed,
        "snapshot_cost_integral": integral,
        "billed_overhead": (billed / integral - 1.0) if integral > 0 else 0.0,
        "degraded_stream_seconds": degraded_hours * 3600.0,
        # ---- spot / preemption (zero on hazard-free traces) ----
        "preemptions": sum(
            1 for rec in ledger.records() if rec.preempted_at is not None
        ),
        "preemption_degraded_stream_seconds": preempt_degraded_hours * 3600.0,
        # ---- SLA tiers & graceful degradation (zero without tiers) ----
        "blackout_stream_seconds": float(sum(blackout_by.values())) * 3600.0,
        "notice_tail_stream_seconds": notice_tail_hours * 3600.0,
        "utility_penalty": utility_penalty,
        "sla": sla,
        "sla_violations": sla_violations,
        "instance_records": [
            {
                "uid": rec.uid,
                "instance_type": rec.instance_type,
                "hourly_cost": rec.hourly_cost,
                "provisioned_at": rec.provisioned_at,
                "running_at": rec.running_at,
                "terminated_at": rec.terminated_at,
                "preempted_at": rec.preempted_at,
                "billed": ledger.billed_instance(
                    rec.uid, max(horizon, times[-1])
                ),
            }
            for rec in ledger.records()
        ],
    }
