"""Instance lifecycle & billing engine: what the fleet actually *costs*.

The paper's objective is monetary cost at the cloud's billing granularity,
not an instantaneous $/hr snapshot.  This module makes time first-class on
the cost side:

* `BillingModel` — the cloud contract: boot latency (an instance is billed
  from launch but serves nothing until it finishes PROVISIONING), billing
  quantum (hourly vs per-second vs continuous), and a minimum billed
  duration.  Contracts resolve *per instance type* through
  `LifecycleEngine.billing_for` — a ``billing_by_type`` map layered over
  the global default (spot and on-demand bill differently); global-only
  configurations are bit-identical to the single-model engine.
* `InstanceRecord` + `LifecycleEngine` — a per-instance state machine

      PROVISIONING -> RUNNING -> DRAINING -> TERMINATED

  driven by `provision` / `decommission` / `preempt` (forced spot
  interruption: no drain window) calls at monotone timestamps, and
  an accountant that integrates *billed* cost over the timeline: every
  instance is billed from its provisioning instant to its termination
  instant, rounded up to the quantum, minimum-duration floored — including
  the double-billing window while a migration's destination boots and the
  source keeps draining.

The billed/instantaneous distinction flips decisions: under hourly billing
evacuating a bin mid-quantum saves nothing (the quantum is already paid),
so the controller's consolidation certification and the lookahead
autoscaler's warm-spare ledger both run through this engine
(`core.controller.FleetController.lifecycle`).

Invariants (property-tested in ``tests/test_lifecycle.py``):

* billed cost is monotone in ``until`` and never below the instantaneous
  integral ``sum_i cost_i * lifetime_i`` clipped to the window;
* with a zero quantum (continuous, the per-second limit) and zero boot
  latency, billed cost equals the snapshot integral bit for bit;
* DRAINING and TERMINATED instances accept no new placements.
"""
from __future__ import annotations

import dataclasses
import enum
import math

__all__ = [
    "InstanceState",
    "BillingModel",
    "HOURLY",
    "PER_SECOND",
    "CONTINUOUS",
    "InstanceRecord",
    "LifecycleEngine",
    "estimate_hazards",
]

_EPS = 1e-9


class InstanceState(enum.Enum):
    PROVISIONING = "provisioning"  # launched, booting: billed, serves nothing
    RUNNING = "running"  # serving; accepts placements
    DRAINING = "draining"  # scheduled for termination; accepts nothing new
    TERMINATED = "terminated"  # gone; billing closed


@dataclasses.dataclass(frozen=True)
class BillingModel:
    """The cloud's billing contract for one instance.

    ``boot_hours``: PROVISIONING duration — billed, but the instance
    serves no streams until it elapses.  ``quantum_hours``: the billing
    quantum; durations round *up* to a whole number of quanta (1.0 =
    hourly, 1/3600 = literal per-second).  ``0.0`` means continuous
    billing — the per-second limit at hour-scale horizons, and the exact
    model under which billed cost reproduces instantaneous-snapshot
    integrals bit for bit.  ``min_billed_hours``: minimum duration billed
    once an instance is provisioned at all.
    """

    boot_hours: float = 0.0
    quantum_hours: float = 0.0
    min_billed_hours: float = 0.0

    def __post_init__(self) -> None:
        for field in ("boot_hours", "quantum_hours", "min_billed_hours"):
            v = getattr(self, field)
            if v < 0 or v != v:
                raise ValueError(f"BillingModel.{field} must be >= 0, got {v}")

    def billed_hours(self, duration: float) -> float:
        """Billable hours for an instance alive ``duration`` hours.

        Rounds up to the quantum (with a relative epsilon so durations
        that are whole quanta up to float noise do not bill an extra one)
        and applies the minimum-duration floor.  Never below ``duration``
        itself — the invariant billed >= instantaneous rests on this.
        """
        if duration <= 0.0:
            return 0.0
        billed = duration
        q = self.quantum_hours
        if q > 0.0:
            billed = math.ceil(duration / q - _EPS) * q
        return max(billed, duration, self.min_billed_hours)

    def next_boundary(self, provisioned_at: float, at: float) -> float:
        """First billing-quantum boundary at or after ``at``.

        Terminating before it is billed identically to terminating *at*
        it — the instant consolidation savings actually start accruing.
        """
        elapsed = max(0.0, at - provisioned_at)
        return provisioned_at + self.billed_hours(elapsed)


#: AWS-classic hourly billing with a 2-minute boot.
HOURLY = BillingModel(boot_hours=2.0 / 60.0, quantum_hours=1.0)
#: Per-second billing (same boot); at hour-scale horizons the second-level
#: round-up is below float display precision, so the continuous model is
#: used — it is the exact per-second limit and keeps the zero-boot case
#: bit-identical to snapshot-cost integrals.
PER_SECOND = BillingModel(boot_hours=2.0 / 60.0, quantum_hours=0.0)
#: The timeless pre-lifecycle model: boots instantly, bills continuously.
CONTINUOUS = BillingModel()


@dataclasses.dataclass
class InstanceRecord:
    """One instance's lifetime: timestamps are hours since trace start.

    ``running_at = provisioned_at + boot``; ``draining_at`` /
    ``terminated_at`` stay None while the instance serves.  A termination
    scheduled in the future (a drain window) shows as DRAINING until it
    elapses.  ``preempted_at`` marks a *forced* termination (the cloud
    reclaimed a spot instance): set by `LifecycleEngine.preempt`, always
    equal to ``terminated_at`` when set — there is no drain window, the
    instance is gone the moment the interruption lands.
    """

    uid: int
    instance_type: str
    hourly_cost: float  # the *current* rate; history in rate_history
    provisioned_at: float
    running_at: float
    draining_at: float | None = None
    terminated_at: float | None = None
    preempted_at: float | None = None
    #: Set by `LifecycleEngine.notice`: the cloud warned at ``noticed_at``
    #: that this instance dies at ``notice_deadline``.  A notice is not a
    #: termination — the record keeps billing until decommissioned or
    #: killed (a false alarm bills forever) — but a noticed instance
    #: accepts no new placements.
    noticed_at: float | None = None
    notice_deadline: float | None = None
    #: (since, $/hr) rate segments, first entry at provisioned_at.  Price
    #: changes append here (`LifecycleEngine.reprice`) so billing stays
    #: causal: hours already billed keep the rate they were billed at.
    rate_history: list = dataclasses.field(default_factory=list)

    def state(self, at: float) -> InstanceState:
        if self.terminated_at is not None and at >= self.terminated_at:
            return InstanceState.TERMINATED
        if self.draining_at is not None and at >= self.draining_at:
            return InstanceState.DRAINING
        if at < self.running_at:
            return InstanceState.PROVISIONING
        return InstanceState.RUNNING

    def accepting(self, at: float) -> bool:
        """May new placements target this instance at time ``at``?

        PROVISIONING instances accept (placements wait out the boot —
        that wait is the degraded window the autoscaler pre-provisions
        away); DRAINING and TERMINATED ones never do, and neither does an
        instance under an interruption notice — it is living on the
        cloud's borrowed time.
        """
        if self.noticed_at is not None and at >= self.noticed_at:
            return False
        return self.state(at) in (
            InstanceState.PROVISIONING,
            InstanceState.RUNNING,
        )

    def lifetime_hours(self, until: float) -> float:
        """Wall-clock hours alive within ``[provisioned_at, until]``."""
        end = until if self.terminated_at is None else min(until, self.terminated_at)
        return max(0.0, end - self.provisioned_at)


class LifecycleEngine:
    """The fleet's lifecycle ledger + billed-cost accountant.

    Owned by a `FleetController`; also usable standalone (the benchmarks
    and property tests drive it directly).  All mutation timestamps must be
    non-decreasing per instance; billing queries are pure.

    ``billing`` is the global default contract; ``billing_by_type`` maps
    instance-type names to per-type `BillingModel`s layered over it (real
    clouds bill spot and on-demand differently — boot, quantum, and
    minimum duration all resolve through `billing_for`).  A global-only
    configuration (``billing_by_type`` empty or None) is bit-identical to
    the pre-map engine.
    """

    def __init__(
        self,
        billing: BillingModel | None = None,
        *,
        billing_by_type: dict[str, BillingModel] | None = None,
    ) -> None:
        self.billing = billing if billing is not None else BillingModel()
        self.billing_by_type = dict(billing_by_type or {})
        self._records: dict[int, InstanceRecord] = {}
        #: Monotone mutation counter: bumped by every state change, so
        #: aggregate caches (e.g. the sharded merged ledger) can memoize
        #: per-engine query results and invalidate only on real mutation.
        self.version = 0

    def billing_for(self, instance_type: str) -> BillingModel:
        """The billing contract for one instance type (map over default)."""
        return self.billing_by_type.get(instance_type, self.billing)

    # ------------------------------------------------------------ mutation

    def provision(
        self, uid: int, instance_type: str, hourly_cost: float, at: float
    ) -> InstanceRecord:
        """Launch an instance: billed from ``at``, RUNNING at ``at+boot``."""
        if uid in self._records:
            raise ValueError(f"instance uid {uid} already provisioned")
        rec = InstanceRecord(
            uid=uid,
            instance_type=instance_type,
            hourly_cost=hourly_cost,
            provisioned_at=at,
            running_at=at + self.billing_for(instance_type).boot_hours,
            rate_history=[(at, hourly_cost)],
        )
        self._records[uid] = rec
        self.version += 1
        return rec

    def adopt_running(
        self, uid: int, instance_type: str, hourly_cost: float, at: float
    ) -> InstanceRecord:
        """Register an instance as already RUNNING at ``at`` (no boot).

        Used when a billing model is installed on a live controller whose
        instances predate the ledger: their boot is history, only their
        forward billing is modeled.
        """
        rec = self.provision(uid, instance_type, hourly_cost, at)
        rec.running_at = at
        self.version += 1
        return rec

    def decommission(
        self, uid: int, at: float, *, drain_until: float | None = None
    ) -> InstanceRecord:
        """Retire an instance: DRAINING from ``at``, TERMINATED at
        ``drain_until`` (default: immediately at ``at``).

        The drain window models migration hand-off — the source instance
        keeps serving its streams (and keeps being billed) until the
        destination finishes booting; during it the fleet double-bills.

        A ``drain_until`` in the past (``< at``) is **clamped to ``at``**:
        the deadline already elapsed, so the retirement is an instant kill
        at ``at`` — never a termination scheduled before the decommission
        instant, which would rewrite billed history.  This clamp is
        contractual (regression-tested): `FleetController._sync_lifecycle`
        computes drain deadlines from *previously recorded* boot completions
        and relies on stale ones collapsing to "terminate now".
        """
        rec = self._records[uid]
        if rec.terminated_at is not None:
            raise ValueError(f"instance uid {uid} already terminated")
        end = at if drain_until is None else max(at, drain_until)
        rec.draining_at = at
        rec.terminated_at = end
        self.version += 1
        return rec

    def notice(self, uid: int, at: float, deadline: float) -> InstanceRecord:
        """Record a cloud interruption warning: ``uid`` dies at ``deadline``.

        The record keeps billing — a notice is a warning, not a
        termination, and a false alarm (notice never followed by a kill)
        bills forever — but `InstanceRecord.accepting` turns False from
        ``at`` so the controller drains ahead of the kill instead of
        placing new work on doomed capacity.  Valid on an
        already-DRAINING record (the warning just annotates the scheduled
        retirement); re-noticing updates the deadline.
        """
        rec = self._records[uid]
        if deadline < at or deadline != deadline:
            raise ValueError(
                f"notice deadline must be >= {at}, got {deadline}"
            )
        if rec.terminated_at is not None and rec.terminated_at <= at:
            raise ValueError(
                f"instance uid {uid} already terminated at "
                f"t={rec.terminated_at}: cannot notice at t={at}"
            )
        if rec.noticed_at is None:
            rec.noticed_at = at
        rec.notice_deadline = deadline
        self.version += 1
        return rec

    def preempt(self, uid: int, at: float) -> InstanceRecord:
        """Forcibly terminate an instance at ``at`` (a spot interruption).

        No drain window — the cloud reclaims the capacity immediately, so
        any streams it served are down until a replacement boots (that
        boot wait is charged to degraded time by the simulator, unlike a
        planned migration's make-before-break hand-off).  Billing closes
        exactly as a `decommission` at the same instant would: the cloud's
        quantum rules still round the final partial quantum up.

        A kill may land *inside* a scheduled drain window (the controller
        evacuated a noticed instance, then the cloud reclaimed it before
        the planned drain end): the future termination restates to ``at``
        — no billed history is rewritten, the cancelled span had not
        elapsed yet.  A termination already in the past still raises.
        """
        rec = self._records[uid]
        if rec.terminated_at is not None and rec.terminated_at <= at:
            raise ValueError(f"instance uid {uid} already terminated")
        rec.draining_at = at if rec.draining_at is None else min(rec.draining_at, at)
        rec.terminated_at = at
        rec.preempted_at = at
        self.version += 1
        return rec

    def reprice(self, uid: int, at: float, hourly_cost: float) -> None:
        """Change an instance's rent going forward from ``at``.

        Hours already billed keep the rate they were billed at (a new
        segment is appended; history is never restated) — only the
        portion of the billed span past ``at`` prices at the new rate.
        Once a termination is on record, re-pricing is valid only inside
        the drain window ``[draining_at, terminated_at)`` — a DRAINING
        instance still billing future hours may re-price; ``at`` at or
        past ``terminated_at`` (the segment could never bill) or before
        ``draining_at`` (an out-of-order call restating hours billed
        before the retirement) raises, mirroring `decommission`'s
        already-terminated guard.
        """
        rec = self._records[uid]
        if rec.terminated_at is not None and (
            at >= rec.terminated_at
            or (rec.draining_at is not None and at < rec.draining_at)
        ):
            raise ValueError(
                f"instance uid {uid} terminated at t={rec.terminated_at}: "
                f"cannot re-price at t={at}"
            )
        since = max(at, rec.rate_history[-1][0])
        rec.rate_history.append((since, hourly_cost))
        rec.hourly_cost = hourly_cost
        self.version += 1

    # ------------------------------------------------------------- queries

    def record(self, uid: int) -> InstanceRecord:
        return self._records[uid]

    def __contains__(self, uid: int) -> bool:
        return uid in self._records

    def records(self) -> tuple[InstanceRecord, ...]:
        return tuple(self._records.values())

    def state(self, uid: int, at: float) -> InstanceState:
        return self._records[uid].state(at)

    def accepting(self, uid: int, at: float) -> bool:
        return self._records[uid].accepting(at)

    def alive(self, at: float) -> tuple[int, ...]:
        """Uids not yet terminated at ``at`` (drain windows included)."""
        return tuple(
            uid
            for uid, r in self._records.items()
            if r.state(at) is not InstanceState.TERMINATED
        )

    def _priced(self, rec: InstanceRecord, hours: float) -> float:
        """$ for the first ``hours`` billable hours of ``rec``.

        Under quantized billing each quantum prices at the rate in effect
        when the quantum *started* — a re-price mid-quantum cannot restate
        a quantum already bought (nor its round-up tail).  Continuous
        billing prices exact rate-segment overlap.
        """
        if hours <= 0.0:
            return 0.0
        start = rec.provisioned_at
        hist = rec.rate_history or [(start, rec.hourly_cost)]
        if len(hist) == 1:
            return hist[0][1] * hours
        end = start + hours
        q = self.billing_for(rec.instance_type).quantum_hours
        if q > 0.0:

            def rate_at(t: float) -> float:
                rate = hist[0][1]
                for since, r in hist:
                    if since <= t + _EPS:
                        rate = r
                    else:
                        break
                return rate

            total, s = 0.0, start
            while s < end - _EPS:
                total += rate_at(s) * min(q, end - s)
                s += q
            return total
        total = 0.0
        for i, (since, rate) in enumerate(hist):
            seg_end = hist[i + 1][0] if i + 1 < len(hist) else end
            total += rate * max(0.0, min(seg_end, end) - max(since, start))
        return total

    def billed_instance(self, uid: int, until: float) -> float:
        """Dollars billed for one instance as of time ``until``.

        An open (or still-draining) instance is billed for its in-progress
        quantum in full — the cloud's round-up, and the reason evacuating
        a bin mid-quantum saves nothing.
        """
        rec = self._records[uid]
        if until <= rec.provisioned_at:
            return 0.0
        billing = self.billing_for(rec.instance_type)
        return self._priced(rec, billing.billed_hours(rec.lifetime_hours(until)))

    def billed_cost(self, until: float) -> float:
        """Total dollars billed across the fleet as of time ``until``."""
        return sum(self.billed_instance(uid, until) for uid in self._records)

    def instantaneous_integral(self, until: float) -> float:
        """``sum_i integral of rate_i dt`` over each instance's lifetime —
        the pre-lifecycle snapshot integral billed cost is lower-bounded
        by (piecewise over rate segments, so re-pricing keeps the bound)."""
        return sum(
            self._priced(r, r.lifetime_hours(until))
            for r in self._records.values()
        )

    def termination_saving(self, uid: int, at: float, until: float) -> float:
        """Billed dollars saved by terminating ``uid`` at ``at`` instead of
        keeping it through ``until`` — zero while ``until`` stays inside
        the already-paid quantum."""
        rec = self._records[uid]
        billing = self.billing_for(rec.instance_type)
        keep = billing.billed_hours(max(0.0, until - rec.provisioned_at))
        cut = billing.billed_hours(max(0.0, at - rec.provisioned_at))
        return max(0.0, self._priced(rec, keep) - self._priced(rec, cut))


def estimate_hazards(
    engine: LifecycleEngine,
    *,
    until: float | None = None,
    min_exposure_hours: float = 0.0,
) -> dict[str, float]:
    """Empirical per-type interruption rates from the ledger.

    The maximum-likelihood estimate for a Poisson interruption process:
    ``lambda_hat[type] = preemptions observed / instance-hours exposed``,
    pooling every instance of the type the ledger has ever tracked
    (terminated instances contribute their whole lifetime; live ones
    their lifetime so far).  ``until`` bounds the observation window and
    defaults to the latest timestamp on record, so a standalone ledger
    can be estimated without knowing the trace clock.  Types with less
    than ``min_exposure_hours`` of exposure are omitted — an estimate off
    minutes of data is noise, and omission lets the caller keep its prior
    (`policy.risk_adjusted_catalog(hazards=...)` falls back to the
    catalog's static hazard for missing names).

    Feeding the result back through `policy.risk_adjusted_catalog` closes
    the loop the static catalog guesses at: allocation prices eviction
    risk at the rate the cloud has actually been evicting.
    """
    if until is None:
        until = 0.0
        for rec in engine.records():
            for stamp in (
                rec.provisioned_at, rec.terminated_at, rec.noticed_at
            ):
                if stamp is not None and stamp > until:
                    until = stamp
    hours: dict[str, float] = {}
    hits: dict[str, int] = {}
    for rec in engine.records():
        hours[rec.instance_type] = (
            hours.get(rec.instance_type, 0.0) + rec.lifetime_hours(until)
        )
        if rec.preempted_at is not None and rec.preempted_at <= until:
            hits[rec.instance_type] = hits.get(rec.instance_type, 0) + 1
    return {
        name: hits.get(name, 0) / exposure
        for name, exposure in hours.items()
        if exposure > max(min_exposure_hours, _EPS)
    }
