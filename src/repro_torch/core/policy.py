"""Re-planning policies: *when* to migrate, re-price, and resize the fleet.

`core.controller.FleetController` is pure mechanism — event diffing,
incremental `ProblemTensors`, pinned/warm sub-solves, dual certification.
This module is the policy layer on top: after every event the controller
hands its `ReplanResult` to a `ReplanPolicy`, which may drive the
mechanism's policy-facing surface (`placement_state` / `try_migrate` /
`refresh_prices` / `what_if`) and amend the result before it ships.

Three concrete policies (plus the identity and a combinator):

* `PinningPolicy` — the identity: pure pinning, never migrates.  With it,
  the controller behaves bit for bit like the pre-policy one.
* `ConsolidationPolicy` — bounded-migration consolidation.  After each
  warm re-plan it scores every placed stream against every *other* bin's
  residual in one batched `heuristics.evacuation_scores` dispatch, picks
  whole bins whose members can all relocate (≤ ``max_migrations`` streams
  per event, best cost-per-move first), and asks the mechanism to
  exact-solve the migration sub-problem — adopted only when the move
  certifies a strict cost reduction.  ``max_migrations=0`` is a no-op.
* `DualPriceAgingPolicy` — tracks certified-gap decay: when the gap at
  acceptance exceeds half the controller's ``gap_threshold`` for
  ``patience`` consecutive events, the covering-LP dual prices are
  refreshed (`arcflow.dual_prices` via `refresh_prices`) so certification
  stays honest between full re-solves.
* `LookaheadAutoscaler` — lookahead provisioning: expands a join/leave
  `StreamForecast` into its fleet cone (`streams.forecast_cone`), scores
  every cone fleet through `what_if`'s batched scan kernel in one launch,
  and runs a lattice DP to pick the cheapest provisioning path from the
  current fleet to the forecast horizon.  The chosen path and its cost
  profile ship as `ReplanResult.advice`.
* `ActingAutoscaler` — the acting form: everything the lookahead does,
  plus it *holds warm spare instances* ahead of the forecast joins —
  `FleetController.pre_provision` launches (and bills, through the
  lifecycle ledger) one cheapest-host spare per imminent forecast join,
  the next re-plan that opens a bin of that type consumes the spare's
  already-booted uid, and spares the forecast no longer wants are
  released.  Joins land on warm capacity instead of waiting out a boot.
* `GracefulDegradationPolicy` — SLA-tiered load shedding.  When a storm
  (preemption or reclamation notice) or a protected join leaves streams
  placed on still-booting instances, it degrades the least-protected
  running streams one rung down their `streams.SLATier` rate ladder
  (`FleetController.set_stream_rung`) and asks the mechanism to re-home
  the stranded victims into the freed warm residual (`try_migrate` — the
  exact sub-solve is still the arbiter); parkable stranded victims park
  as a last resort.  After ``restore_patience`` calm events it unparks
  and restores rungs, most-protected first.  On a default-tier fleet
  every ladder has one rung and nothing is parkable, so the policy is
  exactly `PinningPolicy` — the bit-identity regression anchor.
* `CompositePolicy` — folds several policies left to right (e.g.
  consolidate, then age prices, then attach autoscaling advice).

`ConsolidationPolicy` is billing-aware when given a ``billing_horizon``:
the mechanism then certifies each move against *billed* dollars over that
horizon through the lifecycle ledger (`core.lifecycle`) — under hourly
billing, evacuating a bin whose quantum is already paid saves nothing, so
moves the instantaneous $/hr test accepts get rejected.

Policies are stateful per controller (aging streaks, for one): construct a
fresh instance per `FleetController` / `ResourceManager.controller` call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .binpack import heuristics
from .binpack.problem import InfeasibleError
# Cycle-free: controller.py imports this module only lazily (inside
# FleetController.__init__), so the gap helper is shared, not duplicated.
from .controller import _gap
from .streams import (
    FleetEvent,
    InstancePreempted,
    InstancePreemptionNotice,
    StreamAdded,
    StreamForecast,
    StreamSpec,
    forecast_cone,
)

__all__ = [
    "ReplanPolicy",
    "PinningPolicy",
    "ConsolidationPolicy",
    "DualPriceAgingPolicy",
    "LookaheadAutoscaler",
    "ActingAutoscaler",
    "GracefulDegradationPolicy",
    "CompositePolicy",
    "ArrivalRateEstimator",
    "cheapest_provisioning_path",
    "spot_effective_cost",
    "risk_adjusted_catalog",
]

_EPS = 1e-9


def spot_effective_cost(
    bin_type,
    billing=None,
    *,
    billing_by_type=None,
    degraded_penalty: float = 0.0,
) -> float:
    """Risk-adjusted hourly cost of a (possibly spot) instance type.

        effective = rent + hazard x (re-placement penalty per preemption)

    where the per-preemption penalty is the replacement's double-billed
    boot (``boot_hours x rent`` — when the cloud reclaims a spot bin, its
    streams re-place onto a fresh instance that bills while it boots, and
    under quantized billing the killed bin's in-progress quantum is paid
    but unused, conservatively folded into the same boot term) plus
    ``boot_hours x degraded_penalty`` — the operator's dollar price on one
    stream-hour of post-preemption degradation, scaled by the boot the
    displaced streams wait out.  On-demand types (hazard 0) pass through
    unchanged.  Billing contracts resolve per type, mirroring
    `core.lifecycle.LifecycleEngine.billing_for`.
    """
    if bin_type.hazard <= 0.0:
        return bin_type.cost
    billing = (billing_by_type or {}).get(bin_type.name, billing)
    boot = billing.boot_hours if billing is not None else 0.0
    penalty = boot * (bin_type.billed_rent + degraded_penalty)
    return bin_type.billed_rent + bin_type.hazard * penalty


def risk_adjusted_catalog(
    catalog,
    billing=None,
    *,
    billing_by_type=None,
    degraded_penalty: float = 0.0,
    hazards: "dict[str, float] | None" = None,
):
    """Price a catalog's spot types at their risk-adjusted effective cost.

    Returns a catalog whose spot entries carry ``cost = effective`` (what
    the packer, the warm re-plan, and the consolidation certification all
    minimize — eviction risk now weighs against rent everywhere decisions
    are made) while ``rent`` keeps the true discounted $/hr (what the
    lifecycle ledger actually bills — see `BinType.billed_rent`).
    On-demand entries are returned untouched, so a hazard-free catalog is
    bit-identical under this transform.

    ``hazards`` overrides interruption rates per type name before
    pricing — the online-estimation loop: feed it
    `lifecycle.estimate_hazards(engine)` and allocation prices eviction
    risk at the *observed* rate instead of the catalog's static guess.
    Names absent from the map keep their static hazard; an override may
    also put a rate on a type whose static hazard is 0 (the cloud
    started reclaiming something the catalog called safe).
    """
    out = []
    for bt in catalog:
        lam = bt.hazard if hazards is None else hazards.get(bt.name, bt.hazard)
        if lam != bt.hazard:
            bt = dataclasses.replace(bt, hazard=lam)
        if bt.hazard <= 0.0:
            out.append(bt)
            continue
        eff = spot_effective_cost(
            bt,
            billing,
            billing_by_type=billing_by_type,
            degraded_penalty=degraded_penalty,
        )
        out.append(dataclasses.replace(bt, cost=eff, rent=bt.billed_rent))
    return tuple(out)


class ReplanPolicy:
    """Base policy: both hooks return the mechanism result unchanged.

    ``mech`` is the calling `FleetController`; hooks may mutate fleet
    state only through its policy-facing surface and must return a
    `ReplanResult` (usually ``dataclasses.replace`` of the input, with
    `actions` recording what was done).
    """

    def on_reset(self, mech, result):
        return result

    def on_event(self, mech, event: FleetEvent, result):
        return result


class PinningPolicy(ReplanPolicy):
    """Pure pinning — never migrate, re-price, or resize (the default)."""


@dataclasses.dataclass
class ConsolidationPolicy(ReplanPolicy):
    """Bounded-migration consolidation after each warm re-plan.

    Evacuation candidates are whole bins: a bin qualifies when every
    member can relocate into some *other* bin's residual (per the batched
    scoring kernel) and its member count fits the remaining migration
    budget.  Candidates are taken best cost-per-move first; the selected
    members go through `FleetController.try_migrate`, whose exact pinned
    sub-solve is the arbiter — a move that does not certify a saving above
    ``min_saving`` rolls back, so the certified cost never increases.
    """

    max_migrations: int = 3  # k: migration budget per event
    min_saving: float = 0.0  # $/h a move must save to be adopted
    max_nodes: int | None = None  # sub-solve budget (None: controller default)
    #: Certify moves against *billed* dollars over this many hours through
    #: the controller's lifecycle ledger (None: instantaneous $/hr only,
    #: the billing-blind historical behaviour).  Under quantized billing
    #: this rejects evacuations whose rent is already sunk.
    billing_horizon: float | None = None
    #: When whole-bin evacuation finds nothing, also consider a
    #: partial-bin exchange (`select_swap`): close a bin whose blocked
    #: member needs a donor evicted from a neighbour first.  Off by
    #: default — swaps search a strictly larger move space per event.
    swap_moves: bool = False

    def on_event(self, mech, event, result):
        # Warm re-plans (noop included — drift survives unchanged fleets)
        # only: full re-solves just re-packed everything.
        if self.max_migrations <= 0 or result.mode not in ("warm", "noop"):
            return result
        route = "consolidate"
        names = self.select_evacuations(mech)
        if not names and self.swap_moves:
            names = self.select_swap(mech)
            route = "swap"
        if not names:
            return result
        mig = mech.try_migrate(
            names,
            max_nodes=self.max_nodes,
            min_saving=self.min_saving,
            billing_horizon=self.billing_horizon,
        )
        if not mig.accepted:
            if mig.billed_delta is not None:
                # Rate-cheaper but billed-pointless: the quantum was sunk.
                # (Named so it does NOT count as a "consolidate" action.)
                return dataclasses.replace(
                    result,
                    actions=result.actions
                    + (f"billed-reject:{route}:{mig.billed_delta:+.4f}",),
                )
            return result
        saving = mig.cost_before - mig.cost_after
        action = f"{route}:{len(mig.migrated)}:-${saving:.4f}"
        if mig.billed_delta is not None:
            action += f":billed{mig.billed_delta:+.4f}"
        return dataclasses.replace(
            result,
            plan=mech.plan,
            migrated=tuple(sorted(set(result.migrated) | set(mig.migrated))),
            lower_bound=mig.lower_bound,
            gap=mig.gap,
            nodes=result.nodes + mig.nodes,
            actions=result.actions + (action,),
        )

    def select_evacuations(self, mech) -> tuple[str, ...]:
        """Pick ≤ ``max_migrations`` streams whose bins look evacuable.

        Two evacuation routes per candidate bin, both scored from one
        `evacuation_scores` dispatch plus the memoized per-item cheapest
        hosting cost:

        * **residual route** — every member fits some *other* bin's
          residual: closing the bin can save up to its full rent;
        * **fresh route** — the members' summed lone-hosting cost is below
          the bin's rent (a drained expensive instance): re-homing them
          onto fresh cheaper instances saves at least the difference.

        Whole bins only (a partial evacuation closes nothing), best
        estimated saving per migration first.  The greedy pass merely
        filters obviously doomed moves — feasibility and the certified
        saving of the combined move are the exact sub-solve's job.
        """
        state = mech.placement_state()
        n_bins = state.resid.shape[0]
        if n_bins < 2 or not state.names:
            return ()
        scores = heuristics.evacuation_scores(
            state.req, state.choice_mask, state.resid, state.owner
        )
        finite = np.isfinite(scores).any(axis=1)  # (n, P): relocatable to bin p
        relocatable = finite.any(axis=1)  # (n,)
        idx_of = {name: i for i, name in enumerate(state.names)}
        candidates = []  # (-saving_per_move, size, b_i, needs_residual)
        for b_i, members in enumerate(state.members):
            size = len(members)
            if not 0 < size <= self.max_migrations:
                continue
            rent = float(state.bin_costs[b_i])
            idx = [idx_of[m] for m in members]
            fresh_cost = float(state.cheapest_host[idx].sum())
            if all(relocatable[i] for i in idx):
                # Residual route: closing the bin can save its full rent.
                candidates.append((-(rent / size), size, b_i, True))
            elif fresh_cost < rent - self.min_saving - _EPS:
                candidates.append((-((rent - fresh_cost) / size), size, b_i, False))
        candidates.sort()
        budget = self.max_migrations
        allowed = np.ones(n_bins, dtype=bool)  # bins still offering residual
        names: list[str] = []
        for _, size, b_i, needs_residual in candidates:
            if size > budget:
                continue
            trial = allowed.copy()
            trial[b_i] = False
            members = state.members[b_i]
            # Residual-route members must still reach a bin not already
            # slated for evacuation (their own bin is inf-masked by the
            # kernel); fresh-route bins only need their rent arbitrage.
            if needs_residual and not all(
                finite[idx_of[m]][trial].any() for m in members
            ):
                continue
            allowed = trial
            names += members
            budget -= size
            if budget == 0:
                break
        return tuple(names)

    def select_swap(self, mech) -> tuple[str, ...]:
        """Pick a partial-bin exchange whole-bin evacuation cannot reach.

        Pattern: a closing bin has exactly one *blocked* member (no other
        bin's residual fits it), but evicting a single **donor** stream
        from a neighbour bin opens enough slack there to host it — the
        donor itself relocating onto a third bin.  Whole-bin selection
        can never find this (the blocked member disqualifies its bin, and
        the donor's bin is not closing), yet `try_migrate` over
        ``members(closing bin) + donor`` expresses it exactly: the
        donor's bin stays pinned at its *remaining* load, so the freed
        pair trades places under the exact sub-solve's certificate.
        Returns at most ``max_migrations`` names (closing bin + donor),
        or ``()`` when no such pattern exists.
        """
        state = mech.placement_state()
        n_bins = state.resid.shape[0]
        # Three bins minimum: the closer, the host, the donor's refuge.
        if n_bins < 3 or not state.names:
            return ()
        scores = heuristics.evacuation_scores(
            state.req, state.choice_mask, state.resid, state.owner
        )
        finite = np.isfinite(scores).any(axis=1)  # (n, P)
        relocatable = finite.any(axis=1)
        idx_of = {name: i for i, name in enumerate(state.names)}
        # Cheapest feasible requirement per item (the donor's freed slack
        # and the fit probe both use the most conservative choice).
        min_req = np.where(
            state.choice_mask[:, :, None], state.req, np.inf
        ).min(axis=1)
        order = sorted(range(n_bins), key=lambda b: -float(state.bin_costs[b]))
        for b1 in order:
            members = state.members[b1]
            if not 0 < len(members) < self.max_migrations:
                continue  # need budget room for the donor
            idx1 = [idx_of[m] for m in members]
            blocked = [i for i in idx1 if not relocatable[i]]
            if len(blocked) != 1:
                # 0 blocked: the whole-bin route already covers this bin;
                # 2+: one donor cannot unblock them all.
                continue
            blk = blocked[0]
            for b2 in range(n_bins):
                if b2 == b1:
                    continue
                for donor in state.members[b2]:
                    j = idx_of[donor]
                    third = np.ones(n_bins, dtype=bool)
                    third[b1] = third[b2] = False  # b1 closes, b2 hosts blk
                    if not finite[j][third].any():
                        continue
                    # Does the blocked member fit b2 once the donor leaves?
                    slack = state.resid[b2] + min_req[j]
                    fit = (
                        np.all(
                            state.req[blk] <= slack[None, :] + heuristics._FIT_EPS,
                            axis=-1,
                        )
                        & state.choice_mask[blk]
                    )
                    if fit.any():
                        return tuple(members) + (donor,)
        return ()


@dataclasses.dataclass
class DualPriceAgingPolicy(ReplanPolicy):
    """Refresh the dual prices when the certified gap stays wide.

    The mechanism refreshes prices only on full re-solves and price
    events, so long warm streaks certify against aging duals.  This policy
    counts consecutive events whose acceptance gap exceeds half the
    controller's ``gap_threshold``; at ``patience`` it refreshes
    (`FleetController.refresh_prices`) and re-certifies the shipped result
    against the tightened bound.
    """

    patience: int = 3  # m: consecutive wide-gap events before a refresh
    _streak: int = dataclasses.field(default=0, init=False, repr=False)

    def on_reset(self, mech, result):
        self._streak = 0
        return result

    def on_event(self, mech, event, result):
        if result.gap <= 0.5 * mech.gap_threshold:
            self._streak = 0
            return result
        self._streak += 1
        if self._streak < self.patience:
            return result
        self._streak = 0
        lb = mech.refresh_prices()
        if lb <= result.lower_bound + _EPS:
            # The refreshed duals did not tighten anything (the gap is
            # real, not stale) — record the attempt and move on.
            return dataclasses.replace(
                result, actions=result.actions + ("reprice:flat",)
            )
        return dataclasses.replace(
            result,
            lower_bound=lb,
            gap=_gap(result.plan.hourly_cost, lb),
            actions=result.actions + ("reprice",),
        )


def cheapest_provisioning_path(
    grid: np.ndarray,
) -> tuple[list[tuple[int, int]], float]:
    """Min-total-cost monotone path through a forecast-cone cost grid.

    ``grid[j, l]`` is the fleet cost with the first ``j`` forecast joins
    and first ``l`` leaves applied.  A provisioning path starts at the
    current fleet ``(0, 0)`` and absorbs one forecast event per step
    (``j`` or ``l`` advances by one) until the horizon corner: the DP
    returns the path minimizing the summed cost of every fleet passed
    through — i.e. the cheapest order in which to take the forecast.
    """
    grid = np.asarray(grid, dtype=np.float64)
    J, L = grid.shape
    dp = np.full((J, L), np.inf)
    dp[0, 0] = grid[0, 0]
    for j in range(J):
        for l in range(L):
            if j:
                dp[j, l] = min(dp[j, l], dp[j - 1, l] + grid[j, l])
            if l:
                dp[j, l] = min(dp[j, l], dp[j, l - 1] + grid[j, l])
    path = [(J - 1, L - 1)]
    j, l = J - 1, L - 1
    while (j, l) != (0, 0):
        if j and (not l or dp[j - 1, l] <= dp[j, l - 1]):
            j -= 1
        else:
            l -= 1
        path.append((j, l))
    path.reverse()
    return path, float(dp[J - 1, L - 1])


@dataclasses.dataclass
class ArrivalRateEstimator:
    """Online stream-arrival-rate estimation over observed join timestamps.

    The autoscalers' forecast plug point (`LookaheadAutoscaler.forecast`
    accepts a callable): instead of a static hand-written
    `StreamForecast`, this estimator watches the `StreamAdded` events the
    controller replays, maintains the Poisson maximum-likelihood arrival
    rate over a trailing window —

        lambda_hat = joins observed in the window / window hours

    (before a full window has elapsed, the unbiased ``(k - 1) / elapsed``
    form, which does not count the arrival that started the clock) —
    optionally EWMA-smoothed across events, and emits a forecast of
    ``min(max_joins, round(lambda_hat * horizon_hours))`` clones of
    ``template`` with fresh non-colliding names.  Returns ``None`` (no
    cone, autoscaler no-op) until enough arrivals have been seen.

    The estimator is stateful per controller, like every policy here:
    construct one per replay.  Timestamps come from ``event.at``, the
    same lifecycle clock `estimate_hazards` pools for interruption rates
    — both close an online-estimation loop a static catalog/forecast
    only guesses at.
    """

    #: Forecast joins are clones of this spec (name uniquified per join).
    template: StreamSpec
    #: How far ahead the emitted forecast looks, in trace hours.
    horizon_hours: float = 0.5
    #: Trailing observation window for the windowed MLE.
    window_hours: float = 2.0
    #: Cap on forecast joins per event (bounds the cone and, through
    #: `ActingAutoscaler.max_spares`, the warm-spare spend).
    max_joins: int = 4
    #: EWMA weight on the *previous* estimate (0 = pure windowed MLE).
    smoothing: float = 0.0
    _arrivals: list = dataclasses.field(default_factory=list, init=False, repr=False)
    _now: float = dataclasses.field(default=0.0, init=False, repr=False)
    _rate: float | None = dataclasses.field(default=None, init=False, repr=False)
    _seq: int = dataclasses.field(default=0, init=False, repr=False)

    def observe(self, event: FleetEvent | None) -> None:
        """Advance the clock; record the timestamp if it is a join."""
        at = getattr(event, "at", None)
        if at is None:
            return
        self._now = max(self._now, float(at))
        if not isinstance(event, StreamAdded):
            return
        self._arrivals.append(float(at))
        cut = self._now - self.window_hours
        self._arrivals = [t for t in self._arrivals if t > cut]
        inst = self._windowed_mle()
        if inst is None:
            return
        if self.smoothing > 0.0 and self._rate is not None:
            self._rate = self.smoothing * self._rate + (1 - self.smoothing) * inst
        else:
            self._rate = inst

    def _windowed_mle(self) -> float | None:
        arr = [t for t in self._arrivals if t > self._now - self.window_hours]
        if not arr:
            return None
        elapsed = self._now - arr[0]
        if elapsed + _EPS >= self.window_hours:
            return len(arr) / self.window_hours
        if len(arr) < 2 or elapsed <= _EPS:
            return None  # one arrival fixes no rate
        # Partial window: don't count the arrival that started the clock.
        return (len(arr) - 1) / elapsed

    @property
    def rate(self) -> float | None:
        """Current arrivals-per-hour estimate (None before warm-up)."""
        return self._rate

    def __call__(
        self, fleet: tuple[StreamSpec, ...], event: FleetEvent | None
    ) -> StreamForecast | None:
        self.observe(event)
        if self._rate is None:
            return None
        n = min(self.max_joins, int(round(self._rate * self.horizon_hours)))
        if n <= 0:
            return None
        live = {s.name for s in fleet}
        joins = []
        while len(joins) < n:
            name = f"{self.template.name}~a{self._seq}"
            self._seq += 1
            if name not in live:
                joins.append(dataclasses.replace(self.template, name=name))
        return StreamForecast(joins=tuple(joins))


@dataclasses.dataclass
class LookaheadAutoscaler(ReplanPolicy):
    """Lookahead provisioning over a join/leave forecast cone.

    ``forecast`` is either a static `StreamForecast` or a callable
    ``(fleet, event) -> StreamForecast | None`` evaluated per event (e.g.
    an arrival-rate estimator).  Each event: expand the cone, score every
    cone fleet through one batched `what_if` dispatch, DP the cheapest
    provisioning path, and attach the advice — the mechanism's plan is
    never modified (provisioning is advisory until streams actually join).
    """

    forecast: (
        StreamForecast
        | Callable[[tuple[StreamSpec, ...], FleetEvent | None], StreamForecast | None]
    ) = dataclasses.field(default_factory=StreamForecast)
    best_fit: bool = False

    def on_reset(self, mech, result):
        return self.on_event(mech, None, result)

    def _resolve(self, mech, event) -> StreamForecast | None:
        return (
            self.forecast(tuple(mech.fleet), event)
            if callable(self.forecast)
            else self.forecast
        )

    def on_event(self, mech, event, result):
        return self._advise(mech, self._resolve(mech, event), result)

    def _advise(self, mech, fc: StreamForecast | None, result):
        """Attach cone advice for an already-resolved forecast (resolved
        once per event so stateful/stochastic forecasters cannot diverge
        between the advisory and acting halves)."""
        if fc is None or (not fc.joins and not fc.leaves):
            return result
        try:
            advice = self.provision_advice(mech, fc)
        except (ValueError, KeyError, InfeasibleError) as e:
            # The lookahead is advisory and its fleets hypothetical: a
            # stale forecast (a leave that already left, a join no device
            # can serve) must not discard the committed re-plan result.
            return dataclasses.replace(
                result,
                actions=result.actions
                + (f"autoscale:invalid-forecast:{type(e).__name__}",),
            )
        return dataclasses.replace(
            result,
            advice=advice,
            actions=result.actions
            + (
                "autoscale:"
                f"peak=${advice['peak_cost']:.2f}"
                f":path=${advice['path_cost']:.2f}",
            ),
        )

    def provision_advice(self, mech, fc: StreamForecast) -> dict:
        """The cone's cost grid + cheapest path, from one what_if dispatch."""
        fleets = forecast_cone(mech.fleet, fc)
        costs = mech.what_if(fleets, best_fit=self.best_fit)
        grid = np.asarray(costs, dtype=np.float64).reshape(
            len(fc.joins) + 1, len(fc.leaves) + 1
        )
        path, path_cost = cheapest_provisioning_path(grid)
        current = float(grid[0, 0])
        peak = float(max(grid[j, l] for j, l in path))
        return {
            "grid": grid.tolist(),
            "path": path,
            "path_cost": path_cost,
            "current_cost": current,
            "horizon_cost": float(grid[-1, -1]),
            "peak_cost": peak,
            "recommended_headroom": max(0.0, peak - current),
        }


@dataclasses.dataclass
class ActingAutoscaler(LookaheadAutoscaler):
    """Acting pre-provisioning: hold warm spares ahead of forecast joins.

    Extends the advisory lookahead — same cone scoring, same attached
    advice — but *acts* on the forecast through the mechanism's lifecycle
    surface: the first ``max_spares`` forecast joins are replayed against
    the live fleet's residual capacity (`spare_demand`), and each join
    that fits nowhere gets one warm spare of the type the packer's open
    rule would launch (`FleetController.pre_provision`, billed from
    launch through the lifecycle ledger); held spares the forecast no
    longer wants are released.  When the join lands and the re-plan opens
    a bin of the spare's type, the spare's already-booted uid is consumed
    — the join serves immediately instead of degrading for one boot
    latency.

    The spend is bounded: at most ``max_spares`` spares are ever held, so
    the billed overhead per event is at most ``max_spares`` times the
    cheapest-host rent — the ≤5% overhead envelope the lifecycle
    benchmark gates.

    Spares are held to *absorb* boot waits, so an unreliable spare is
    worse than none: when the packer's open rule lands on a spot type
    whose interruption hazard exceeds ``max_spare_hazard`` (default 0.0 —
    only preemption-proof spares), the autoscaler holds the cheapest
    sufficiently-reliable host type instead; with no such type it holds
    nothing.  Hazard-free catalogs behave exactly as before.
    """

    max_spares: int = 2
    max_spare_hazard: float = 0.0

    def on_event(self, mech, event, result):
        fc = self._resolve(mech, event)
        result = self._advise(mech, fc, result)
        joins = fc.joins[: self.max_spares] if fc is not None else ()
        wanted = self.spare_demand(mech, joins)
        actions: list[str] = []
        held: dict[str, int] = {}
        for uid, bt in mech.spares.items():
            held[bt.name] = held.get(bt.name, 0) + 1
            if held[bt.name] > (wanted[bt.name][1] if bt.name in wanted else 0):
                # Deferred, not immediate: an immediate release races the
                # rest of this replay step — a policy running after this
                # one (or a re-plan it triggers, e.g. re-homing a storm's
                # victims) could no longer consume the still-billed
                # spare.  The controller flushes unconsumed marks at
                # end-of-event, so the billed outcome is unchanged when
                # nobody claims the spare.
                mech.defer_release_spare(uid)
                held[bt.name] -= 1
                actions.append(f"autoscale:release:{bt.name}")
        for name, (bt, count) in wanted.items():
            for _ in range(count - held.get(name, 0)):
                mech.pre_provision(bt)
                actions.append(f"autoscale:provision:{name}")
        if actions:
            result = dataclasses.replace(
                result, actions=result.actions + tuple(actions)
            )
        return result

    def spare_demand(self, mech, joins) -> dict:
        """Which spares the forecast joins actually need: type -> [BinType,
        count].

        Replays the joins against the live fleet's residual capacity
        (`placement_state`, the exact geometry the greedy repair packs
        into): a join that fits some bin's residual provisions nothing —
        joining it is free, so holding a spare would be pure billed
        overhead.  A join that fits nowhere demands one spare of the type
        the packer's open rule would launch (`open_host_bin`); the spare's
        leftover capacity is added to the simulated residual so a burst
        of joins shares one spare instead of demanding one each.
        """
        wanted: dict[str, list] = {}
        if not joins:
            return wanted
        state = mech.placement_state()
        cap = mech.manager.utilization_cap
        resid = [row.copy() for row in state.resid]
        for join in joins:
            reqs = mech.stream_requirements(join)
            if not reqs:
                continue  # unplaceable forecast join: provision nothing
            placed = False
            for p, row in enumerate(resid):
                for req in reqs:
                    if np.all(req <= row + _EPS):
                        resid[p] = row - req
                        placed = True
                        break
                if placed:
                    break
            if placed:
                continue
            try:
                bt = mech.open_host_bin(join)
                if bt.hazard > self.max_spare_hazard:
                    # Warm-spot is unreliable: hold the cheapest host the
                    # cloud cannot reclaim out from under the forecast.
                    bt = next(
                        (
                            c
                            for c in mech.host_candidates(join)
                            if c.hazard <= self.max_spare_hazard
                        ),
                        None,
                    )
                    if bt is None:
                        continue  # nothing reliable enough: hold nothing
            except InfeasibleError:
                continue
            eff = np.asarray(bt.capacity, dtype=np.float64) * cap
            req = next((r for r in reqs if np.all(r <= eff + _EPS)), None)
            if req is None:
                continue
            resid.append(eff - req)
            slot = wanted.setdefault(bt.name, [bt, 0])
            slot[1] += 1
        return wanted


@dataclasses.dataclass
class GracefulDegradationPolicy(ReplanPolicy):
    """SLA-tiered load shedding: degrade the expendable, re-home the rest.

    Engages when the mechanism left *stranded* streams — displaced
    streams placed on instances still booting (a preemption's victims, a
    notice's evacuees, or a protected join that landed cold).  Under
    storm pressure (any stranding after a preemption or notice, or a
    rank-0 stream stranded by anything) it:

    1. degrades the least-protected (highest tier rank) streams running
       on *warm* instances one rung down their rate ladder, shrinking
       their requirement vectors in place;
    2. asks the mechanism to re-home the stranded victims
       (`try_migrate`) — closing their fresh cold bins for the freed
       warm residual certifies a strict saving, so the exact sub-solve
       adopts it and the victims serve immediately;
    3. repeats up to ``max_rounds`` times within a ``max_moves`` total
       degradation budget, then parks still-stranded *parkable* victims
       (they would sit dark through a boot anyway; parking closes their
       cold bin and is charged as blackout against their own tier).

    After ``restore_patience`` consecutive calm events (no storm, no
    stranding) it restores service: unpark first, then lift rungs one
    step, most-protected tiers first, under the same per-event budget.

    Degradation never touches rank-0 (most protected) streams' rates —
    their ladders are single-rung by construction — and the policy is an
    exact no-op on default-tier fleets (nothing to degrade, nothing to
    park), which is the bit-identity regression anchor.
    """

    max_moves: int = 8  # degradation/restore budget per event
    max_rounds: int = 3  # degrade -> re-home rounds per storm event
    restore_patience: int = 2  # calm events before restoring service
    park_stranded: bool = True  # park parkable victims still cold after shedding
    _calm: int = dataclasses.field(default=0, init=False, repr=False)

    def on_reset(self, mech, result):
        self._calm = 0
        return result

    def on_event(self, mech, event, result):
        storm = isinstance(
            event, (InstancePreempted, InstancePreemptionNotice)
        )
        victims = set(result.displaced)
        cold = self._cold_placed(mech, victims)
        if cold and (
            storm
            or any(self._tier_of(mech, n).rank == 0 for n in cold)
        ):
            self._calm = 0
            return self._shed(mech, result, victims, storm)
        if storm or cold:
            self._calm = 0
            return result
        self._calm += 1
        if self._calm < self.restore_patience:
            return result
        return self._restore(mech, result)

    # ------------------------------------------------------------- internals

    def _tier_of(self, mech, name: str):
        for s in mech.fleet:
            if s.name == name:
                return s.tier
        return mech.parked[name].tier

    def _cold_placed(self, mech, names: set) -> set:
        """Which of ``names`` sit on instances still booting at ``now``."""
        if not names or mech.plan is None:
            return set()
        uids = mech.instance_uids
        eng = mech.lifecycle
        out = set()
        for p in mech.plan.placements:
            if p.stream.name not in names:
                continue
            uid = uids[p.instance_index]
            if uid in eng:
                running = eng.record(uid).running_at
            else:
                # Opened this very step: the ledger sync (after the
                # policy hook) will provision it now, booting from here.
                running = mech.now + eng.billing_for(p.instance_type).boot_hours
            if running > mech.now + _EPS:
                out.add(p.stream.name)
        return out

    def _degrade_candidates(self, mech, exclude: set) -> list:
        """Degradable streams on warm instances, least protected first.

        Returns ``(name, next_rung)`` pairs ordered by tier rank
        descending (shed BRONZE before SILVER), current rung ascending
        (spread the pain before deepening it), then name.
        """
        rungs = mech.degraded_rungs
        uids = mech.instance_uids
        eng = mech.lifecycle
        out = []
        for p in mech.plan.placements:
            s = p.stream
            if s.name in exclude:
                continue
            cur = rungs.get(s.name, 0)
            if cur + 1 >= len(s.tier.rate_ladder):
                continue
            uid = uids[p.instance_index]
            if uid not in eng or eng.record(uid).running_at > mech.now + _EPS:
                continue  # cold host: degrading frees nothing warm
            out.append((-s.tier.rank, cur, s.name))
        out.sort()
        return [(name, cur + 1) for _, cur, name in out]

    def _shed(self, mech, result, victims: set, storm: bool):
        actions: list[str] = []
        migrated = set(result.migrated)
        lb, gap, nodes = result.lower_bound, result.gap, result.nodes
        moves = 0
        for _ in range(self.max_rounds):
            cold = self._cold_placed(mech, victims)
            if not cold or moves >= self.max_moves:
                break
            stepped = False
            for name, rung in self._degrade_candidates(mech, victims):
                if moves >= self.max_moves:
                    break
                r2 = mech.set_stream_rung(name, rung)
                lb, gap, nodes = r2.lower_bound, r2.gap, nodes + r2.nodes
                actions.append(f"degrade:{name}:{rung}")
                moves += 1
                stepped = True
            if not stepped:
                break
            cold = sorted(self._cold_placed(mech, victims))
            if not cold:
                break
            mig = mech.try_migrate(cold)
            nodes += mig.nodes
            if mig.accepted:
                lb, gap = mig.lower_bound, mig.gap
                migrated |= set(mig.migrated)
                actions.append(f"rehome:{len(mig.migrated)}")
        if self.park_stranded and storm:
            for name in sorted(self._cold_placed(mech, victims)):
                if not self._tier_of(mech, name).parkable:
                    continue
                r2 = mech.park_stream(name)
                lb, gap, nodes = r2.lower_bound, r2.gap, nodes + r2.nodes
                actions.append(f"park:{name}")
        if not actions:
            return result
        return dataclasses.replace(
            result,
            plan=mech.plan,
            migrated=tuple(sorted(migrated)),
            lower_bound=lb,
            gap=gap,
            nodes=nodes,
            actions=result.actions + tuple(actions),
        )

    def _restore(self, mech, result):
        actions: list[str] = []
        lb, gap, nodes = result.lower_bound, result.gap, result.nodes
        budget = self.max_moves
        for name in sorted(mech.parked):
            if budget <= 0:
                break
            r2 = mech.unpark_stream(name)
            lb, gap, nodes = r2.lower_bound, r2.gap, nodes + r2.nodes
            actions.append(f"unpark:{name}")
            budget -= 1
        ranked = sorted(
            mech.degraded_rungs.items(),
            key=lambda kv: (self._tier_of(mech, kv[0]).rank, kv[0]),
        )
        for name, rung in ranked:
            if budget <= 0:
                break
            r2 = mech.set_stream_rung(name, rung - 1)
            lb, gap, nodes = r2.lower_bound, r2.gap, nodes + r2.nodes
            actions.append(f"restore:{name}:{rung - 1}")
            budget -= 1
        if not actions:
            return result
        self._calm = 0
        return dataclasses.replace(
            result,
            plan=mech.plan,
            lower_bound=lb,
            gap=gap,
            nodes=nodes,
            actions=result.actions + tuple(actions),
        )


class CompositePolicy(ReplanPolicy):
    """Fold several policies left to right over each result."""

    def __init__(self, *policies: ReplanPolicy) -> None:
        self.policies = tuple(policies)

    def on_reset(self, mech, result):
        for p in self.policies:
            result = p.on_reset(mech, result)
        return result

    def on_event(self, mech, event, result):
        for p in self.policies:
            result = p.on_event(mech, event, result)
        return result
