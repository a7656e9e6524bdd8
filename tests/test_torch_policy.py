"""The port's policy layer and churn replay against the reference's.

Each scenario is a reduced version of one of the reference's beyond-paper
studies — `benchmarks/consolidation.py`, `benchmarks/lifecycle.py`
(experiments 1, 3 and 4), `benchmarks/spot.py` and `benchmarks/storms.py`
— replayed through `simulate_churn` in both packages (the port on the CPU)
from the same plain inputs: the reference builds the fleet and the trace,
`interop` carries them over.  The whole output dict must be equal: the
same keys, every float bit for bit, the policy actions' strings included.
Fleets are cut from 500 (120 for the storm) to 24-30 streams and traces
to 20-30 events, so that the file runs in well under a minute.
`ArrivalRateEstimator` meets the inputs of ``tests/test_arrival_rate.py``.
"""
import types

import numpy as np
import pytest

from repro.core import catalog as ref_catalog
from repro.core import lifecycle as ref_lifecycle
from repro.core import manager as ref_manager
from repro.core import policy as ref_policy
from repro.core import profiler as ref_profiler
from repro.core import simulator as ref_simulator
from repro.core import streams as ref_streams

from repro_torch.core import catalog
from repro_torch.core import lifecycle
from repro_torch.core import manager
from repro_torch.core import policy
from repro_torch.core import profiler
from repro_torch.core import simulator
from repro_torch.core import streams
from repro_torch.interop import (
    catalog_from_plain,
    catalog_to_plain,
    event_from_plain,
    event_to_plain,
    stream_from_plain,
    stream_to_plain,
    trace_from_plain,
    trace_to_plain,
)

REF = types.SimpleNamespace(
    mgr=lambda cat, **kw: ref_manager.ResourceManager(cat, ref_profiler.paper_profile_table(),
                                                       **kw),
    st=ref_streams, policy=ref_policy, catalog=ref_catalog, lifecycle=ref_lifecycle,
    profiles=ref_profiler.paper_profile_table, simulate_churn=ref_simulator.simulate_churn,
    fleet=lambda fleet: fleet, trace=lambda trace: trace, cat=lambda cat: cat,
)
PORT = types.SimpleNamespace(
    mgr=lambda cat, **kw: manager.ResourceManager(cat, profiler.paper_profile_table(),
                                                  device="cpu", **kw),
    st=streams, policy=policy, catalog=catalog, lifecycle=lifecycle,
    profiles=profiler.paper_profile_table, simulate_churn=simulator.simulate_churn,
    fleet=lambda fleet: [stream_from_plain(stream_to_plain(s)) for s in fleet],
    trace=lambda trace: trace_from_plain(trace_to_plain(trace)),
    cat=lambda cat: catalog_from_plain(catalog_to_plain(cat)),
)

BOOT_H = 2.0 / 60.0
MAX_NODES = 20_000


def _kinds(st):
    vgg, zf = st.AnalysisProgram("VGG-16", "vgg16"), st.AnalysisProgram("ZF", "zf")
    return [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]


def _rerate(kinds):
    return lambda s: [f for p, f in kinds if p.program_id == s.program.program_id]


def _fleet(n, tiers=None):
    kinds = _kinds(ref_streams)
    return [ref_streams.StreamSpec(
        f"s{i}", *kinds[i % 5],
        tier=tiers[i % len(tiers)] if tiers else ref_streams.DEFAULT_TIER) for i in range(n)]


def _removal_trace(initial, n_events, seed=1802, gap=0.02):
    """`benchmarks/consolidation.py`'s removal-heavy `_trace`, cut."""
    st = ref_streams
    kinds = _kinds(st)
    rng = np.random.RandomState(seed)
    fleet, events = list(initial), []
    for i in range(n_events):
        at = (i + 1) * gap
        roll = rng.rand()
        if roll < 0.18 or len(fleet) < len(initial) // 2:
            ev = st.StreamAdded(st.StreamSpec(f"j{i}", *kinds[rng.randint(5)]), at=at)
        elif roll < 0.70:
            ev = st.StreamRemoved(fleet[rng.randint(len(fleet))].name, at=at)
        else:
            s = fleet[rng.randint(len(fleet))]
            rates = _rerate(kinds)(s)
            ev = st.StreamRateChanged(s.name, rates[rng.randint(len(rates))], at=at)
        events.append(ev)
        fleet = list(st.apply_events(fleet, [ev]))
    return st.TimedTrace(events, horizon=(n_events + 1) * gap)


def _growth_trace(initial, n_events):
    """`benchmarks/lifecycle.py`'s bursty join-heavy `_growth_trace`, cut."""
    st = ref_streams
    kinds = _kinds(st)
    return st.synthetic_timed_trace(
        initial, np.random.RandomState(2618), n_events=n_events, mean_gap_hours=0.03,
        p_join=0.6, p_leave=0.15, make_join=lambda i: st.StreamSpec(f"g{i}", *kinds[i % 5]),
        rerate_fps=_rerate(kinds), burst=3)


def _oracle(ns, trace, lookahead=0.15, max_spares=3):
    """The benchmarks' perfect join forecaster read off ``trace``."""
    adds = [(ev.at, ev.stream) for ev in trace if isinstance(ev, ns.st.StreamAdded)]

    def forecast(fleet, event):
        now = event.at if event is not None else 0.0
        live = {s.name for s in fleet}
        upcoming = tuple(s for t, s in adds
                         if now < t <= now + lookahead and s.name not in live)
        return ns.st.StreamForecast(joins=upcoming[:max_spares])

    return forecast


def _replay(ns, catalog_, initial, trace, make_policy, *, billing, gap=0.3, **kw):
    mgr = ns.mgr(ns.cat(catalog_), max_nodes=MAX_NODES)
    mgr.controller(gap_threshold=gap)
    trace = ns.trace(trace)
    return ns.simulate_churn(mgr, ns.fleet(initial), trace, ns.profiles(),
                             policy=make_policy(ns, trace),
                             billing=ns.lifecycle.BillingModel(*billing), **kw)


def _assert_same_output(got, want):
    assert got.keys() == want.keys()
    assert len(got["timeline"]) == len(want["timeline"])
    for i, (a, b) in enumerate(zip(got["timeline"], want["timeline"])):
        assert a == b, i
    for key in got:
        assert got[key] == want[key], key


HOURLY = (BOOT_H, 1.0, 0.0)
SNAPSHOT = (0.0, 0.0, 0.0)


def _base_catalog():
    return ref_catalog.paper_ec2_catalog()


SCENARIOS = {
    # benchmarks/consolidation.py: consolidation + dual-price aging.
    "consolidation": lambda: (
        _base_catalog(), _fleet(30), _removal_trace(_fleet(30), 30),
        lambda ns, tr: ns.policy.CompositePolicy(
            ns.policy.ConsolidationPolicy(max_migrations=3),
            ns.policy.DualPriceAgingPolicy()),
        {"billing": SNAPSHOT}),
    # benchmarks/lifecycle.py experiment 1: pinning, snapshot billing.
    "lifecycle-1": lambda: (
        _base_catalog(), _fleet(30), _removal_trace(_fleet(30), 30),
        lambda ns, tr: ns.policy.PinningPolicy(), {"billing": SNAPSHOT}),
    # Experiment 3: the acting autoscaler on bursty growth, hourly billing.
    "lifecycle-3": lambda: (
        _base_catalog(), _fleet(24), _growth_trace(_fleet(24), 24),
        lambda ns, tr: ns.policy.ActingAutoscaler(forecast=_oracle(ns, tr), max_spares=3),
        {"billing": HOURLY}),
    # Experiment 4: billing-aware consolidation, hourly billing.
    "lifecycle-4": lambda: (
        _base_catalog(), _fleet(30), _removal_trace(_fleet(30), 30),
        lambda ns, tr: ns.policy.ConsolidationPolicy(max_migrations=3, billing_horizon=1.0),
        {"billing": HOURLY}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_simulate_churn_matches_the_reference(scenario):
    cat, initial, trace, make_policy, kw = SCENARIOS[scenario]()
    want = _replay(REF, cat, initial, trace, make_policy, **kw)
    got = _replay(PORT, cat, initial, trace, make_policy, **kw)
    _assert_same_output(got, want)
    assert len(got["timeline"]) == len(trace) + 1


def test_consolidation_and_acting_scenarios_take_actions():
    """The reduced traces still exercise the policies they stand for."""
    for name, prefix in (("consolidation", "consolidate"),
                         ("lifecycle-3", "autoscale:provision")):
        cat, initial, trace, make_policy, kw = SCENARIOS[name]()
        out = _replay(PORT, cat, initial, trace, make_policy, **kw)
        actions = [a for t in out["timeline"] for a in t["actions"]]
        assert any(a.startswith(prefix) for a in actions), name


def _spot_market(ns):
    """`benchmarks/spot.py`'s two-tier market and per-type billing."""
    base = ns.catalog.paper_ec2_catalog()
    cat = ns.catalog.with_spot_variants(base, price_ratio=0.30, hazard=0.9, suffix="-spot")
    cat = ns.catalog.with_spot_variants(cat, price_ratio=0.45, hazard=0.08,
                                        suffix="-spot-stable")
    by_type = {bt.name: ns.lifecycle.BillingModel(BOOT_H, 0.0) for bt in cat if bt.is_spot}
    risk = ns.policy.risk_adjusted_catalog(cat, ns.lifecycle.BillingModel(*HOURLY),
                                           billing_by_type=by_type, degraded_penalty=25.0)
    return risk, by_type


def test_spot_replay_matches_the_reference():
    """`benchmarks/spot.py`'s risk-aware acting run, cut to 24 streams and
    25 events with spot shocks on a pool of 24."""
    st = ref_streams
    kinds = _kinds(st)
    initial = _fleet(24)
    trace = st.synthetic_timed_trace(
        initial, np.random.RandomState(7113), n_events=25, mean_gap_hours=0.02,
        p_join=0.45, p_leave=0.2, make_join=lambda i: st.StreamSpec(f"g{i}", *kinds[i % 5]),
        rerate_fps=_rerate(kinds), preemption_hazard=0.9, hazard_pool=24)
    assert any(isinstance(ev, st.InstancePreempted) for ev in trace)
    outs = []
    for ns in (REF, PORT):
        risk, by_type = _spot_market(ns)
        assert catalog_to_plain(risk) == catalog_to_plain(_spot_market(REF)[0])
        mgr = ns.mgr(risk, max_nodes=MAX_NODES)
        mgr.controller(gap_threshold=0.3)
        tr = ns.trace(trace)
        outs.append(ns.simulate_churn(
            mgr, ns.fleet(initial), tr, ns.profiles(),
            policy=ns.policy.ActingAutoscaler(forecast=_oracle(ns, tr), max_spares=3,
                                              max_spare_hazard=0.1),
            billing=ns.lifecycle.BillingModel(*HOURLY), billing_by_type=by_type))
    _assert_same_output(outs[1], outs[0])


def test_storm_replay_matches_the_reference():
    """`benchmarks/storms.py`'s tiered run (graceful degradation, notice
    draining), cut to 30 streams, 12 background events and smaller waves."""
    st = ref_streams
    kinds = _kinds(st)
    wheel = (st.GOLD, st.GOLD, st.SILVER, st.SILVER, st.SILVER) + (st.BRONZE,) * 5
    initial = _fleet(30, wheel)
    spike = "c4.2xlarge-spot-stable"
    phases = [st.StormPhase("notice", at=0.5, count=4, notice_hours=2.5 / 60.0),
              st.StormPhase("flash_crowd", at=0.9, count=5),
              st.StormPhase("price", at=1.2, instance_type=spike, cost=0.60),
              st.StormPhase("reclaim", at=1.6, count=3),
              st.StormPhase("false_alarm", at=2.0, count=2)]
    trace = st.storm_trace(
        initial, np.random.RandomState(8231), phases=phases, n_background=12,
        mean_gap_hours=0.02, p_join=0.35, p_leave=0.25,
        make_join=lambda i: st.StreamSpec(f"g{i}", *kinds[i % 5], tier=wheel[i % 10]),
        rerate_fps=_rerate(kinds), hazard_pool=16)
    outs = []
    for ns in (REF, PORT):
        risk, by_type = _spot_market(ns)
        mgr = ns.mgr(risk, max_nodes=MAX_NODES)
        mgr.controller(gap_threshold=10.0)
        outs.append(ns.simulate_churn(
            mgr, ns.fleet(initial), ns.trace(trace), ns.profiles(),
            policy=ns.policy.GracefulDegradationPolicy(park_stranded=False),
            billing=ns.lifecycle.BillingModel(*HOURLY), billing_by_type=by_type,
            drain_on_notice=True))
    _assert_same_output(outs[1], outs[0])
    assert outs[1]["sla"]


def test_spot_pricing_helpers_match_the_reference():
    for ns in (REF, PORT):
        assert ns.policy.spot_effective_cost(
            ns.catalog.with_spot_variants(ns.catalog.paper_ec2_catalog())[-1],
            ns.lifecycle.BillingModel(*HOURLY), degraded_penalty=25.0) == pytest.approx(
            REF.policy.spot_effective_cost(
                ref_catalog.with_spot_variants(ref_catalog.paper_ec2_catalog())[-1],
                ref_lifecycle.BillingModel(*HOURLY), degraded_penalty=25.0), abs=0)
        grid = np.array([[1.0, 0.8, 0.9], [1.3, 1.1, 0.7], [1.6, 1.2, 1.0]])
        assert ns.policy.cheapest_provisioning_path(grid) == (
            ref_policy.cheapest_provisioning_path(grid))
    risk = catalog_to_plain(_spot_market(PORT)[0])
    assert risk == catalog_to_plain(_spot_market(REF)[0])
    assert any(r[4] is not None for r in risk)  # risk-adjusted spot rows carry rent


# ------------------------------------------------ the arrival-rate estimator


def _poisson_joins(st, lam, n, seed=7):
    rng = np.random.RandomState(seed)
    zf = st.AnalysisProgram("ZF", "zf")
    t, events = 0.0, []
    for i in range(n):
        t += rng.exponential(1.0 / lam)
        events.append(st.StreamAdded(st.StreamSpec(f"a{i}", zf, 0.5), at=t))
    return events


def _estimator_trace(ns):
    zf = ns.st.AnalysisProgram("ZF", "zf")
    template = ns.st.StreamSpec("zf-template", zf, 0.5)
    out = []
    for kw, joins in (({"window_hours": 2.0}, _poisson_joins(ns.st, 20.0, 200)),
                      ({"window_hours": 1.0, "smoothing": 0.9},
                       _poisson_joins(ns.st, 5.0, 30, seed=3)),
                      ({"horizon_hours": 1.0, "window_hours": 2.0, "max_joins": 3},
                       _poisson_joins(ns.st, 20.0, 100))):
        est = ns.policy.ArrivalRateEstimator(template, **kw)
        rates = []
        for ev in joins:
            est.observe(ev)
            rates.append(est.rate)
        fc = est((ns.st.StreamSpec("zf-template~a0", zf, 0.5),), None)
        out.append((rates, None if fc is None else [stream_to_plain(s) for s in fc.joins]))
    est = ns.policy.ArrivalRateEstimator(template, window_hours=5.0)
    for i, t in enumerate((1.0, 1.1, 1.2)):
        est.observe(ns.st.StreamAdded(ns.st.StreamSpec(f"p{i}", zf, 0.5), at=t))
    out.append(est.rate)
    return out


def test_arrival_rate_estimator_matches_the_reference():
    got, want = _estimator_trace(PORT), _estimator_trace(REF)
    assert got == want
    assert got[-1] == pytest.approx(10.0)
    assert len(got[2][1]) == 3


def test_estimator_driven_lookahead_matches_the_reference():
    """`tests/test_arrival_rate.py`'s autoscaler integration: the estimated
    cone's advice, through the what-if scan, in both packages."""
    def run(ns):
        zf = ns.st.AnalysisProgram("ZF", "zf")
        cat = ns.cat(tuple(b for b in _base_catalog() if b.name in (
            "c4.2xlarge", "c4.8xlarge", "g2.2xlarge")))
        mgr = ns.mgr(cat, max_nodes=50_000)
        mgr.allocate([ns.st.StreamSpec(f"s{i}", zf, 0.5) for i in range(4)])
        est = ns.policy.ArrivalRateEstimator(ns.st.StreamSpec("zf-template", zf, 0.5),
                                             horizon_hours=0.25, window_hours=1.0, max_joins=2)
        ctrl = mgr.controller(policy=ns.policy.LookaheadAutoscaler(forecast=est))
        out = []
        for i, ev in enumerate(_poisson_joins(ns.st, 40.0, 12, seed=11)):
            r = ctrl.apply(ns.st.StreamAdded(ns.st.StreamSpec(f"j{i}", zf, 0.5), at=ev.at))
            out.append((r.mode, r.plan.hourly_cost, r.actions, r.advice))
        return out

    got = run(PORT)
    assert got == run(REF)
    assert got[-1][3] is not None and len(got[-1][3]["grid"]) == 3


def test_event_conversion_keeps_tiers():
    ev = ref_streams.StreamAdded(_fleet(1, (ref_streams.BRONZE,))[0], at=0.5)
    port_ev = event_from_plain(event_to_plain(ev))
    assert port_ev.stream.tier == streams.BRONZE and port_ev.at == 0.5
