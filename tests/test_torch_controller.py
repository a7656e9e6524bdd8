"""The port's live re-planning controller against the reference's.

Every scenario runs twice, once through `repro` and once through
`repro_torch` on the CPU (``device="cpu"``: the plain scan, numpy scores,
plain torch pricing), from the same plain inputs: the catalog, the
profile table or ``CALIBRATION_ec2.json``, the fleet and the events (each
event built by the reference and carried over with `interop`).  Per event
the mode, $/h, gap, lower bound, displaced and migrated streams, policy
actions, clock and assignments must be equal (`replan_result_to_plain`),
floats with ``==``; so must the ledger, the spares and the degradation
bookkeeping where a scenario reads them.

The churn replay is `benchmarks/churn_replan.py`'s scenario cut to 60
streams and 40 events, with a gap threshold of 0.3 (the lifecycle
benchmark's, which keeps most events on the warm path: a full fallback on
so small a fleet is an exact arc-flow solve of seconds).
"""
import pathlib
import types

import numpy as np
import pytest

from repro.core import calibration as ref_cal
from repro.core import catalog as ref_catalog
from repro.core import manager as ref_manager
from repro.core import profiler as ref_profiler
from repro.core import strategies as ref_strategies
from repro.core import streams as ref_streams
from repro.core.binpack import heuristics as ref_h
from repro.core.binpack.problem import BinType as RefBinType
from repro.core.lifecycle import BillingModel as RefBillingModel

from repro_torch.core import calibration as cal
from repro_torch.core import catalog
from repro_torch.core import manager
from repro_torch.core import profiler
from repro_torch.core import strategies
from repro_torch.core import streams
from repro_torch.core.binpack import heuristics as h
from repro_torch.core.binpack.problem import BinType
from repro_torch.core.strategies import ST3
from repro_torch.interop import (
    billing_from_plain,
    event_from_plain,
    event_to_plain,
    plan_to_plain,
    replan_result_to_plain,
)
from repro_torch.device import KernelError
from repro_torch.kernels import knapsack, pack

ROOT = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = ROOT / "CALIBRATION_ec2.json"

REF = types.SimpleNamespace(
    mgr=lambda cat, **kw: ref_manager.ResourceManager(cat, **kw),
    st=ref_streams, cal=ref_cal, catalog=ref_catalog, profiles=ref_profiler.paper_profile_table,
    BinType=RefBinType, billing=lambda plain: RefBillingModel(*plain), h=ref_h,
    strategies=ref_strategies,
)
PORT = types.SimpleNamespace(
    mgr=lambda cat, **kw: manager.ResourceManager(cat, device="cpu", **kw),
    st=streams, cal=cal, catalog=catalog, profiles=profiler.paper_profile_table,
    BinType=BinType, billing=billing_from_plain, h=h, strategies=strategies,
)

SMALL_CATALOG = (
    ("c4.2xlarge", (8, 15, 0, 0), 0.419),
    ("c4.8xlarge", (36, 60, 0, 0), 1.675),
    ("g2.2xlarge", (8, 15, 1536, 4), 0.650),
)
HOURLY = (2.0 / 60.0, 1.0, 0.0)


def _kinds(ns):
    vgg, zf = ns.st.AnalysisProgram("VGG-16", "vgg16"), ns.st.AnalysisProgram("ZF", "zf")
    return [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]


def _streams(ns, n, prefix="s", tiers=None):
    kinds = _kinds(ns)
    tiers = tiers or ("DEFAULT_TIER",)
    return [ns.st.StreamSpec(f"{prefix}{i}", *kinds[i % 5],
                             tier=getattr(ns.st, tiers[i % len(tiers)])) for i in range(n)]


def _small_manager(ns, catalog=SMALL_CATALOG, **kw):
    return ns.mgr(tuple(ns.BinType(*b) for b in catalog), profiles=ns.profiles(), **kw)


def _port_event(ev):
    return event_from_plain(event_to_plain(ev))


def _both(script):
    """``script(ns)`` for the reference and the port; both outputs."""
    return script(REF), script(PORT)


# ------------------------------------------------------- the churn replay


def _churn_event(ns, ctrl, rng, at):
    """`benchmarks/churn_replan.py`'s `_trace`, built in ``ns``."""
    kinds = _kinds(ns)
    roll = rng.rand()
    if roll < 0.30:
        return ns.st.StreamAdded(
            ns.st.StreamSpec(f"j{rng.randint(10**9)}", *kinds[rng.randint(5)]), at=at)
    if roll < 0.55:
        live = ctrl.fleet
        return ns.st.StreamRemoved(live[rng.randint(len(live))].name, at=at)
    if roll < 0.95:
        live = ctrl.fleet
        s = live[rng.randint(len(live))]
        rates = [f for p, f in kinds if p.program_id == s.program.program_id]
        return ns.st.StreamRateChanged(s.name, rates[rng.randint(len(rates))], at=at)
    bt = ("c4.2xlarge", "c4.8xlarge", "g2.2xlarge")[rng.randint(3)]
    base = {"c4.2xlarge": 0.419, "c4.8xlarge": 1.675, "g2.2xlarge": 0.650}[bt]
    return ns.st.PriceChanged(bt, round(base * (1.0 + 0.05 * rng.randn()), 4), at=at)


N_STREAMS, N_EVENTS, GAP = 60, 40, 0.3


@pytest.fixture(scope="module")
def churn():
    """The reference's replay (its events recorded) and the port's replay of
    the same events: per-event plain results, and the final plans."""
    def manager_for(ns):
        art = ns.cal.CalibrationArtifact.load(CALIBRATION)
        return ns.mgr(ns.catalog.paper_ec2_catalog(), calibration=art, max_nodes=20_000)

    ref_mgr = manager_for(REF)
    ref_mgr.allocate(_streams(REF, N_STREAMS))
    ref_ctrl = ref_mgr.controller(gap_threshold=GAP)
    rng = np.random.RandomState(1802)
    events, ref_out = [], []
    for i in range(N_EVENTS):
        ev = _churn_event(REF, ref_ctrl, rng, (i + 1) * 0.02)
        events.append(ev)
        ref_out.append(replan_result_to_plain(ref_ctrl.apply(ev)))

    port_mgr = manager_for(PORT)
    port_mgr.allocate(_streams(PORT, N_STREAMS))
    port_ctrl = port_mgr.controller(gap_threshold=GAP)
    port_out = [replan_result_to_plain(port_ctrl.apply(_port_event(ev))) for ev in events]
    return {"events": events, "ref": ref_out, "port": port_out,
            "ref_plan": ref_ctrl.plan, "port_plan": port_ctrl.plan, "port_ctrl": port_ctrl}


@pytest.mark.parametrize("step", range(N_EVENTS))
def test_churn_replay_matches_the_reference_event_by_event(churn, step):
    assert churn["port"][step] == churn["ref"][step]


def test_churn_replay_covers_the_modes_and_ends_on_the_same_plan(churn):
    modes = [r["mode"] for r in churn["port"]]
    assert modes.count("warm") >= 20 and "full" in modes
    kinds = {type(ev).__name__ for ev in churn["events"]}
    assert kinds >= {"StreamAdded", "StreamRemoved", "StreamRateChanged"}
    a, b = plan_to_plain(churn["port_plan"]), plan_to_plain(churn["ref_plan"])
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key], key
    assert churn["port_ctrl"].manager.device.type == "cpu"


# -------------------------------------------------- events one at a time


def _fold_all(ns, ctrl, events):
    return [replan_result_to_plain(ctrl.apply(ev)) for ev in events]


def _ledger(ctrl):
    return [(r.uid, r.instance_type, r.hourly_cost, r.provisioned_at, r.running_at,
             r.terminated_at, r.preempted_at, r.noticed_at, r.notice_deadline)
            for r in ctrl.lifecycle.records()]


def test_price_events_reprice_every_controller_as_the_reference():
    def script(ns):
        mgr = _small_manager(ns)
        mgr.allocate(_streams(ns, 12))
        sibling = mgr.controller(ns.strategies.ST1)
        sibling.reset(_streams(ns, 2, prefix="c"))  # VGG-16 only: CPU-feasible
        ctrl = mgr.controller()
        out = _fold_all(ns, ctrl, [
            ns.st.PriceChanged("g2.2xlarge", 0.9, at=0.1),
            ns.st.PriceChanged("c4.2xlarge", 0.2, at=0.2),
            ns.st.StreamAdded(_streams(ns, 1, prefix="n")[0], at=0.3),
        ])
        with pytest.raises(KeyError):
            ctrl.apply(ns.st.PriceChanged("nope", 1.0, at=0.4))
        return out, [bt.cost for bt in mgr.catalog], sibling.plan.hourly_cost, _ledger(ctrl)

    got, want = _both(script)
    assert got == want


def _spot_manager(ns, **kw):
    cat = ns.catalog.with_spot_variants(
        tuple(ns.BinType(*b) for b in SMALL_CATALOG), price_ratio=0.3, hazard=0.25)
    return ns.mgr(cat, profiles=ns.profiles(), **kw)


def test_preemptions_by_uid_and_by_sampled_shock_match():
    def script(ns):
        mgr = _spot_manager(ns)
        ctrl = mgr.controller(billing=ns.billing(HOURLY))
        ctrl.reset(_streams(ns, 14), at=0.0)
        uids = ctrl.instance_uids
        out = _fold_all(ns, ctrl, [
            ns.st.InstancePreempted(uids[0], at=0.2),
            ns.st.InstancePreempted(uids[0], at=0.25),  # stale: a no-op
            ns.st.InstancePreempted(at=0.3, draw=0.05, pool=4),
            ns.st.InstancePreempted(at=0.4, draw=0.61, pool=2, hazard_ref=0.5),
            ns.st.InstancePreempted(at=0.5, draw=0.99, pool=64),  # a miss
        ])
        return out, _ledger(ctrl), ctrl.instance_uids

    got, want = _both(script)
    assert got == want
    assert got[0][0]["displaced"] and got[0][1]["mode"] == "noop"


@pytest.mark.parametrize("drain", [True, False], ids=["drain", "naive"])
def test_notices_with_and_without_drain_match(drain):
    def script(ns):
        mgr = _small_manager(ns)
        ctrl = mgr.controller(billing=ns.billing(HOURLY), drain_on_notice=drain)
        ctrl.reset(_streams(ns, 10, tiers=("GOLD", "SILVER", "BRONZE")), at=0.0)
        victim = ctrl.instance_uids[-1]
        out = _fold_all(ns, ctrl, [
            ns.st.InstancePreemptionNotice(victim, at=0.5, deadline=0.5 + 2.5 / 60,
                                           notice_id=0),
            ns.st.InstancePreempted(at=0.5 + 2.5 / 60, notice_id=0),
            ns.st.InstancePreempted(at=0.6, notice_id=7),  # no such notice: a no-op
        ])
        return out, _ledger(ctrl), ctrl.instance_uids

    got, want = _both(script)
    assert got == want
    assert (got[0][0]["mode"] == "noop") != drain


def test_spares_pre_provision_and_release_match():
    def script(ns):
        mgr = _small_manager(ns)
        ctrl = mgr.controller(billing=ns.billing(HOURLY))
        ctrl.reset(_streams(ns, 8), at=0.0)
        join = _streams(ns, 1, prefix="w")[0]
        spare_type = ctrl.open_host_bin(join)
        uids = ctrl.pre_provision(spare_type, count=2)
        ctrl.release_spare(uids[1])
        out = _fold_all(ns, ctrl, [ns.st.StreamAdded(join, at=0.2)])
        with pytest.raises(KeyError):
            ctrl.release_spare(uids[1])
        return (out, uids, sorted(ctrl.spares), _ledger(ctrl),
                [bt.name for bt in ctrl.host_candidates(join)],
                ctrl.cheapest_host_bin(join).name, spare_type.name)

    got, want = _both(script)
    assert got == want


def test_rungs_and_parking_match():
    def script(ns):
        mgr = _small_manager(ns)
        ctrl = mgr.controller(billing=ns.billing(HOURLY))
        ctrl.reset(_streams(ns, 9, tiers=("GOLD", "SILVER", "BRONZE")), at=0.0)
        out = [replan_result_to_plain(r) for r in (
            ctrl.set_stream_rung("s1", 1),
            ctrl.set_stream_rung("s2", 2),
            ctrl.park_stream("s5"),
            ctrl.set_stream_rung("s1", 0),
            ctrl.unpark_stream("s5"),
        )]
        errors = []
        for bad in (lambda: ctrl.set_stream_rung("s0", 1), lambda: ctrl.park_stream("s0"),
                    lambda: ctrl.unpark_stream("s5"), lambda: ctrl.set_stream_rung("zz", 0)):
            try:
                bad()
            except (ValueError, KeyError) as exc:
                errors.append((type(exc).__name__, str(exc)))
        return (out, errors, ctrl.degraded_rungs, sorted(ctrl.parked),
                ctrl.nominal_fps("s2"), [(s.name, s.desired_fps) for s in ctrl.fleet])

    got, want = _both(script)
    assert got == want
    assert len(got[1]) == 4


def test_what_if_matches_single_fleet_ffd_and_the_reference():
    """The reference's `test_what_if_batches_match_single_fleet_heuristic`:
    each what-if cost is the numpy FFD's cost of that fleet."""
    def script(ns):
        mgr = _small_manager(ns)
        mgr.allocate(_streams(ns, 6))
        ctrl = mgr.controller()
        fleets = [_streams(ns, 6), _streams(ns, 6) + _streams(ns, 1, prefix="x"),
                  _streams(ns, 4)]
        return [list(ctrl.what_if(fleets, best_fit=bf)) for bf in (False, True)], [
            [ns.h._pack(mgr.formulate(f), bf).cost for f in fleets]
            for bf in (False, True)]

    before = pack.LAUNCHES
    (got, got_ffd), (want, want_ffd) = _both(script)
    assert got == want == got_ffd == want_ffd
    assert pack.LAUNCHES == before  # the CPU runs the plain scan


def test_try_migrate_and_swap_match():
    def script(ns):
        mgr = _small_manager(ns)
        ctrl = mgr.controller(billing=ns.billing(HOURLY))
        ctrl.reset(_streams(ns, 16), at=0.0)
        _fold_all(ns, ctrl, [ns.st.StreamRemoved(f"s{i}", at=0.1 * i) for i in (1, 4, 7, 9)])
        state = ctrl.placement_state()
        members = state.members
        moves = []
        for names in ([members[0][0]], list(members[-1]), []):
            r = ctrl.try_migrate(names, billing_horizon=None)
            moves.append((r.accepted, r.cost_before, r.cost_after, r.migrated, r.nodes,
                          r.lower_bound, r.gap, r.billed_delta))
        r = ctrl.try_migrate(list(ctrl.placement_state().members[0]), billing_horizon=1.0)
        moves.append((r.accepted, r.cost_after, r.billed_delta))
        a, b = ctrl.placement_state().members[0][0], ctrl.placement_state().members[-1][0]
        r = ctrl.try_swap(a, b)
        moves.append((r.accepted, r.cost_after, r.migrated))
        with pytest.raises(KeyError):
            ctrl.try_migrate(["nope"])
        return moves, state.names, state.owner.tolist(), state.resid.tolist(), ctrl.refresh_prices()

    got, want = _both(script)
    assert got == want


def test_recalibrate_matches_the_reference():
    def script(ns):
        art = ns.cal.CalibrationArtifact.load(CALIBRATION)
        mgr = ns.mgr(ns.catalog.paper_ec2_catalog(), calibration=art)
        ctrl = mgr.controller()
        ctrl.reset(_streams(ns, 20))
        out = [replan_result_to_plain(ctrl.recalibrate(art)),
               replan_result_to_plain(ctrl.recalibrate())]
        return out

    got, want = _both(script)
    assert got == want
    assert got[0]["mode"] == "reset"


def test_manager_replan_and_reconfigure_match():
    def script(ns):
        mgr = _small_manager(ns)
        plan = mgr.allocate(_streams(ns, 6))
        ctrl = mgr.controller()
        assert mgr.controller(gap_threshold=0.2) is ctrl and ctrl.gap_threshold == 0.2
        with pytest.raises(TypeError, match="unknown controller option"):
            mgr.controller(colour="red")
        out = mgr.replan([ns.st.StreamAdded(_streams(ns, 1, prefix="a")[0]),
                          ns.st.StreamRemoved("s2")], billing=ns.billing(HOURLY))
        return plan.hourly_cost, [replan_result_to_plain(r) for r in out]

    got, want = _both(script)
    assert got == want
    assert [len(r["assignments"]) for r in got[1]] == [7, 6]


def test_allocate_goes_through_the_controller():
    mgr = _small_manager(PORT)
    plan = mgr.allocate(_streams(PORT, 5), ST3)
    assert mgr.controller(ST3).plan is plan


def test_kernel_failure_is_not_a_pricing_blow_up(monkeypatch):
    """A failed kernel launch inside the lower bound's pricing surfaces;
    the reference's catch-all keeps only pricing blow-ups."""
    art = cal.CalibrationArtifact.load(CALIBRATION)
    mgr = manager.ResourceManager(catalog.paper_ec2_catalog(), calibration=art, device="cpu")
    ctrl = mgr.controller()
    kinds = _kinds(PORT) + [(p, f * 2) for p, f in _kinds(PORT)]
    ctrl.reset([streams.StreamSpec(f"k{i}", *kinds[i]) for i in range(10)])  # 10 classes

    def fail(*args, **kwargs):
        raise KernelError("knapsack_dp kernel launch failed: CUDA error 700")

    monkeypatch.setattr(knapsack, "_dispatch", fail)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ctrl.refresh_prices()


def test_a_grid_the_kernel_refuses_surfaces_from_pricing(monkeypatch):
    """A knapsack that only the kernel refuses (here its grid passes a
    lowered `_MAX_STATES`) raises `KernelError` out of the lower bound's
    pricing rather than pricing nothing.  On the CPU `_dispatch` runs the
    plain DP, so the card's refusals are put in front of it."""
    art = cal.CalibrationArtifact.load(CALIBRATION)
    mgr = manager.ResourceManager(catalog.paper_ec2_catalog(), calibration=art, device="cpu")
    ctrl = mgr.controller()
    kinds = _kinds(PORT) + [(p, f * 2) for p, f in _kinds(PORT)]
    ctrl.reset([streams.StreamSpec(f"k{i}", *kinds[i]) for i in range(10)])  # 10 classes
    plain = knapsack._dispatch

    def card_dispatch(sv, sw, fi, levels):
        knapsack._refusals(sv, sw, fi, int(np.prod(levels)))
        return plain(sv, sw, fi, levels)

    monkeypatch.setattr(knapsack, "_dispatch", card_dispatch)
    monkeypatch.setattr(knapsack, "_MAX_STATES", 16)
    with pytest.raises(KernelError, match="fewer than 16 states"):
        ctrl.refresh_prices()
