"""The port's sharded controller (`core/shard.py`) against the reference's.

Each case of the reference's ``tests/test_shard.py`` runs through both
packages at the reference's own sizes and seeds — `repro`, and
`repro_torch` on the CPU (``device="cpu"``: the plain pack scan, numpy
placement scores, plain torch pricing) — with every fleet, event and
catalog built in each package by the same builder.  The plain values must
be equal, floats with ``==``: per-event costs, lower bounds, gaps, modes,
displaced and migrated streams, actions, placements as tuples, instance
names and uids, billed costs and the whole `simulate_churn` dict.  The
reference's own properties (a single cell equal to the flat controller,
rebalancing that never raises the cost, ...) are checked on the port too.

Two cases are not ported: ``test_pmap_fanout_matches_vmap`` (the jax
multi-device fan-out, out of the port for good) and
``test_batched_pack_edge_cases``, whose port counterpart here holds the
documented mixed-catalog ``ValueError``.  The batched event pipeline's
cases are in ``tests/test_torch_shard_batched.py``.

This file also holds the two repairs that came with the slice: the
sharded arguments of `simulate_churn` gate as the reference's do (a flat
replay ignores ``rebalance_every`` and ``reset_pack``), and only
`device.KernelError` escapes pricing's catch-all.
"""
import functools
import importlib.util
import pathlib
import types
import zlib

import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import catalog as ref_catalog
from repro.core import controller as ref_controller
from repro.core import lifecycle as ref_lifecycle
from repro.core import manager as ref_manager
from repro.core import policy as ref_policy
from repro.core import profiler as ref_profiler
from repro.core import shard as ref_shard
from repro.core import simulator as ref_simulator
from repro.core import streams as ref_streams
from repro.core.strategies import ST3 as REF_ST3
from repro.core.binpack import arcflow as ref_arcflow
from repro.core.binpack import colgen as ref_colgen
from repro.core.binpack import heuristics as ref_h
from repro.core.binpack import problem as ref_problem
from repro.core.catalog import with_spot_variants as ref_with_spot_variants

from repro_torch import device as port_device
from repro_torch.core import calibration as cal
from repro_torch.core import catalog
from repro_torch.core import controller
from repro_torch.core import lifecycle
from repro_torch.core import manager
from repro_torch.core import policy
from repro_torch.core import profiler
from repro_torch.core import shard
from repro_torch.core import simulator
from repro_torch.core import streams
from repro_torch.core.binpack import arcflow
from repro_torch.core.binpack import colgen
from repro_torch.core.binpack import heuristics as h
from repro_torch.core.binpack import problem
from repro_torch.core.catalog import with_spot_variants
from repro_torch.core.strategies import ST3
from repro_torch.interop import replan_result_to_plain
from repro_torch.kernels import knapsack

CALIBRATION = pathlib.Path(__file__).resolve().parents[1] / "CALIBRATION_ec2.json"

REF = types.SimpleNamespace(
    name="ref", mgr=lambda cat, profiles, **kw: ref_manager.ResourceManager(cat, profiles, **kw),
    st=ref_streams, pb=ref_problem, h=ref_h, shard=ref_shard, ctl=ref_controller,
    policy=ref_policy, profiler=ref_profiler, simulate_churn=ref_simulator.simulate_churn,
    arcflow=ref_arcflow, colgen=ref_colgen, spot=ref_with_spot_variants,
    lifecycle=ref_lifecycle, ST3=REF_ST3, cal=ref_cal, catalog=ref_catalog,
)
PORT = types.SimpleNamespace(
    name="port",
    mgr=lambda cat, profiles, **kw: manager.ResourceManager(cat, profiles, device="cpu", **kw),
    st=streams, pb=problem, h=h, shard=shard, ctl=controller,
    policy=policy, profiler=profiler, simulate_churn=simulator.simulate_churn,
    arcflow=arcflow, colgen=colgen, spot=with_spot_variants,
    lifecycle=lifecycle, ST3=ST3, cal=cal, catalog=catalog,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's plain CPU paths (the knapsack's
    many small ops), whose thread handoffs cost more than they save when
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _catalog(ns):
    return (
        ns.pb.BinType("c4.2xlarge", (8, 15, 0, 0), 0.419),
        ns.pb.BinType("c4.8xlarge", (36, 60, 0, 0), 1.675),
        ns.pb.BinType("g2.2xlarge", (8, 15, 1536, 4), 0.650),
    )


def _kinds(ns):
    vgg = ns.st.AnalysisProgram("VGG-16", "vgg16")
    zf = ns.st.AnalysisProgram("ZF", "zf")
    return [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]


#: Rates each program can actually reach (VGG-16 saturates at 0.25 FPS).
RATES = {"vgg16": [0.2, 0.25], "zf": [0.5, 2.0, 5.0]}


def _streams(ns, n, prefix="s"):
    kinds = _kinds(ns)
    return [ns.st.StreamSpec(f"{prefix}{i}", *kinds[i % len(kinds)]) for i in range(n)]


def _manager(ns, **kw):
    kw.setdefault("max_nodes", 20_000)
    return ns.mgr(_catalog(ns), ns.profiler.paper_profile_table(), **kw)


def _trace(ns, rng, fleet, n_events):
    """The reference test's mixed join/leave/re-rate list, built in ``ns``."""
    kinds = _kinds(ns)
    evs, t, nxt = [], 0.0, 100
    prog = {s.name: s.program.program_id for s in fleet}
    names = [s.name for s in fleet]
    for _ in range(n_events):
        t += 0.02
        roll = rng.rand()
        if roll < 0.3 or not names:
            name = f"j{nxt}"
            kind = kinds[nxt % len(kinds)]
            nxt += 1
            evs.append(ns.st.StreamAdded(ns.st.StreamSpec(name, *kind), at=t))
            names.append(name)
            prog[name] = kind[0].program_id
        elif roll < 0.55:
            name = names.pop(int(rng.rand() * len(names)))
            evs.append(ns.st.StreamRemoved(name, at=t))
        else:
            name = names[int(rng.rand() * len(names))]
            rates = RATES[prog[name]]
            evs.append(ns.st.StreamRateChanged(name, rates[rng.randint(len(rates))], at=t))
    return evs


def result_plain(r) -> dict:
    """A `ReplanResult` as plain values, its plan's bins and nodes included."""
    plan = r.plan
    return {
        **replan_result_to_plain(r),
        "nodes": r.nodes,
        "advice": r.advice,
        "instances": tuple(plan.instances),
        "bins": tuple((b.bin_type.name, tuple(b.load)) for b in plan.solution.bins),
        "strategy": plan.strategy,
        "optimal": plan.optimal,
    }


def _both(script, *args):
    """``script(ns, *args)`` for the reference and the port."""
    return script(REF, *args), script(PORT, *args)


# ------------------------------------------------- single-cell bit-identity


def _single_cell(ns, seed, with_flat):
    streams_ = _streams(ns, 30)
    shard_ = ns.shard.ShardedController(_manager(ns), ns.ST3, sub_max_nodes=5_000)
    flat = (ns.ctl.FleetController(_manager(ns), ns.ST3, sub_max_nodes=5_000)
            if with_flat else None)
    rows = {"shard": [result_plain(shard_.reset(streams_, at=0.0))], "flat": []}
    if flat is not None:
        rows["flat"].append(result_plain(flat.reset(streams_, at=0.0)))
    rows["n_cells"] = shard_.n_cells
    events = _trace(ns, np.random.RandomState(seed), streams_, 40)
    events.append(ns.st.PriceChanged("c4.2xlarge", 0.5, at=events[-1].at + 0.02))
    for ev in events:
        rows["shard"].append((result_plain(shard_.apply(ev)), shard_.instance_uids))
        if flat is not None:
            rows["flat"].append((result_plain(flat.apply(ev)), flat.instance_uids))
    rows["fleet"] = sorted(s.name for s in shard_.fleet)
    if flat is not None:
        rows["flat_fleet"] = sorted(s.name for s in flat.fleet)
    return rows


@pytest.mark.parametrize("seed", [7, 19, 23])
def test_single_cell_bit_identical_to_flat(seed):
    """One cell IS the flat controller in the port, and equals the
    reference's single cell event by event."""
    want = _single_cell(REF, seed, with_flat=False)
    got = _single_cell(PORT, seed, with_flat=True)
    assert got["n_cells"] == 1
    assert got["shard"] == got["flat"]
    assert got["fleet"] == got["flat_fleet"]
    assert len(got["shard"]) == len(want["shard"]) == 42
    for i, (a, b) in enumerate(zip(got["shard"], want["shard"])):
        assert a == b, i
    assert got["fleet"] == want["fleet"]


def test_single_cell_key_factories():
    s, rs = _streams(PORT, 5), _streams(REF, 5)
    assert all(shard.single_cell(x) == 0 for x in s)
    assert {shard.cells_by_program(x) for x in s} == {"vgg16", "zf"}
    k, rk = shard.hash_cells(4), ref_shard.hash_cells(4)
    assert all(0 <= k(x) < 4 for x in s)
    # Same name -> same cell, independent of everything else.
    assert k(s[0]) == k(streams.StreamSpec(s[0].name, _kinds(PORT)[2][0], 5.0))
    # crc32 of the name, as the reference's: the same partition.
    for n in (1, 3, 8, 512):
        a, b = shard.hash_cells(n), ref_shard.hash_cells(n)
        names = _streams(PORT, 200, prefix="cam") + _streams(PORT, 50, prefix="j")
        ref_names = _streams(REF, 200, prefix="cam") + _streams(REF, 50, prefix="j")
        assert [a(x) for x in names] == [b(x) for x in ref_names]
        assert a(names[7]) == zlib.crc32(b"cam7") % n
    assert [k(x) for x in s] == [rk(x) for x in rs]
    assert shard.UID_STRIDE == ref_shard.UID_STRIDE
    with pytest.raises(ValueError):
        shard.hash_cells(0)


# ---------------------------------------------------------- multi-cell core


def _multicell(ns):
    streams_ = _streams(ns, 24)
    sc = ns.shard.ShardedController(_manager(ns), ns.ST3, cell_key=ns.shard.cells_by_program,
                                    sub_max_nodes=5_000)
    sc.reset(streams_, at=0.0)
    out = {"n_cells": sc.n_cells, "cells": {s.name: sc.cell_of(s.name) for s in streams_},
           "uids": sc.instance_uids, "rows": []}
    for ev in _trace(ns, np.random.RandomState(5), streams_, 30):
        r = sc.apply(ev)
        plan = r.plan
        out["rows"].append((result_plain(r), sorted(s.name for s in sc.fleet),
                            sc.instance_uids,
                            sum(b.bin_type.cost for b in plan.solution.bins)))
    return out


def test_multicell_routing_and_merged_plan():
    want, got = _both(_multicell)
    assert got["n_cells"] == 2
    for name, cell in got["cells"].items():
        assert cell == ("vgg16" if int(name[1:]) % 5 < 2 else "zf")
    # uid strides never collide across cells.
    assert {uid // shard.UID_STRIDE for uid in got["uids"]} <= {0, 1}
    for plain, fleet, _uids, bin_cost in got["rows"]:
        assert sorted(p[0] for p in plain["assignments"]) == fleet
        assert all(0 <= p[1] < len(plain["instances"]) for p in plain["assignments"])
        assert plain["cost"] == pytest.approx(bin_cost)
        assert plain["lower_bound"] <= plain["cost"] + 1e-9
    assert got == want


def _rekey(ns):
    streams_ = _streams(ns, 20)
    key = ns.shard.hash_cells(3)

    def build(seed):
        sc = ns.shard.ShardedController(_manager(ns), ns.ST3, cell_key=key, sub_max_nodes=5_000)
        sc.reset(streams_, at=0.0)
        rows = [result_plain(sc.apply(ev))
                for ev in _trace(ns, np.random.RandomState(seed), streams_, 25)]
        return sc, rows

    (a, rows_a), (b, rows_b) = build(3), build(9)
    out = {"rows": (rows_a, rows_b)}
    for tag, sc in (("a", a), ("b", b)):
        out[f"rekey_{tag}"] = result_plain(sc.rekey(key))
        out[f"cells_{tag}"] = {s.name: sc.cell_of(s.name) for s in sc.fleet}
        out[f"keys_{tag}"] = {s.name: key(s) for s in sc.fleet}
    out["cost"] = a.total_cost()
    out["again"] = result_plain(a.rekey(key))
    out["cost_again"] = a.total_cost()
    out["cells_again"] = {s.name: a.cell_of(s.name) for s in a.fleet}
    out["uids"] = (a.instance_uids, b.instance_uids)
    return out


def test_rekey_routing_is_deterministic():
    want, got = _both(_rekey)
    # Re-keying lands every surviving stream in the cell its name hashes
    # to, independent of how it got there.
    assert got["cells_a"] == got["keys_a"] and got["cells_b"] == got["keys_b"]
    shared = got["cells_a"].keys() & got["cells_b"].keys()
    assert shared
    assert all(got["cells_a"][n] == got["cells_b"][n] for n in shared)
    # Re-keying again is a fixpoint: same partition, same cost.
    assert got["cost_again"] == pytest.approx(got["cost"])
    assert got["cells_again"] == got["keys_a"]
    assert got == want


def _rebalance(ns):
    streams_ = _streams(ns, 32)
    sc = ns.shard.ShardedController(_manager(ns), ns.ST3, cell_key=ns.shard.hash_cells(4),
                                    sub_max_nodes=5_000)
    sc.reset(streams_, at=0.0)
    rows = []
    for i, ev in enumerate(_trace(ns, np.random.RandomState(13), streams_, 40)):
        r = sc.apply(ev)
        if i % 8 == 7:
            before = sc.total_cost()
            actions = sc.rebalance(max_moves=4)
            rows.append({
                "event": result_plain(r), "before": before, "after": sc.total_cost(),
                "actions": tuple(actions),
                "placed": sorted(p.stream.name for p in sc.plan.placements),
                "fleet": sorted(s.name for s in sc.fleet),
                "cells": {s.name: sc.cell_of(s.name) for s in sc.fleet},
                "uids": sc.instance_uids,
                "stats": sc.stats(),
            })
    return rows


def test_rebalance_never_raises_total_cost():
    want, got = _both(_rebalance)
    for row in got:
        assert row["after"] <= row["before"] + 1e-9
        # Rebalancing moves streams between cells; it never loses one.
        assert row["placed"] == row["fleet"]
    assert len(got) == 5
    assert got == want


def _sharded_churn(ns):
    streams_ = _streams(ns, 16)
    mgr = _manager(ns)
    trace = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(2), n_events=10)
    out = ns.simulate_churn(
        mgr, streams_, trace, ns.profiler.paper_profile_table(),
        cell_key=ns.shard.hash_cells(2),
        policy_factory=lambda: ns.policy.ConsolidationPolicy(max_migrations=2),
        rebalance_every=5)
    with pytest.raises(TypeError, match="policy_factory, not policy"):
        ns.simulate_churn(
            mgr, streams_, trace, ns.profiler.paper_profile_table(),
            cell_key=ns.shard.hash_cells(2),
            policy=ns.policy.ConsolidationPolicy(max_migrations=2),
            policy_factory=lambda: ns.policy.ConsolidationPolicy(max_migrations=2))
    return out


def _assert_same_output(got, want):
    assert got.keys() == want.keys()
    assert len(got["timeline"]) == len(want["timeline"])
    for i, (a, b) in enumerate(zip(got["timeline"], want["timeline"])):
        assert a == b, i
    for key in got:
        assert got[key] == want[key], key


def test_sharded_simulate_churn_and_policy_factory_guard():
    want, got = _both(_sharded_churn)
    assert got["final_cost"] > 0
    _assert_same_output(got, want)


# ----------------------------------------------------- padded batched pack


def _random_fleets(ns, seed, count=10):
    rng = np.random.RandomState(seed)
    cat = (
        ns.pb.BinType("a", (10.0, 6.0), 1.0),
        ns.pb.BinType("b", (20.0, 30.0), 2.3),
        ns.pb.BinType("g", (8.0, 15.0), 0.65),
    )
    probs = []
    for k in range(count):
        n = rng.randint(1, 25)
        items = []
        for i in range(n):
            ch = [ns.pb.Choice("cpu", (rng.uniform(0.5, 5.0), rng.uniform(0.5, 5.0)))]
            if rng.rand() < 0.5:
                ch.append(ns.pb.Choice("accel", (rng.uniform(0.2, 2.0), rng.uniform(0.2, 2.0))))
            items.append(ns.pb.Item(f"p{k}s{i}", tuple(ch)))
        probs.append(ns.pb.Problem(cat, tuple(items)))
    return probs


def _solution_plain(sol):
    return (sol.cost, tuple((a.item_index, a.choice_index, a.bin_index) for a in sol.assignments),
            tuple((b.bin_type.name, tuple(b.load)) for b in sol.bins))


@pytest.mark.parametrize("best_fit", [False, True])
def test_batched_pack_matches_serial_exactly(best_fit):
    """One `pack_scan` over padded per-fleet tensors decodes to the same
    solutions as packing each fleet serially, in the port and in the
    reference's numpy `_pack`."""
    probs = _random_fleets(PORT, 3)
    batched = h.batched_pack(probs, best_fit=best_fit, device="cpu")
    assert len(batched) == len(probs)
    want = [_solution_plain(ref_h._pack(p, best_fit)) for p in _random_fleets(REF, 3)]
    for p, sol, w in zip(probs, batched, want):
        assert _solution_plain(sol) == _solution_plain(h._pack(p, best_fit)) == w


def test_batched_pack_edge_cases_hold_the_documented_error():
    """The reference's edge cases, with the documented mixed-catalog
    ``ValueError`` (the reference's no-jax fallback skips that check)."""
    assert h.batched_pack([], device="cpu") == []
    [p] = _random_fleets(PORT, 5, count=1)
    [sol] = h.batched_pack([p], device="cpu")
    [rp] = _random_fleets(REF, 5, count=1)
    assert _solution_plain(sol) == _solution_plain(ref_h._pack(rp, False))
    other = problem.Problem((problem.BinType("x", (4.0, 4.0), 1.0),), p.items[:1])
    with pytest.raises(ValueError, match="shared catalog"):
        h.batched_pack([p, other], device="cpu")


# -------------------------------------------------------- partial-bin swap


def _unit_table(ns):
    t = ns.profiler.ProfileTable()
    fsz = ns.st.COMMON_FRAME_SIZES[0]
    t.add(ns.profiler.ResourceProfile("unit", str(fsz), "cpu", reference_fps=1.0,
                                      requirement=(1.0, 0.0, 0.0, 0.0), max_fps=100.0))
    return t


def _unit_spec(ns, name, size):
    return ns.st.StreamSpec(name, ns.st.AnalysisProgram("unit", "unit"), float(size),
                            frame_size=ns.st.COMMON_FRAME_SIZES[0])


def _swap_scenario(ns, **policy_kw):
    """Cap-10 bins holding {y1=2, y2=2, z=5}, {x=6}, {w=5}: no whole-bin
    evacuation fits in 2 moves, the {x, z} exchange closes a bin."""
    mgr = ns.mgr((ns.pb.BinType("box", (10.0, 100.0, 0.0, 0.0), 1.0),), _unit_table(ns),
                 utilization_cap=1.0, max_nodes=20_000)
    ctrl = mgr.controller(ns.ST3, gap_threshold=100.0,
                          policy=ns.policy.ConsolidationPolicy(max_migrations=2, **policy_kw))
    ctrl.reset([_unit_spec(ns, "y1", 2), _unit_spec(ns, "y2", 2), _unit_spec(ns, "z", 5)],
               at=0.0)
    ctrl.apply(ns.st.StreamAdded(_unit_spec(ns, "x", 6), at=1.0))
    r = ctrl.apply(ns.st.StreamAdded(_unit_spec(ns, "w", 5), at=2.0))
    return ctrl, r


def _swap(ns):
    plain, r_plain = _swap_scenario(ns)
    swap, r_swap = _swap_scenario(ns, swap_moves=True)
    return result_plain(r_plain), result_plain(r_swap), swap.plan.hourly_cost


def test_swap_move_closes_bin_plain_policy_cannot():
    want, got = _both(_swap)
    r_plain, r_swap, swap_cost = got
    assert len(r_plain["instances"]) == 3 and r_plain["cost"] == pytest.approx(3.0)
    assert len(r_swap["instances"]) == 2 and swap_cost == pytest.approx(2.0)
    assert any(a.startswith("swap:") for a in r_swap["actions"])
    assert sorted(p[0] for p in r_swap["assignments"]) == ["w", "x", "y1", "y2", "z"]
    assert got == want


def _try_swap(ns):
    ctrl, _ = _swap_scenario(ns)
    for args, exc in ((("x", "x"), ValueError), (("x", "nosuch"), KeyError),
                      (("y1", "y2"), ValueError)):
        with pytest.raises(exc):
            ctrl.try_swap(*args)
    before = ctrl.plan.hourly_cost
    useless = ctrl.try_swap("x", "w")
    after_useless = ctrl.plan.hourly_cost
    win = ctrl.try_swap("x", "z")
    return (before, after_useless, dataclass_plain(useless), dataclass_plain(win),
            len(ctrl.plan.instances))


def dataclass_plain(r):
    return tuple(getattr(r, f) for f in type(r).__dataclass_fields__)


def test_try_swap_validation_and_certification():
    want, got = _both(_try_swap)
    before, after_useless, useless, win, n_instances = got
    # A legal but useless exchange is certified and rejected, not adopted.
    assert not useless[0] and after_useless == pytest.approx(before)
    assert win[0] and win[1] - win[2] == pytest.approx(1.0)
    assert n_instances == 2
    assert got == want


# ------------------------------------------------------- spot price drift


def _trace_plain(trace):
    from repro_torch.interop import event_to_plain

    return [event_to_plain(ev) for ev in trace.events]


def _drift(ns):
    streams_ = _streams(ns, 6)
    kw = dict(n_events=12, preemption_hazard=0.5, hazard_pool=16)
    base = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(11), **kw)
    nodrift = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(11), price_drift=0.0,
                                          price_drift_types=[("c4.2xlarge-spot", 0.1)], **kw)
    kw = dict(n_events=12, preemption_hazard=0.4, hazard_pool=16)
    drift_kw = dict(price_drift=0.3, price_drift_types=[("a-spot", 0.10), ("b-spot", 0.25)],
                    price_drift_gap_hours=0.1)
    t1 = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(21), **kw, **drift_kw)
    t2 = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(21), **kw, **drift_kw)
    ref = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(21), **kw)
    return {name: _trace_plain(t) for name, t in
            (("base", base), ("nodrift", nodrift), ("t1", t1), ("t2", t2), ("ref", ref))}, t1


def test_price_drift_zero_is_bit_identical_and_the_overlay_seeded_and_coupled():
    (want, _), (got, t1) = _both(_drift)
    assert got["nodrift"] == got["base"]
    assert got["t1"] == got["t2"]  # same seed, same walk
    walks = [ev for ev in t1.events if isinstance(ev, streams.PriceChanged)]
    churn = [ev for ev in got["t1"] if ev[0] not in ("PriceChanged", "InstancePreempted")]
    assert walks, "drift > 0 must emit PriceChanged events"
    assert {ev.instance_type for ev in walks} == {"a-spot", "b-spot"}
    floors = {"a-spot": 0.005, "b-spot": 0.0125}
    assert all(ev.cost >= floors[ev.instance_type] - 1e-12 for ev in walks)
    assert t1.times() == tuple(sorted(t1.times()))
    # Drift draws come after churn + hazard: the churn subsequence matches
    # the drift-free trace exactly.
    assert churn == [ev for ev in got["ref"] if ev[0] != "InstancePreempted"]
    assert got == want


@pytest.mark.parametrize("kw", [{"price_drift": 0.1},
                                {"price_drift": 0.1, "price_drift_types": [("x", 1.0)],
                                 "price_drift_gap_hours": 0.0}])
def test_price_drift_validation(kw):
    for ns in (REF, PORT):
        with pytest.raises(ValueError):
            ns.st.synthetic_timed_trace(_streams(ns, 3), np.random.RandomState(1), n_events=2,
                                        **kw)


# ------------------------------------------- the manager's sharded controller


def _registry(ns):
    mgr = _manager(ns)
    sc = mgr.sharded_controller(ns.ST3, cell_key=ns.shard.hash_cells(3), rebalance_every=4)
    sc.reset(_streams(ns, 18), at=0.0)
    same = mgr.sharded_controller(ns.ST3, gap_threshold=0.5, rebalance_moves=2)
    mgr.sharded_controller(ns.ST3, billing=ns.lifecycle.BillingModel(boot_hours=0.05,
                                                                      quantum_hours=1.0))
    with pytest.raises(TypeError, match="unknown sharded controller option"):
        mgr.sharded_controller(ns.ST3, policy=None)
    flat = mgr.controller(ns.ST3)
    return {
        "same": same is sc, "flat_apart": flat is not sc,
        "options": (sc.gap_threshold, sc.rebalance_every, sc.rebalance_moves),
        "cell_gaps": sorted(c.gap_threshold for c in sc.cells.values()),
        "billing": [(c.billing.boot_hours, c.billing.quantum_hours) for c in sc.cells.values()],
        "uids": sc.instance_uids,
        "billed": sc.lifecycle.billed_cost(1.0),
        "records": len(sc.lifecycle.records()),
    }


def test_manager_sharded_controller_registry_and_reconfiguration():
    """`ResourceManager.sharded_controller`: one per strategy, apart from
    the flat controllers, reconfigured in place; a billing swap reaches
    every live cell (`set_billing`)."""
    want, got = _both(_registry)
    assert got["same"] and got["flat_apart"]
    assert got["options"] == (0.5, 4, 2)
    assert got["billing"] == [(0.05, 1.0)] * 3
    assert got == want


# ------------------------------------------------------ the C2 repair


def _flat_churn(ns, kw):
    mgr = _manager(ns)
    streams_ = _streams(ns, 12)
    trace = ns.st.synthetic_timed_trace(streams_, np.random.RandomState(4), n_events=8)
    return ns.simulate_churn(mgr, streams_, trace, ns.profiler.paper_profile_table(), **kw)


@pytest.mark.parametrize("kw", [{"rebalance_every": 2}, {"reset_pack": "ffd"}],
                         ids=["rebalance_every", "reset_pack"])
def test_flat_simulate_churn_ignores_the_sharded_arguments(kw):
    """Without ``cell_key`` or ``policy_factory`` the replay is flat, as the
    reference's: ``rebalance_every`` and ``reset_pack`` are read only on
    the sharded path (the port once raised here)."""
    want, got = _both(_flat_churn, kw)
    _assert_same_output(got, want)
    _assert_same_output(got, _flat_churn(PORT, {}))


@pytest.mark.parametrize("kw", [
    {"cell_key": "hash3"},
    {"policy_factory": "consolidation"},
    {"cell_key": "hash3", "policy_factory": "consolidation", "reset_pack": "batched"},
], ids=["cell_key", "policy_factory", "both_batched"])
def test_sharded_simulate_churn_arguments_match_the_reference(kw):
    def run(ns):
        args = dict(kw)
        if "cell_key" in args:
            args["cell_key"] = ns.shard.hash_cells(3)
        if "policy_factory" in args:
            args["policy_factory"] = lambda: ns.policy.ConsolidationPolicy(max_migrations=2)
        return _flat_churn(ns, args)

    want, got = _both(run)
    _assert_same_output(got, want)


def test_sharded_simulate_churn_with_policy_and_factory_is_a_type_error():
    for ns in (REF, PORT):
        with pytest.raises(TypeError, match="policy_factory, not policy"):
            _flat_churn(ns, {"policy": ns.policy.ConsolidationPolicy(max_migrations=2),
                             "policy_factory": lambda: None})


# ------------------------------------------------------ the C3 repair


def _ten_class_controller(ns):
    """A flat controller whose fleet has 10 item classes (above the
    arc-flow cutoff of 8, so pricing goes through colgen's knapsack DP)."""
    kinds = _kinds(ns) + [(p, f * 2) for p, f in _kinds(ns)]
    art = ns.cal.CalibrationArtifact.load(CALIBRATION)
    mgr = ns.mgr(ns.catalog.paper_ec2_catalog(), None, calibration=art)
    ctrl = mgr.controller()
    ctrl.reset([ns.st.StreamSpec(f"k{i}", *kinds[i]) for i in range(10)])
    return ctrl


def test_plain_runtime_error_in_pricing_prices_nothing(monkeypatch):
    """A torch op error inside pricing is a pricing blow-up: no prices, the
    density bound, as the reference does with any exception."""
    ref_ctrl = _ten_class_controller(REF)
    ctrl = _ten_class_controller(PORT)
    assert ctrl.refresh_prices() == ref_ctrl.refresh_prices()

    def torch_op_error(*args, **kwargs):
        raise RuntimeError("The size of tensor a (3) must match the size of tensor b (4)")

    def ref_error(*args, **kwargs):
        raise RuntimeError("pricing blew up")

    monkeypatch.setattr(knapsack, "_dispatch", torch_op_error)
    monkeypatch.setattr(ref_colgen, "_price_dp", ref_error)
    lb, ref_lb = ctrl.refresh_prices(), ref_ctrl.refresh_prices()
    assert ctrl._prices == {} and ref_ctrl._prices == {}
    assert lb == ref_lb == controller.bincompletion.root_lower_bound(ctrl._problem)
    for exc in (NotImplementedError("x"), RecursionError("x"), torch.OutOfMemoryError("x")):
        def raise_it(*args, exc=exc, **kwargs):
            raise exc
        monkeypatch.setattr(knapsack, "_dispatch", raise_it)
        assert ctrl.refresh_prices() == lb and ctrl._prices == {}


def test_kernel_error_surfaces_from_pricing(monkeypatch):
    ctrl = _ten_class_controller(PORT)

    def fail(*args, **kwargs):
        raise port_device.KernelError("knapsack_dp kernel launch failed (cluster): CUDA error 700")

    monkeypatch.setattr(knapsack, "_dispatch", fail)
    with pytest.raises(port_device.KernelError, match="kernel launch failed"):
        ctrl.refresh_prices()


def test_kernel_error_is_the_port_exception_type():
    """`KernelError` is a `RuntimeError`, raised for a missing card and
    by the device section of every kernel's call."""
    assert issubclass(port_device.KernelError, RuntimeError)
    if not torch.cuda.is_available():
        with pytest.raises(port_device.KernelError, match="no CUDA device"):
            port_device.resolve_device(None)
    with port_device.on_card(torch.device("cpu"), "x"):
        pass
    with pytest.raises(ValueError):  # the CPU: unchanged
        with port_device.on_card(torch.device("cpu"), "x"):
            raise ValueError("plain")
    with pytest.raises(RuntimeError) as info:
        with port_device.on_card(torch.device("cpu"), "x"):
            raise RuntimeError("plain")
    assert type(info.value) is RuntimeError
    with pytest.raises(port_device.KernelError, match="pack_scan on cuda:0: CUDA error"):
        with port_device.on_card(torch.device("cuda:0"), "pack_scan"):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
    with pytest.raises(ValueError):  # not a torch error: unchanged on the card too
        with port_device.on_card(torch.device("cuda:0"), "pack_scan"):
            raise ValueError("pack orders must lie in [0, n)")


# ------------------------------------- chip_smoke.py's phase 4c, cut small


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def phase_4c():
    """`chip_smoke.py`'s phase-4c replays, cut to 600 streams over 6 cells
    (a, b), 40 streams (c) and 16 over 3 cells (d), through both packages
    (the threaded fold through the port alone, as on the card); the port
    on the CPU."""
    cs = _chip_smoke()
    cs.SHARD_STREAMS, cs.SHARD_CELLS, cs.SHARD_EVENTS = 600, 6, 24
    cs.PARITY_STREAMS, cs.PARITY_EVENTS = 40, 4
    cs.CHURN_STREAMS, cs.CHURN_CELLS, cs.CHURN_EVENTS, cs.CHURN_REBALANCE_EVERY = 16, 3, 6, 4
    port = cs.port_package()
    port.ResourceManager = functools.partial(manager.ResourceManager, device="cpu")
    ref = types.SimpleNamespace(
        st=ref_streams, ResourceManager=ref_manager.ResourceManager, ST3=REF_ST3,
        ShardedController=ref_shard.ShardedController, hash_cells=ref_shard.hash_cells,
        FleetController=ref_controller.FleetController,
        ConsolidationPolicy=ref_policy.ConsolidationPolicy,
        paper_ec2_catalog=ref_catalog.paper_ec2_catalog,
        paper_profile_table=ref_profiler.paper_profile_table,
        with_spot_variants=ref_with_spot_variants,
        simulate_churn=ref_simulator.simulate_churn)
    out = {}
    for name, pkg in (("ref", ref), ("port", port)):
        ticks = []
        big, batched = cs.big_replay(pkg, ticks.append, workers=name == "port")
        out[name] = {"a": big, "b": cs.shard_repack(pkg, batched, ticks.append),
                     "c": cs.cost_parity(pkg, ticks.append),
                     "d": cs.sharded_churn(pkg, ticks.append), "ticks": ticks}
    return out


@pytest.mark.parametrize("part", ["a", "b", "c", "d"])
def test_chip_smoke_shard_replays_match_the_reference(phase_4c, part):
    """The card phase's replays hold on the CPU at a small size: the port
    gives the reference's answers, and its own twins agree (delta 0, the
    threaded fold equal to the sequential one, one cell equal to flat)."""
    got, want = dict(phase_4c["port"][part]), phase_4c["ref"][part]
    if part == "a":
        assert got.pop("workers_equal")
        assert got["delta"] == 0.0 and got["cells"] == 6
        assert got["dispatches"][0] == 1 and got["certify_stats"]["pricing_dispatches"] >= 1
    if part == "c":
        assert got["one_cell_delta"] == 0.0
    assert got == want
    threaded = ("workers_prepare", "apply_workers")
    assert [t for t in phase_4c["port"]["ticks"] if t not in threaded] == phase_4c["ref"]["ticks"]


def test_a_failed_build_or_load_is_a_kernel_error(monkeypatch, tmp_path):
    """`_build` raises `KernelError` for a compiler that fails and for a
    library that does not load."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/bin/false")
    with pytest.raises(port_device.KernelError, match="nvcc failed"):
        _build.build_all(("pack",))
    (tmp_path / "libpack.so").write_bytes(b"not a shared library")
    with pytest.raises(port_device.KernelError, match="cannot load"):
        _build.build_all(("pack",))
