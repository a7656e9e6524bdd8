"""The port's batched event pipeline and batched certification against the
reference's (`core/shard.py`: `apply_events`, `refresh_prices`,
`colgen.batched_dual_prices`).

The cases of the reference's ``tests/test_shard.py`` that fold whole
traces through `ShardedController.apply_events`, at its sizes and seeds.
Each replay runs three times: the reference's serial loop, the port's
serial loop and the port's batched pipeline (the port on the CPU,
``device="cpu"``).  Per event the plain results (modes, costs, lower
bounds, gaps, nodes, actions, placements, bins), the simulator's facade
snapshots and, at the end, the ledgers must be equal, floats with ``==``:
the port's batched pipeline equals its own serial loop and both equal the
reference's.  The reference's batched pipeline is held to its serial loop
by the reference's own tests.  Seed 11 folds its cells on four threads
(``batch_workers=4``).

Then the batched certification: one stacked column-generation run over
every cell (`colgen.batched_dual_prices`) gives the reference's duals, LP
values and certified lower bounds bit for bit, and its catch-all falls
back to the serial per-cell loop on a pricing blow-up but lets
`device.KernelError` through.
"""
import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.core.binpack import colgen
from repro_torch.device import KernelError
from repro_torch.interop import stream_to_plain

from test_torch_shard import PORT, REF, _catalog, _manager, _streams, _trace, result_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's plain CPU paths (the knapsack's
    many small ops), whose thread handoffs cost more than they save when
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spot_manager(ns, **kw):
    """A manager whose catalog carries spot variants (hazard > 0), so
    sampled preemption shocks and notice/kill pairs actually land."""
    kw.setdefault("max_nodes", 20_000)
    catalog_ = ns.spot(_catalog(ns), price_ratio=0.35, hazard=0.4)
    return ns.mgr(catalog_, ns.profiler.paper_profile_table(), **kw)


def _mixed_trace(ns, seed, streams_, n_events=50):
    """Joins/leaves/re-rates, price-drift broadcasts, sampled shocks and
    notice/kill pairs on one seeded timeline, built in ``ns``."""
    tt = ns.st.synthetic_timed_trace(
        streams_, np.random.RandomState(seed), n_events=n_events,
        preemption_hazard=0.4, hazard_pool=16, price_drift=0.3,
        price_drift_types=[("c4.2xlarge-spot", 0.147)], price_drift_gap_hours=0.1)
    evs = list(tt.events)
    rng = np.random.RandomState(seed + 1)
    t0 = evs[len(evs) // 2].at
    extra = []
    for i in range(3):
        at = t0 + 0.013 * (i + 1)
        extra.append(ns.st.InstancePreemptionNotice(
            at=at, deadline=at + 0.15, draw=float(rng.rand()), pool=16, hazard_ref=0.4,
            notice_id=900 + i))
        extra.append(ns.st.InstancePreempted(at=at + 0.15, notice_id=900 + i))
    return sorted(evs + extra, key=lambda ev: ev.at)


def snapshot_plain(snap) -> dict:
    return {"uids": snap["uids"], "rungs": snap["rungs"],
            "parked": {k: stream_to_plain(v) for k, v in snap["parked"].items()},
            "tiers": {k: dataclasses.astuple(v) for k, v in snap["tiers"].items()}}


def _ledger_plain(ctrl, horizon):
    return {
        "billed": ctrl.lifecycle.billed_cost(horizon),
        "alive": ctrl.lifecycle.alive(horizon),
        "uids": ctrl.instance_uids,
        "parked": {k: stream_to_plain(v) for k, v in ctrl.parked.items()},
        "rungs": ctrl.degraded_rungs,
        "total": ctrl.total_cost(),
        "records": len(ctrl.lifecycle.records()),
    }


def _batched_replay(ns, seed, batched, workers):
    mgr = _spot_manager(ns)
    ctrl = mgr.sharded_controller(ns.ST3, cell_key=ns.shard.hash_cells(6))
    if workers:
        ctrl.batch_workers = workers
    ctrl.reset(_streams(ns, 48), at=0.0, pack="batched")
    trace = _mixed_trace(ns, seed, _streams(ns, 48))
    results, snaps = ctrl.apply_events(trace, batched=batched, with_snapshots=True)
    tiers: dict = {}
    for s in snaps:
        tiers.update(snapshot_plain(s)["tiers"])
    return {
        "results": [result_plain(r) for r in results],
        "snaps": [{k: v for k, v in snapshot_plain(s).items() if k != "tiers"}
                  for s in snaps],
        "tiers": tiers,
        "ledger": _ledger_plain(ctrl, trace[-1].at + 1.0),
        "kinds": {type(ev).__name__ for ev in trace},
        "stats": ctrl.stats(),
    }


@pytest.mark.parametrize("seed,workers", [(3, 0), (11, 4)])
def test_batched_apply_bit_identical_to_serial(seed, workers):
    want = _batched_replay(REF, seed, batched=False, workers=0)
    serial = _batched_replay(PORT, seed, batched=False, workers=0)
    got = _batched_replay(PORT, seed, batched=True, workers=workers)
    assert got["kinds"] >= {"StreamAdded", "StreamRemoved", "PriceChanged",
                            "InstancePreempted", "InstancePreemptionNotice"}
    assert len(got["results"]) == len(want["results"])
    for i, (a, b, c) in enumerate(zip(got["results"], serial["results"], want["results"])):
        assert a == b == c, i
    for i, (a, b, c) in enumerate(zip(got["snaps"], serial["snaps"], want["snaps"])):
        assert a == b == c, i
    # Batched tier updates are per-routed-cell deltas; the folded totals agree.
    assert all(serial["tiers"][name] == tier for name, tier in got["tiers"].items())
    assert serial["tiers"] == want["tiers"]
    assert got["ledger"] == serial["ledger"] == want["ledger"]
    assert got["stats"]["event_batches"] == 1
    assert got["stats"]["batch_barriers"] > 0  # price broadcasts and sampled shocks


def _barrier_replay(ns, batched):
    mgr = _manager(ns)
    ctrl = mgr.sharded_controller(ns.ST3, cell_key=ns.shard.hash_cells(4), rebalance_every=7)
    ctrl.reset(_streams(ns, 24), at=0.0)
    trace = _trace(ns, np.random.RandomState(5), _streams(ns, 24), 30)
    return [result_plain(r) for r in ctrl.apply_events(trace, batched=batched)], ctrl.stats()


def test_batched_apply_with_rebalance_barriers():
    """Rebalance trigger points force barriers: the batched pipeline still
    matches the serial loop event for event."""
    want, _ = _barrier_replay(REF, batched=False)
    serial, _ = _barrier_replay(PORT, batched=False)
    got, stats = _barrier_replay(PORT, batched=True)
    assert got == serial == want
    assert stats["batch_barriers"] > 0
    assert any(a.startswith("rebalance:") for r in got for a in r["actions"])


def _counters(ns):
    mgr = _manager(ns)
    ctrl = mgr.sharded_controller(ns.ST3, cell_key=ns.shard.hash_cells(4))
    ctrl.reset(_streams(ns, 24), at=0.0, pack="batched")
    trace = _trace(ns, np.random.RandomState(9), _streams(ns, 24), 20)
    rows = [result_plain(r) for r in ctrl.apply_events(trace)]
    after_apply = ctrl.stats()
    lb = ctrl.refresh_prices()
    return rows, after_apply, ctrl.stats(), lb


def test_batched_apply_stats_counters():
    want = _counters(REF)
    got = _counters(PORT)
    rows, st, st2, _lb = got
    assert st["events_routed"] == 20
    assert st["event_batches"] == 1
    assert st["batched_repair_dispatches"] >= 1  # the batched reset
    assert sum(st["events_per_cell"].values()) >= st["serial_repair_dispatches"] - 1
    # Batched certification counts pricing dispatches, not serial loops.
    assert st2["pricing_dispatches"] >= 1
    assert st2["serial_price_refreshes"] == 0
    assert got == want


def _cells_60(ns):
    ctrl = _manager(ns).sharded_controller(ns.ST3, cell_key=ns.shard.hash_cells(6))
    ctrl.reset(_streams(ns, 60), at=0.0)
    return ctrl


def _dual_prices(ns):
    ctrl = _cells_60(ns)
    probs = [c._problem for c in ctrl._cell_list if c._problem is not None]
    kw = {"device": "cpu"} if ns is PORT else {}
    serial = [ns.colgen.dual_prices(p, ns.colgen.ColumnPool(), **kw) for p in probs]
    stats: dict = {}
    batched = ns.colgen.batched_dual_prices(probs, ns.colgen.ColumnPool(), stats_out=stats, **kw)
    admissible = []
    for cell, p, (prices, lp) in zip(ctrl._cell_list, probs, batched):
        keys = ns.arcflow.item_class_keys(p)
        by_name = {item.name: k for item, k in zip(p.items, keys)}
        admissible.append((
            max(sum(prices.get(by_name[n], 0.0) for n in b.members) - b.bin_type.cost
                for b in cell._bins),
            lp - cell._plan.hourly_cost,
        ))
    return serial, batched, stats, admissible


def test_batched_dual_prices_parity_and_admissibility():
    """One stacked pricing run per round over every cell: the reference's
    duals and LP values bit for bit, equal to the serial per-cell LP
    values, admissible on every packed bin, below each cell's cost."""
    want = _dual_prices(REF)
    serial, batched, stats, admissible = got = _dual_prices(PORT)
    assert stats["pricing_dispatches"] >= 1
    for (_p, lp), (_sp, slp) in zip(batched, serial):
        assert lp == pytest.approx(slp, rel=1e-9, abs=1e-9)
    for bin_slack, lp_slack in admissible:
        assert bin_slack <= 1e-6 and lp_slack <= 1e-6
    assert got == want


def _refresh(ns, batched):
    ctrl = _cells_60(ns)
    lb = ctrl.refresh_prices(batched=batched)
    return lb, ctrl.total_cost(), ctrl.stats(), [c._prices for c in ctrl._cell_list], len(
        ctrl._cell_list)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "serial"])
def test_sharded_refresh_prices(batched):
    """The summed certified lower bound of every cell, from one stacked
    run (batched) or the per-cell loop: admissible, and the reference's."""
    want, got = _refresh(REF, batched), _refresh(PORT, batched)
    lb, total, stats, _prices, n_cells = got
    assert 0.0 < lb <= total + 1e-6
    if batched:
        assert stats["pricing_dispatches"] >= 1 and stats["serial_price_refreshes"] == 0
    else:
        assert stats["serial_price_refreshes"] == n_cells
    assert got == want


def _repair(ns):
    """`reset(pack="batched")`, `repack`, `refresh_prices` and `rebalance`
    on a 60-stream, 6-cell fleet after some churn."""
    ctrl = _manager(ns).sharded_controller(ns.ST3, cell_key=ns.shard.hash_cells(6))
    reset = result_plain(ctrl.reset(_streams(ns, 60), at=0.0, pack="batched"))
    rows = [result_plain(r) for r in
            ctrl.apply_events(_trace(ns, np.random.RandomState(17), _streams(ns, 60), 24))]
    repack = result_plain(ctrl.repack())
    repack_bfd = result_plain(ctrl.repack(best_fit=True))
    lb = ctrl.refresh_prices()
    moves = ctrl.rebalance(max_moves=4)
    return {"reset": reset, "rows": rows, "repack": repack, "repack_bfd": repack_bfd,
            "lb": lb, "moves": moves, "after": result_plain(ctrl._result(mode="noop")),
            "stats": ctrl.stats(), "uids": ctrl.instance_uids}


def test_batched_repair_and_market_on_the_cpu_match_the_reference():
    """The sharded controller's device work runs on the manager's device:
    with ``device="cpu"`` the batched reset, repack, certification and
    market need no card and give the reference's answers."""
    want, got = _repair(REF), _repair(PORT)
    assert got["stats"]["batched_repair_dispatches"] == 3
    assert got == want


def test_batched_prices_fall_back_only_on_a_pricing_blow_up(monkeypatch):
    """`_batched_prices` (the certification and the market's price quote)
    turns a pricing blow-up into the serial per-cell loop, as the
    reference's; a `KernelError` surfaces from both."""
    ctrl = _cells_60(PORT)
    want = _cells_60(PORT).refresh_prices(batched=False)

    def blow_up(*args, **kwargs):
        raise RuntimeError("a torch op error inside the stacked run")

    monkeypatch.setattr(colgen, "batched_dual_prices", blow_up)
    assert ctrl._batched_prices([c._problem for c in ctrl._cell_list]) is None
    assert ctrl.refresh_prices() == want
    assert ctrl.stats()["serial_price_refreshes"] == len(ctrl._cell_list)

    def kernel_failure(*args, **kwargs):
        raise KernelError("knapsack_dp kernel launch failed (cluster): CUDA error 700")

    monkeypatch.setattr(colgen, "batched_dual_prices", kernel_failure)
    with pytest.raises(KernelError):
        ctrl.refresh_prices()
    with pytest.raises(KernelError):
        ctrl.rebalance()


def test_batched_prices_let_a_grid_the_kernel_refuses_through(monkeypatch):
    """A knapsack that only the kernel refuses (its grid past a lowered
    `_MAX_STATES`) is a `KernelError`: `_batched_prices` re-raises it, and
    neither the certification nor the market moves to the serial per-cell
    loop.  On the CPU `_dispatch` runs the plain DP, so the card's refusals
    are put in front of it."""
    from repro_torch.core import shard
    from repro_torch.kernels import knapsack

    ctrl = _cells_60(PORT)
    plain = knapsack._dispatch

    def card_dispatch(sv, sw, fi, levels):
        knapsack._refusals(sv, sw, fi, int(np.prod(levels)))
        return plain(sv, sw, fi, levels)

    def no_serial_loop(*args, **kwargs):
        raise AssertionError("fell back to the serial per-cell prices")

    monkeypatch.setattr(knapsack, "_dispatch", card_dispatch)
    monkeypatch.setattr(knapsack, "_MAX_STATES", 16)
    monkeypatch.setattr(shard, "class_prices", no_serial_loop)
    with pytest.raises(KernelError, match="fewer than 16 states"):
        ctrl._batched_prices([c._problem for c in ctrl._cell_list])
    with pytest.raises(KernelError, match="fewer than 16 states"):
        ctrl.refresh_prices()
    with pytest.raises(KernelError, match="fewer than 16 states"):
        ctrl.rebalance()
    assert ctrl.stats()["serial_price_refreshes"] == 0


def test_rebalance_serial_quotes_and_moves_let_a_kernel_error_through(monkeypatch):
    """The market's serial price loop prices a blown-up cell at nothing, as
    the reference's; a failed kernel inside a trial move rolls both cells
    back and then surfaces."""
    from repro_torch.core import shard

    ctrl = _cells_60(PORT)
    monkeypatch.setattr(ctrl, "_batched_prices", lambda problems: None)
    calls = []

    def quote(problem, pool, *, device=None):
        calls.append(device)
        raise RuntimeError("pricing blew up")

    monkeypatch.setattr(shard, "class_prices", quote)
    assert ctrl.rebalance() == []  # every cell exports nothing: no candidates
    assert len(calls) == len(ctrl._cell_list) and {str(d) for d in calls} == {"cpu"}

    def kernel_failure(problem, pool, *, device=None):
        raise KernelError("placement_scores kernel launch failed: CUDA error 700")

    monkeypatch.setattr(shard, "class_prices", kernel_failure)
    with pytest.raises(KernelError):
        ctrl.rebalance()

    monkeypatch.undo()
    ctrl = _cells_60(PORT)
    before = {k: (c.plan.hourly_cost, c.instance_uids, len(c.fleet))
              for k, c in ctrl.cells.items()}
    src = next(iter(ctrl.cells.values()))

    def failing_apply(event):
        raise KernelError("placement_scores kernel launch failed: CUDA error 700")

    monkeypatch.setattr(src, "apply", failing_apply)
    name = src.fleet[0].name
    dst_key = [k for k in ctrl.cells if ctrl.cells[k] is not src][0]
    with pytest.raises(KernelError):
        ctrl._try_move(name, ctrl.cell_of(name), dst_key, min_saving=0.0)
    assert {k: (c.plan.hourly_cost, c.instance_uids, len(c.fleet))
            for k, c in ctrl.cells.items()} == before


def test_formulate_cache_holds_under_threads():
    """The threaded fold formulates from several threads: the manager's
    bounded `formulate` cache evicts under a lock (the reference's
    unguarded eviction pops one key twice and raises ``KeyError`` here)."""
    mgr = _manager(PORT)
    fleets = [_streams(PORT, 2, prefix=f"c{i}_") for i in range(2_000)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            problems = list(ex.map(lambda f: mgr.formulate(f, PORT.ST3), fleets))
    finally:
        sys.setswitchinterval(old)
    assert len(mgr._formulate_cache) <= 64
    assert [tuple(i.name for i in p.items) for p in problems] == [
        tuple(s.name for s in f) for f in fleets]
