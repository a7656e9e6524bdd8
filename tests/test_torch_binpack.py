"""Parity of the port's MC-VBP layer with the JAX package's solvers.

Both packages get the same problems (built once in the reference and
carried across as plain values by `repro_torch.interop`).  The port keeps
the reference's numpy float64 host arithmetic, so every comparison is
exact: tensor arrays, costs, assignment triples and certified bounds.
Branch-and-price prices on the CPU here (``device="cpu"``, the plain torch
DP); the reference prices with its numpy DP.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import catalog as ref_catalog
from repro.core.binpack import (
    BinType as RefBinType,
    Choice as RefChoice,
    Item as RefItem,
    Problem as RefProblem,
)
from repro.core.binpack import arcflow as ref_arcflow
from repro.core.binpack import bincompletion as ref_bc
from repro.core.binpack import bruteforce as ref_bf
from repro.core.binpack import colgen as ref_colgen
from repro.core.binpack import heuristics as ref_heur

from repro_torch.core import catalog
from repro_torch.core.binpack import arcflow, bincompletion, bruteforce, colgen
from repro_torch.core.binpack import heuristics
from repro_torch.interop import problem_from_plain, problem_to_plain

FULL = (
    RefBinType("c4.2xlarge", (8, 15, 0, 0), 0.419),
    RefBinType("c4.8xlarge", (36, 60, 0, 0), 1.675),
    RefBinType("g2.2xlarge", (8, 15, 1536, 4), 0.650),
)

#: tests/test_colgen.py's golden seeds: (n, seed, n_kinds) per scenario.
GOLDEN_FLEETS = {
    "hetero3": (10, 42, 3),
    "hetero5": (12, 7, 5),
    "small2": (6, 1, 2),
    "small3": (8, 2, 3),
    "small4": (16, 5, 4),
}
NAMES = sorted(GOLDEN_FLEETS)


def _ref_fleet(n, seed, n_kinds, catalog=FULL):
    """tests/test_colgen.py's generator, in the reference package."""
    rng = np.random.RandomState(seed)
    kinds = []
    for _ in range(n_kinds):
        cpu = rng.uniform(1.0, 5.0)
        kinds.append(
            (
                (cpu, rng.uniform(0.2, 1.0), 0.0, 0.0),
                (cpu * 0.13, rng.uniform(0.2, 1.0), rng.uniform(30, 300),
                 rng.uniform(0.1, 0.6)),
            )
        )
    items = []
    for i in range(n):
        c, g = kinds[i % n_kinds]
        items.append(RefItem(f"s{i}", (RefChoice("cpu", c), RefChoice("accel", g))))
    return RefProblem(bin_types=catalog, items=tuple(items))


def _pair(name):
    ref = _ref_fleet(*GOLDEN_FLEETS[name])
    return ref, problem_from_plain(problem_to_plain(ref))


def _triples(sol):
    return [(a.item_index, a.choice_index, a.bin_index) for a in sol.assignments]


def _assert_same_solution(got, ref):
    got.validate()
    assert got.cost == ref.cost
    assert _triples(got) == _triples(ref)
    assert [b.bin_type.name for b in got.bins] == [b.bin_type.name for b in ref.bins]
    assert [b.load for b in got.bins] == [b.load for b in ref.bins]


def _assert_same_tensors(got, ref):
    for field in type(ref).__dataclass_fields__:
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_problem_tensors_equal(name):
    ref, got = _pair(name)
    assert problem_to_plain(got) == problem_to_plain(ref)
    rt, gt = ref.tensors(), got.tensors()
    _assert_same_tensors(gt, rt)
    keep = list(range(0, len(ref.items), 2))
    _assert_same_tensors(gt.drop_items(keep), rt.drop_items(keep))
    _assert_same_tensors(
        gt.drop_items(keep).append_items(gt), rt.drop_items(keep).append_items(rt)
    )
    _assert_same_tensors(gt.with_costs([1.0, 2.0, 0.5]),
                         rt.with_costs([1.0, 2.0, 0.5]))
    n = len(ref.items)
    choice_indices = np.zeros((n, 1), dtype=np.intp)
    choice_mask = np.ones((n, 1), dtype=bool)
    _assert_same_tensors(gt.restrict([0, 1], choice_indices, choice_mask),
                         rt.restrict([0, 1], choice_indices, choice_mask))


@pytest.mark.parametrize("name", NAMES)
def test_heuristics_equal(name):
    ref, got = _pair(name)
    _assert_same_solution(heuristics.first_fit_decreasing(got),
                          ref_heur.first_fit_decreasing(ref))
    _assert_same_solution(heuristics.best_fit_decreasing(got),
                          ref_heur.best_fit_decreasing(ref))
    t = ref.tensors()
    resid = np.asarray([[6.0, 10.0, 500.0, 2.0], [2.0, 3.0, 0.0, 0.0]])
    np.testing.assert_array_equal(
        heuristics.placement_scores_np(t.req, t.choice_mask, resid),
        ref_heur.placement_scores_np(t.req, t.choice_mask, resid),
    )


@pytest.mark.parametrize("name", NAMES)
def test_exact_solvers_equal(name):
    ref, got = _pair(name)
    g_sol, g_st = bincompletion.solve(got)
    r_sol, r_st = ref_bc.solve(ref)
    _assert_same_solution(g_sol, r_sol)
    assert dataclasses.asdict(g_st) == dataclasses.asdict(r_st)
    assert bincompletion.root_lower_bound(got) == ref_bc.root_lower_bound(ref)
    g_sol, g_st = arcflow.solve_arcflow(got)
    r_sol, r_st = ref_arcflow.solve_arcflow(ref)
    _assert_same_solution(g_sol, r_sol)
    assert (g_st.lp_bound, g_st.optimal, g_st.n_patterns) == (
        r_st.lp_bound, r_st.optimal, r_st.n_patterns)
    g_prices, g_lb = arcflow.dual_prices(got)
    r_prices, r_lb = ref_arcflow.dual_prices(ref)
    assert g_prices == r_prices and g_lb == r_lb


@pytest.mark.parametrize("name", NAMES)
def test_colgen_equal(name):
    ref, got = _pair(name)
    g_sol, g_st = colgen.solve_colgen(got, device="cpu")
    r_sol, r_st = ref_colgen.solve_colgen(ref, impl="numpy")
    _assert_same_solution(g_sol, r_sol)
    # lp_bound, optimal and the work counters: every field
    assert dataclasses.asdict(g_st) == dataclasses.asdict(r_st)


def test_colgen_dual_prices_equal():
    ref, got = _pair("hetero5")
    g_pool, r_pool = colgen.ColumnPool(), ref_colgen.ColumnPool()
    assert colgen.dual_prices(got, g_pool, device="cpu") == ref_colgen.dual_prices(
        ref, r_pool, impl="numpy")
    assert len(g_pool) == len(r_pool)
    others = [_pair(n) for n in ("small2", "small3")]
    g_stats, r_stats = {}, {}
    got_prices = colgen.batched_dual_prices(
        [g for _r, g in others], device="cpu", stats_out=g_stats)
    ref_prices = ref_colgen.batched_dual_prices(
        [r for r, _g in others], impl="numpy", stats_out=r_stats)
    assert got_prices == ref_prices and g_stats == r_stats


@pytest.mark.parametrize("fleet", [(6, 1, 2), (7, 2, 3)])
def test_bruteforce_equal(fleet):
    ref = _ref_fleet(*fleet)
    got = problem_from_plain(problem_to_plain(ref))
    _assert_same_solution(bruteforce.solve_bruteforce(got),
                          ref_bf.solve_bruteforce(ref))


def test_warm_incumbent_equal():
    ref, got = _pair("small4")
    r_inc = ref_heur.first_fit_decreasing(ref)
    g_inc = heuristics.first_fit_decreasing(got)
    g_sol, _ = bincompletion.solve(got, incumbent=g_inc, max_nodes=2_000)
    r_sol, _ = ref_bc.solve(ref, incumbent=r_inc, max_nodes=2_000)
    _assert_same_solution(g_sol, r_sol)


def test_catalogs_equal():
    for flag in (False, True):
        got = catalog.paper_ec2_catalog(include_multi_gpu=flag)
        ref = ref_catalog.paper_ec2_catalog(include_multi_gpu=flag)
        assert [(b.name, b.capacity, b.cost) for b in got] == [
            (b.name, b.capacity, b.cost) for b in ref]
        assert catalog.catalog_signature(got) == ref_catalog.catalog_signature(ref)
    got, ref = catalog.tpu_cloud_catalog(), ref_catalog.tpu_cloud_catalog()
    assert catalog.catalog_signature(got) == ref_catalog.catalog_signature(ref)
    spot = catalog.with_spot_variants(got, hazards={"v5e-1": 0.1})
    ref_spot = ref_catalog.with_spot_variants(ref, hazards={"v5e-1": 0.1})
    assert [(b.name, b.cost, b.hazard) for b in spot] == [
        (b.name, b.cost, b.hazard) for b in ref_spot]
