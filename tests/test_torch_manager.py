"""Parity of the port's resource manager with the JAX package's, end to end.

The paper's Table 6 and 61% headline (tests/test_paper_scenarios.py) hold
in the port, and the port's plans are identical to the reference's —
instances, placements, assignment triples, loads and cost — including a
30-stream, 10-kind fleet that routes to branch-and-price.  The port runs
with ``device="cpu"`` (plain torch pricing); the reference prices with its
numpy DP.  Comparisons are exact: the host arithmetic is the same numpy
float64 code, and the pricing DP is bit-identical.
"""
import numpy as np
import pytest
import torch

from repro.core.binpack import BinType as RefBinType
from repro.core.catalog import paper_ec2_catalog as ref_ec2_catalog
from repro.core.manager import ResourceManager as RefManager
from repro.core.profiler import paper_profile_table as ref_profile_table
from repro.core.simulator import simulate_plan as ref_simulate_plan
from repro.core.strategies import ALL_STRATEGIES as REF_STRATEGIES
from repro.core.streams import AnalysisProgram as RefProgram
from repro.core.streams import StreamSpec as RefStream

from repro_torch.core.binpack import BinType, InfeasibleError
from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.core import manager as manager_module
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
from repro_torch.core.shard import ShardedController
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.strategies import ALL_STRATEGIES, ST1, ST2, ST3
from repro_torch.core.streams import AnalysisProgram, StreamSpec
from repro_torch.interop import (
    plan_to_plain,
    profile_table_from_plain,
    profile_table_to_plain,
)
from repro_torch.kernels import knapsack

#: (name, program_id, fps) per stream, per paper scenario (§4.1).
SCENARIOS = {
    1: [("v1", "vgg16", 0.25)] + [(f"z{i}", "zf", 0.55) for i in range(3)],
    2: [("v1", "vgg16", 0.20), ("z1", "zf", 0.50)],
    3: [(f"v{i}", "vgg16", 0.20) for i in range(2)]
       + [(f"z{i}", "zf", 8.0) for i in range(10)],
}

#: Paper Table 6 (scenario, strategy) -> (hourly cost, {type: count}).
TABLE6 = {
    (1, "ST1"): (1.676, {"c4.2xlarge": 4}),
    (1, "ST2"): (0.650, {"g2.2xlarge": 1}),
    (1, "ST3"): (0.650, {"g2.2xlarge": 1}),
    (2, "ST1"): (0.419, {"c4.2xlarge": 1}),
    (2, "ST2"): (0.650, {"g2.2xlarge": 1}),
    (2, "ST3"): (0.419, {"c4.2xlarge": 1}),
    (3, "ST1"): None,  # Fail
    (3, "ST2"): (7.150, {"g2.2xlarge": 11}),
    (3, "ST3"): (6.919, {"g2.2xlarge": 10, "c4.2xlarge": 1}),
}
STRATS = {"ST1": ST1, "ST2": ST2, "ST3": ST3}
REF_STRATS = {s.name: s for s in REF_STRATEGIES}
SCENARIO_CATALOG = (
    ("c4.2xlarge", (8, 15, 0, 0), 0.419),
    ("g2.2xlarge", (8, 15, 1536, 4), 0.650),
)
PROGRAMS = {"vgg16": "VGG-16", "zf": "ZF"}
#: The 10 stream kinds of the colgen-routed camera fleet.
KINDS = [("vgg16", f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
    ("zf", f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)
]


def _streams(spec):
    return [StreamSpec(n, AnalysisProgram(PROGRAMS[p], p), f) for n, p, f in spec]


def _ref_streams(spec):
    return [RefStream(n, RefProgram(PROGRAMS[p], p), f) for n, p, f in spec]


def _camera_spec(n):
    return [(f"cam{i}", *KINDS[i % 10]) for i in range(n)]


@pytest.fixture(scope="module")
def managers():
    port = ResourceManager(
        tuple(BinType(*b) for b in SCENARIO_CATALOG), paper_profile_table(),
        device="cpu",
    )
    ref = RefManager(tuple(RefBinType(*b) for b in SCENARIO_CATALOG),
                     ref_profile_table())
    return port, ref


def _assert_same_plan(got, ref):
    a, b = plan_to_plain(got), plan_to_plain(ref)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("scenario,strategy", sorted(TABLE6))
def test_table6_matches_paper_and_reference(managers, scenario, strategy):
    port, ref = managers
    expected = TABLE6[(scenario, strategy)]
    if expected is None:
        with pytest.raises(InfeasibleError):
            port.allocate(_streams(SCENARIOS[scenario]), STRATS[strategy])
        return
    cost, counts = expected
    plan = port.allocate(_streams(SCENARIOS[scenario]), STRATS[strategy])
    assert plan.optimal
    assert plan.hourly_cost == pytest.approx(cost, abs=1e-3)
    assert plan.instance_counts() == counts
    ref_plan = ref.allocate(_ref_streams(SCENARIOS[scenario]), REF_STRATS[strategy])
    _assert_same_plan(plan, ref_plan)


def test_headline_savings(managers):
    """Paper abstract: 'reduce up to 61% of the cost'."""
    port, _ref = managers
    s1 = {s.name: port.allocate(_streams(SCENARIOS[1]), s) for s in (ST1, ST3)}
    assert 1 - s1["ST3"].hourly_cost / s1["ST1"].hourly_cost == pytest.approx(
        0.61, abs=0.005)
    s2 = {s.name: port.allocate(_streams(SCENARIOS[2]), s) for s in (ST2, ST3)}
    assert 1 - s2["ST3"].hourly_cost / s2["ST2"].hourly_cost == pytest.approx(
        0.36, abs=0.01)
    s3 = {s.name: port.allocate(_streams(SCENARIOS[3]), s) for s in (ST2, ST3)}
    assert 1 - s3["ST3"].hourly_cost / s3["ST2"].hourly_cost == pytest.approx(
        0.03, abs=0.005)


def test_allocate_sweep_and_simulation_match_reference(managers):
    port, ref = managers
    got = port.allocate_sweep(_streams(SCENARIOS[3]), ALL_STRATEGIES)
    want = ref.allocate_sweep(_ref_streams(SCENARIOS[3]), REF_STRATEGIES)
    assert list(got) == list(want) == ["ST1", "ST2", "ST3"]
    assert got["ST1"] is None and want["ST1"] is None
    for name in ("ST2", "ST3"):
        _assert_same_plan(got[name], want[name])
        sim = simulate_plan(got[name], port.profiles)
        ref_sim = ref_simulate_plan(want[name], ref.profiles)
        assert sim["overall_performance"] == ref_sim["overall_performance"]
        assert sim["meets_target"] and ref_sim["meets_target"]
        assert sim["fragmentation"] == ref_sim["fragmentation"]
        assert [i.utilization for i in sim["instances"]] == [
            i.utilization for i in ref_sim["instances"]]


def test_profile_table_round_trips_through_plain():
    rows = profile_table_to_plain(ref_profile_table())
    assert profile_table_to_plain(paper_profile_table()) == rows
    assert profile_table_to_plain(profile_table_from_plain(rows)) == rows


def test_colgen_fleet_plan_identical_to_reference(monkeypatch):
    """30 cameras over 10 kinds: many classes, high multiplicity, so `auto`
    routes to branch-and-price and prices through `price_knapsacks`."""
    spec = _camera_spec(30)
    port = ResourceManager(paper_ec2_catalog(), profile_table_from_plain(
        profile_table_to_plain(ref_profile_table())), device="cpu")
    calls = []
    inner = knapsack.price_knapsacks

    def counting(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return inner(*args, **kwargs)

    monkeypatch.setattr(knapsack, "price_knapsacks", counting)
    plan = port.allocate(_streams(spec), ST3)
    ref_plan = RefManager(ref_ec2_catalog(), ref_profile_table()).allocate(
        _ref_streams(spec))
    assert calls and set(calls) == {torch.device("cpu")}
    plan.solution.validate()
    _assert_same_plan(plan, ref_plan)
    assert plan.hourly_cost == pytest.approx(1.30, abs=1e-9)


def test_unported_entry_points_raise(managers):
    """No entry point of the reference's manager is left unported:
    `sharded_controller` gives the sharded controller (one per strategy,
    apart from the flat ones; at one cell it plans as the flat controller
    does), `allocate` plans through the live controller, which `replan`
    folds events into."""
    port, _ref = managers
    streams = _streams(SCENARIOS[1])
    assert not hasattr(manager_module, "_NOT_PORTED")
    sharded = port.sharded_controller(ST3)
    assert isinstance(sharded, ShardedController)
    assert port.sharded_controller(ST3) is sharded
    assert sharded.reset(streams).plan.hourly_cost == pytest.approx(0.650)
    plan = port.allocate(streams, ST3)
    assert port.controller(ST3) is not sharded
    assert plan.hourly_cost == pytest.approx(0.650)
    assert port.controller(ST3).plan is plan
    assert port.replan([], ST3) == []
