"""The port's examples against the reference's, on the CPU.

`examples/torch_quickstart.py`, `examples/torch_allocation_demo.py` and
`examples/torch_serve_cameras.py` against the reference's pipelines on the
same inputs (the reference's own fleet builders, loaded from its example
files): the quickstart's $/h per strategy within 1e-9 and its 0.61
saving, the allocation demo's exact, arc-flow and FFD costs, and the
camera fleet's plan value for value.
"""
import pathlib
import runpy

import numpy as np
import pytest

from repro.core.binpack import BinType, first_fit_decreasing, solve, solve_arcflow
from repro.core.catalog import tpu_cloud_catalog
from repro.core.manager import ResourceManager
from repro.core.profiler import paper_profile_table
from repro.core.strategies import ALL_STRATEGIES
from repro.core.streams import AnalysisProgram, FrameSize, StreamSpec
from repro_torch.interop import plan_to_plain

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name: str) -> dict:
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name=name)


def test_quickstart_costs_equal_reference():
    got = _example("torch_quickstart")["main"](["--device", "cpu"])
    vgg, zf = AnalysisProgram("VGG-16", "vgg16"), AnalysisProgram("ZF", "zf")
    streams = [StreamSpec("cam-vgg", vgg, 0.25)] + [
        StreamSpec(f"cam-zf{i}", zf, 0.55) for i in range(3)]
    catalog = (BinType("c4.2xlarge", (8, 15, 0, 0), 0.419),
               BinType("g2.2xlarge", (8, 15, 1536, 4), 0.650))
    manager = ResourceManager(catalog, paper_profile_table())
    want = {s.name: manager.allocate(streams, s).hourly_cost for s in ALL_STRATEGIES}
    assert list(got["costs"]) == list(want)
    for name in want:
        assert got["costs"][name] == pytest.approx(want[name], abs=1e-9)
    assert round(got["savings"], 2) == 0.61


def test_allocation_demo_costs_equal_reference():
    got = _example("torch_allocation_demo")["main"](["--device", "cpu"])
    problem = _example("allocation_demo")["multi_gpu_fleet"]()
    want = {"exact": solve(problem)[0].cost, "arcflow": solve_arcflow(problem)[0].cost,
            "ffd": first_fit_decreasing(problem).cost}
    assert got == want


def test_serve_cameras_plan_equals_reference():
    got = _example("torch_serve_cameras")["main"](["--device", "cpu", "--requests", "1",
                                                    "--new-tokens", "2"])
    ref = _example("serve_cameras")
    streams = [
        StreamSpec("traffic-cam", AnalysisProgram("a", "internlm2-1.8b"), 25.0, FrameSize(0, 0)),
        StreamSpec("mall-cam", AnalysisProgram("b", "internlm2-1.8b"), 10.0, FrameSize(0, 0)),
        StreamSpec("river-cam", AnalysisProgram("c", "gemma2-2b"), 6.0, FrameSize(0, 0)),
    ]
    want = plan_to_plain(ResourceManager(tpu_cloud_catalog(), ref["build_profiles"]())
                         .allocate(streams))
    plan = plan_to_plain(got["plan"])
    assert list(plan) == list(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(plan[key], want[key])
        else:
            assert plan[key] == want[key], key
    # One request per stream, two tokens each.
    assert sum(n for n, _ in got["served"].values()) == len(streams)
    assert all(toks == 2 * n for n, toks in got["served"].values())
