"""The port's CUDA kernel on the card (``gpu`` marker; skips without one).

Imports only `repro_torch`, so it runs on a machine that has the card but
not the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The kernel does adds and compares only, so it must equal its plain torch
version exactly: ``best``, the take bits, and the counts and plans built
from them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.binpack import colgen
from repro_torch.core.binpack.arcflow import group_items
from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
from repro_torch.core.streams import AnalysisProgram, StreamSpec
from repro_torch.interop import plan_to_plain
from repro_torch.kernels import knapsack

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _random_pricing(rng, b_n, e_n, dim, dtype):
    values = rng.uniform(0.0, 1.0, size=(b_n, e_n)).astype(dtype)
    weights = rng.randint(0, 4, size=(b_n, e_n, dim)).astype(np.int64)
    weights[..., 0] = np.maximum(weights[..., 0], 1)
    bounds = rng.randint(0, 5, size=(b_n, e_n)).astype(np.int64)
    cap_levels = rng.randint(1, 7, size=(b_n, dim)).astype(np.int64)
    return values, weights, bounds, cap_levels


def _camera_fleet(n):
    vgg, zf = AnalysisProgram("VGG-16", "vgg16"), AnalysisProgram("ZF", "zf")
    kinds = [(vgg, f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
        (zf, f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)
    ]
    return [StreamSpec(f"cam{i}", *kinds[i % 10]) for i in range(n)]


def _assert_kernel_equals_plain(steps, device):
    before = knapsack.LAUNCHES
    best_k, take_k = knapsack.knapsack_dp(*steps.to(device))
    torch.cuda.synchronize()
    assert knapsack.LAUNCHES == before + 1
    best_p, take_p = knapsack.knapsack_dp_plain(*steps.to(device))
    torch.cuda.synchronize()
    assert torch.equal(take_k, take_p)
    assert torch.equal(best_k, best_p)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_equals_plain_seeded(cuda, seed, dtype):
    rng = np.random.RandomState(seed)
    args = _random_pricing(rng, int(rng.randint(1, 5)), int(rng.randint(1, 6)),
                           int(rng.randint(1, 4)), dtype)
    steps = knapsack.pricing_steps(*args)
    if steps.step_values.shape[1]:
        _assert_kernel_equals_plain(steps, cuda)
    got = knapsack.price_knapsacks(*args, device=cuda)
    ref = knapsack.price_knapsacks(*args, device="cpu")
    np.testing.assert_array_equal(got.best, ref.best)
    np.testing.assert_array_equal(got.counts, ref.counts)


@pytest.mark.parametrize("grid_states", [32_768, 131_072])
def test_kernel_equals_plain_on_fleet_grid(cuda, grid_states):
    """The 500-camera fleet's grid (30,940 states, more than a block's
    shared memory holds in float64) and a larger one."""
    problem = ResourceManager(
        paper_ec2_catalog(), paper_profile_table(), device=cuda
    ).formulate(_camera_fleet(500))
    class_reqs, _demands, _members = group_items(problem)
    grid = colgen._discretize(problem, class_reqs, grid_states)
    values = np.random.RandomState(1).uniform(
        0.0, 0.5, size=(grid.weights.shape[0], len(grid.entries)))
    steps = knapsack.pricing_steps(values, grid.weights, grid.fit, grid.cap_levels)
    assert steps.states >= 30_940
    _assert_kernel_equals_plain(steps, cuda)


def test_wrapper_raises_instead_of_falling_back(cuda):
    steps = knapsack.pricing_steps(
        *_random_pricing(np.random.RandomState(0), 3, 4, 2, np.float64))
    sv, sw, fi, levels = steps.to(cuda)
    assert min(sv.shape) > 1  # so that a transposed copy is not contiguous
    before = knapsack.LAUNCHES
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv.t().contiguous().t(), sw, fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, sw.cpu(), fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, -sw, fi, levels)
    assert knapsack.LAUNCHES == before


def test_colgen_fleet_plan_on_card_equals_cpu_plan(cuda):
    streams = _camera_fleet(30)
    before = knapsack.LAUNCHES
    card = ResourceManager(paper_ec2_catalog(), paper_profile_table()).allocate(
        streams)
    launched = knapsack.LAUNCHES - before
    cpu = ResourceManager(
        paper_ec2_catalog(), paper_profile_table(), device="cpu"
    ).allocate(streams)
    assert launched > 0 and knapsack.LAUNCHES == before + launched
    a, b = plan_to_plain(card), plan_to_plain(cpu)
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key
