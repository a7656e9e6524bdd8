"""Parity of the port's pricing DP with the JAX package's numpy reference.

`repro_torch.kernels.knapsack` runs its plain torch version on CPU
tensors; it must be bit-identical to `repro.kernels.knapsack`'s numpy
implementation (`impl="numpy"`, the live reference: the reference's jax and
pallas paths need `jax.experimental.enable_x64`), in ``best``, the
backtracked ``counts`` and the raw take bits.  The arithmetic is adds and
compares only, so every comparison here is exact.  The CUDA kernel is
held against the plain version on the card in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from repro.core.binpack.arcflow import group_items as ref_group_items
from repro.core.binpack import colgen as ref_colgen
from repro.core.catalog import paper_ec2_catalog as ref_catalog
from repro.core.manager import ResourceManager as RefManager
from repro.core.profiler import paper_profile_table as ref_table
from repro.core.streams import AnalysisProgram, StreamSpec
from repro.kernels import knapsack as ref_knap

from repro_torch.kernels import knapsack


def _random_pricing(rng, b_n, e_n, dim, dtype):
    """Same generator as tests/test_colgen.py's kernel sweep."""
    values = rng.uniform(0.0, 1.0, size=(b_n, e_n)).astype(dtype)
    weights = rng.randint(0, 4, size=(b_n, e_n, dim)).astype(np.int64)
    weights[..., 0] = np.maximum(weights[..., 0], 1)
    bounds = rng.randint(0, 5, size=(b_n, e_n)).astype(np.int64)
    cap_levels = rng.randint(1, 7, size=(b_n, dim)).astype(np.int64)
    return values, weights, bounds, cap_levels


def _ref_take(values, weights, bounds, cap_levels):
    """The reference's raw (best, take) from its numpy DP."""
    weights = np.asarray(weights, dtype=np.int64)
    fits_once = (weights <= cap_levels[:, None, :]).all(axis=-1)
    bounds = np.where(fits_once, bounds, 0)
    sv, sw, _entry, _mult = ref_knap.build_pricing_steps(values, weights, bounds)
    _levels, strides, coord = ref_knap._grid(cap_levels)
    final_idx = (cap_levels * strides[None, :]).sum(axis=1)
    best, take, _shifts = ref_knap._dp_numpy(sv, sw, coord, strides, final_idx)
    return best, take


def _assert_parity(values, weights, bounds, cap_levels):
    ref = ref_knap.price_knapsacks(values, weights, bounds, cap_levels,
                                   impl="numpy")
    got = knapsack.price_knapsacks(values, weights, bounds, cap_levels,
                                   device="cpu")
    assert got.best.dtype == ref.best.dtype
    np.testing.assert_array_equal(got.best, ref.best)
    np.testing.assert_array_equal(got.counts, ref.counts)
    assert (got.states, got.steps) == (ref.states, ref.steps)
    steps = knapsack.pricing_steps(values, weights, bounds, cap_levels)
    if steps.step_values.shape[1]:
        best, take = knapsack.knapsack_dp_plain(*steps.to("cpu"))
        ref_best, ref_take = _ref_take(values, weights, bounds, cap_levels)
        np.testing.assert_array_equal(take.numpy(), ref_take)
        np.testing.assert_array_equal(best.numpy(), ref_best)
    return got


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(6))
def test_plain_bit_identical_to_numpy_seeded(seed, dtype):
    rng = np.random.RandomState(seed)
    b_n = int(rng.randint(1, 5))
    e_n = int(rng.randint(1, 6))
    dim = int(rng.randint(1, 4))
    _assert_parity(*_random_pricing(rng, b_n, e_n, dim, dtype))


def test_plain_degenerate_shapes():
    # Empty batch / empty entries short-circuit identically.
    for b_n, e_n in ((0, 3), (2, 0)):
        args = (
            np.zeros((b_n, e_n)), np.zeros((b_n, e_n, 2), dtype=np.int64),
            np.zeros((b_n, e_n), dtype=np.int64), np.ones((b_n, 2), dtype=np.int64),
        )
        r = knapsack.price_knapsacks(*args, device="cpu")
        ref = ref_knap.price_knapsacks(*args, impl="numpy")
        assert r.best.shape == (b_n,) and r.counts.shape == (b_n, e_n)
        assert (r.states, r.steps) == (ref.states, ref.steps)
    # All-zero bounds: nothing packs anywhere (no DP steps at all).
    r = _assert_parity(
        np.ones((2, 3)), np.ones((2, 3, 2), dtype=np.int64),
        np.zeros((2, 3), dtype=np.int64), np.full((2, 2), 5, dtype=np.int64),
    )
    assert (r.best == 0).all() and (r.counts == 0).all()
    # Entries too heavy for their knapsack are dropped, others still pack.
    weights = np.asarray([[[9, 1], [1, 1]]], dtype=np.int64)
    r = _assert_parity(
        np.asarray([[5.0, 1.0]]), weights, np.asarray([[3, 3]]),
        np.asarray([[4, 4]]),
    )
    assert r.counts.tolist() == [[0, 3]]


def _fleet_problem_ref(n):
    vgg, zf = AnalysisProgram("VGG-16", "vgg16"), AnalysisProgram("ZF", "zf")
    kinds = [(vgg, f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
        (zf, f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)
    ]
    streams = [StreamSpec(f"cam{i}", *kinds[i % 10]) for i in range(n)]
    return RefManager(ref_catalog(), ref_table()).formulate(streams)


def test_plain_bit_identical_on_fleet_grid():
    """A few rows of the 10-kind camera fleet's real 30,940-state grid."""
    problem = _fleet_problem_ref(500)
    class_reqs, demands, _members = ref_group_items(problem)
    grid = ref_colgen._discretize(problem, class_reqs, 32_768)
    rng = np.random.RandomState(0)
    duals = rng.uniform(0.0, 0.5, size=len(class_reqs))
    n_kinds = grid.weights.shape[0]
    values = np.repeat(duals[grid.entry_class][None, :], n_kinds, axis=0)
    dem = np.asarray(demands, dtype=np.int64)[grid.entry_class]
    bounds = np.minimum(grid.fit, dem[None, :])
    r = _assert_parity(values, grid.weights, bounds, grid.cap_levels)
    assert r.states == 30_940
    assert r.counts.any()


def test_cpu_tensors_never_launch():
    before = knapsack.LAUNCHES
    rng = np.random.RandomState(3)
    knapsack.price_knapsacks(*_random_pricing(rng, 2, 3, 2, np.float64),
                             device="cpu")
    assert knapsack.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    steps = knapsack.pricing_steps(
        *_random_pricing(np.random.RandomState(1), 2, 3, 2, np.float64)
    )
    sv, sw, fi, levels = steps.to("cpu")
    with pytest.raises(TypeError):
        knapsack.knapsack_dp(sv.half(), sw, fi, levels)
    with pytest.raises(TypeError):
        knapsack.knapsack_dp(sv, sw.int(), fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, sw[:, :1], fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, sw, fi, levels + (1,))
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv[:0], sw[:0], fi[:0], levels)
    # Values the kernel's reads depend on: no negative weight, and the
    # capacity state inside the grid.
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, -sw, fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, sw, fi + int(np.prod(levels)), levels)
    # A device that is neither the CPU nor the card raises; nothing falls
    # back to the plain version.
    meta = [t.to("meta") for t in (sv, sw, fi)]
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(*meta, levels)
    with pytest.raises(ValueError):
        knapsack.price_knapsacks(
            np.ones((1, 1)), -np.ones((1, 1, 1), dtype=np.int64),
            np.ones((1, 1), dtype=np.int64), np.ones((1, 1), dtype=np.int64),
            device="cpu",
        )


def test_default_device_is_the_card():
    args = _random_pricing(np.random.RandomState(2), 1, 2, 2, np.float64)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        knapsack.price_knapsacks(*args)
