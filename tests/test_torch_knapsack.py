"""Parity of the port's pricing DP with the JAX package's numpy reference.

`repro_torch.kernels.knapsack` runs its plain torch version on CPU
tensors; it must be bit-identical to `repro.kernels.knapsack`'s numpy
implementation (`impl="numpy"`, the live reference: the reference's jax and
pallas paths need `jax.experimental.enable_x64`), in ``best``, the
backtracked ``counts`` and the raw take bits (packed 32 states to a word
in the port, unpacked here).  The arithmetic is adds and compares only, so
every comparison here is exact.  The CUDA kernel's index math (packed
coordinates, slices of a cluster, reads across slices, the packed take
words and the backtrack over them) is emulated here in numpy
(`_cluster_emulated`) and held against the plain version; the kernel
itself is held against the plain version on the card in
tests/test_torch_gpu.py.
"""
import pathlib
import re
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

from repro_torch.device import KernelError
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
        np.testing.assert_array_equal(knapsack.unpack_take(take, steps.states).numpy(),
                                      ref_take)
        np.testing.assert_array_equal(take.numpy(),
                                      knapsack.pack_take(torch.from_numpy(ref_take)).numpy())
        np.testing.assert_array_equal(best.numpy(), ref_best)
        # The kernel's route to the counts: the mask of steps taken.
        taken = knapsack.taken_steps_plain(take, steps.shifts, steps.final_idx)
        np.testing.assert_array_equal(steps.counts_from_taken(taken, got.counts.shape[1]),
                                      ref.counts)
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


# ---- packed take bits and the mask of steps taken -------------------------------


@pytest.mark.parametrize("s_n", [1, 31, 32, 33, 100, 30_940])
def test_pack_take_round_trip(s_n):
    """Ragged S, a word's bit 31 (the int32 sign) and the last partial word."""
    rng = np.random.RandomState(s_n)
    take = torch.from_numpy(rng.rand(3, 2, s_n) < 0.5)
    take[..., -1] = True
    packed = knapsack.pack_take(take)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (3, 2, -(-s_n // 32))
    assert torch.equal(knapsack.unpack_take(packed, s_n), take)
    if s_n >= 32:  # state 31 is a word's sign bit
        assert torch.equal(packed[..., 0] < 0, take[..., 31])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(4))
def test_taken_mask_counts_equal_backtrack(seed, dtype):
    """The mask of steps taken gives `_backtrack`'s counts and the
    reference's, on the seeded sweep."""
    rng = np.random.RandomState(100 + seed)
    args = _random_pricing(rng, int(rng.randint(2, 6)), int(rng.randint(2, 7)),
                           int(rng.randint(1, 4)), dtype)
    steps = knapsack.pricing_steps(*args)
    if not steps.step_values.shape[1]:
        pytest.skip("no steps at this seed")  # pragma: no cover
    e_n = args[0].shape[1]
    _best, take = knapsack.knapsack_dp_plain(*steps.to("cpu"))
    taken = knapsack.taken_steps_plain(take, steps.shifts, steps.final_idx)
    want = steps.counts(knapsack.unpack_take(take, steps.states).numpy(), e_n)
    np.testing.assert_array_equal(steps.counts_from_taken(taken, e_n), want)
    ref = ref_knap.price_knapsacks(*args, impl="numpy")
    np.testing.assert_array_equal(steps.counts_from_taken(taken, e_n), ref.counts)


# ---- the CUDA kernel's index math, emulated ---------------------------------


def _cluster_emulated(sv, sw, fi, levels, c):
    """The ``cluster`` kernel's arithmetic in numpy: states in `_layout`'s
    slices of 2^k states over CTAs, each state's coordinates packed once
    (`_packing`), a step's fit test one subtraction, the shifted read from
    whichever slice owns the state, take packed a warp (32 states) to a
    word, and the backtrack over those words.  Returns (best, take words,
    mask of steps taken)."""
    sv, sw, fi = (np.asarray(t) for t in (sv, sw, fi))
    b_n, t_n = sv.shape
    s_n = int(np.prod(levels))
    n_ctas, log2 = knapsack._layout(s_n, c)
    p = 1 << log2
    assert p % 32 == 0 and (n_ctas - 1) * p < s_n <= n_ctas * p
    offsets, guards = knapsack._packing(levels)
    strides = knapsack.grid_strides(levels)
    lv = np.asarray(levels, dtype=np.int64)
    s = np.arange(n_ctas * p, dtype=np.int64)
    x = np.full(s.shape, guards, dtype=np.uint64)
    for d in range(len(levels)):
        digit = ((s.astype(np.uint32) // np.uint32(strides[d])) % np.uint32(lv[d]))
        x += digit.astype(np.uint64) << np.uint64(offsets[d])
    live = ((sw >= 0) & (sw < lv)).all(axis=-1)  # (B, T)
    need = (sw.astype(np.uint64) << np.asarray(offsets, dtype=np.uint64)).sum(
        axis=-1, dtype=np.uint64)
    shift = np.where(live, (sw * strides).sum(axis=-1), -1)
    words = -(-s_n // 32)
    val = np.zeros((b_n, n_ctas, p), dtype=sv.dtype)
    take = np.zeros((t_n, b_n, words), dtype=np.int32)
    g = np.uint64(guards)
    for t in range(t_n):
        new = val.copy()
        for b in range(b_n):
            st = shift[b, t]
            f = (s < s_n) & (st >= 0) & (((x - need[b, t]) & g) == g)
            src = np.where(f, s - st, 0)
            got = np.where(f, val[b, src >> log2, src & (p - 1)], 0).astype(sv.dtype)
            old = val[b].reshape(-1)
            cand = got + sv[b, t]
            tk = f & (cand > old)
            new[b] = np.where(tk, cand, old).reshape(n_ctas, p)
            bits = tk.reshape(-1, 32).astype(np.int64) << np.arange(32)
            take[t, b] = (bits.sum(axis=1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)[:words]
        val = new
    best = val[np.arange(b_n), fi >> log2, fi & (p - 1)]
    taken = np.zeros((b_n, t_n), dtype=bool)
    for b in range(b_n):
        cur = int(fi[b])
        for t in range(t_n - 1, -1, -1):
            bit = (int(take[t, b, cur >> 5]) >> (cur & 31)) & 1
            taken[b, t] = bool(bit)
            if bit:
                cur -= int(shift[b, t])
    return best, take, taken


def _assert_emulation_equals_plain(steps, c):
    sv, sw, fi, levels = steps.to("cpu")
    best_p, take_p = knapsack.knapsack_dp_plain(sv, sw, fi, levels)
    best_e, take_e, taken_e = _cluster_emulated(sv.numpy(), sw.numpy(), fi.numpy(), levels, c)
    np.testing.assert_array_equal(best_e, best_p.numpy())
    np.testing.assert_array_equal(take_e, take_p.numpy())
    np.testing.assert_array_equal(
        taken_e, knapsack.taken_steps_plain(take_p, steps.shifts, steps.final_idx))


@pytest.mark.parametrize("c", range(1, 17))
def test_cluster_emulation_equals_plain_on_fleet_grid(fleet_steps, c):
    """The 30,940-state fleet grid cut into C = 1..16 slices: reads cross
    slices, and the last slice is partial."""
    _assert_emulation_equals_plain(fleet_steps, c)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(4))
def test_cluster_emulation_equals_plain_seeded(seed, dtype):
    """Small grids with one-level dimensions and steps heavier than the
    grid (which fit nowhere), at C = 1, 3 and 16."""
    rng = np.random.RandomState(200 + seed)
    values, weights, bounds, caps = _random_pricing(rng, 3, 5, 3, dtype)
    caps[:, 1] = 0  # a dimension of one level
    weights[0, 0, 0] = 9  # heavier than any knapsack
    bounds[0, 0] = 2
    steps = knapsack.pricing_steps(values, weights, bounds, caps)
    for c in (1, 3, 16):
        _assert_emulation_equals_plain(steps, c)


@pytest.fixture(scope="module")
def fleet_steps():
    problem = _fleet_problem_ref(500)
    class_reqs, demands, _members = ref_group_items(problem)
    grid = ref_colgen._discretize(problem, class_reqs, 32_768)
    duals = np.random.RandomState(5).uniform(0.0, 0.5, size=len(class_reqs))
    values = np.repeat(duals[grid.entry_class][None, :], grid.weights.shape[0], axis=0)
    dem = np.asarray(demands, dtype=np.int64)[grid.entry_class]
    steps = knapsack.pricing_steps(values, grid.weights, np.minimum(grid.fit, dem[None, :]),
                                   grid.cap_levels)
    assert steps.states == 30_940
    return steps


@pytest.mark.parametrize("levels", [(28, 13, 17, 5), (1, 1, 7), (2,) * 30 + (1, 1),
                                    (3,) * 19 + (1,) * 13, (46_341, 46_340)])
def test_packing_fits_its_word_and_tests_fit(levels):
    """Every grid under 2^31 states packs into 64 bits, even with 32
    dimensions; on sampled states and weights the one-subtraction test
    equals the per-dimension compares."""
    offsets, guards = knapsack._packing(levels)
    assert guards < 1 << 64
    rng = np.random.RandomState(len(levels))
    lv = np.asarray(levels, dtype=np.int64)
    for _ in range(200):
        coord = rng.randint(0, lv)
        w = rng.randint(0, lv)
        x = guards + sum(int(c) << o for c, o in zip(coord, offsets))
        need = sum(int(v) << o for v, o in zip(w, offsets))
        assert (((x - need) & guards) == guards) == bool((coord >= w).all())


def test_what_only_the_kernel_refuses_is_a_kernel_error():
    """The kernel's refusals of input the plain DP takes — a grid of
    `_MAX_STATES` states or more, a non-contiguous tensor, coordinates past
    64 bits — raise `KernelError`, the type no pricing catch-all swallows,
    not ``ValueError``."""
    steps = knapsack.pricing_steps(*_random_pricing(np.random.RandomState(0), 3, 4, 2,
                                                    np.float64))
    sv, sw, fi, levels = steps.to("cpu")
    knapsack._refusals(sv, sw, fi, steps.states)  # the fleet's grid: taken
    with pytest.raises(KernelError, match="fewer than"):
        knapsack._refusals(sv, sw, fi, knapsack._MAX_STATES)
    with pytest.raises(KernelError, match="contiguous"):
        knapsack._refusals(sv.t().contiguous().t(), sw, fi, steps.states)
    with pytest.raises(KernelError, match="bits of packed coordinates"):
        knapsack._packing((1 << 40, 1 << 40))
    assert issubclass(KernelError, RuntimeError) and not issubclass(KernelError, ValueError)


@pytest.mark.parametrize("b_n,s_n,want", [
    (15, 30_940, ("cluster", 8, 12)),   # the main path's largest call: 120 CTAs
    (18, 30_940, ("cluster", 4, 13)),   # 4 CTAs a knapsack keep 72 in one wave
    (3, 30_940, ("cluster", 16, 11)),
    (18, 120_384, ("cluster", 15, 13)),  # the large grid: 16 slices' worth, 15 used
    (1, 50, ("cluster", 2, 5)),          # slices of 32 states
    (200, 40, ("cluster", 1, 6)),        # more knapsacks than SMs: one CTA each
    (4, 131_072, ("cluster", 16, 13)),
    (4, 131_073, ("global", 1, 0)),
    (2, 2**31 - 1, ("global", 1, 0)),
])
def test_variant_and_layout(b_n, s_n, want):
    variant = knapsack._variant(s_n)
    got = (variant, *(knapsack._layout(s_n, knapsack._cluster_size(b_n, s_n, 132))
                      if variant == "cluster" else (1, 0)))
    assert got == want


def test_kernel_limits_match_the_source():
    """`_MAX_SLICE` and `_MAX_CLUSTER` are the source's kMaxSlice and
    kMaxCluster (the C side refuses a layout beyond them)."""
    src = (pathlib.Path(knapsack.__file__).parent / "csrc" / "knapsack.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", src))
    assert int(consts["kMaxSlice"]) == knapsack._MAX_SLICE
    assert int(consts["kMaxCluster"]) == knapsack._MAX_CLUSTER
    assert int(consts["kMaxDims"]) == knapsack._MAX_DIMS
