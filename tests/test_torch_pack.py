"""The port's FFD/BFD fleet scan and placement scores against the reference.

`kernels.pack.pack_scan_plain` (the CUDA kernel's plain version, which the
CPU path runs) decoded into placements must equal the reference's numpy
packer `_pack_raw` bit for bit, FFD and BFD: random fleets, forced ties in
fit and in slack, padded choices and padding items, one bin type, one
item, and a fleet that opens more than 8 bins (the numpy path's growth).
`placement_scores` on the CPU and `placement_scores_plain` equal the
reference's `placement_scores_np`, the +inf cells included.  Both packages
get the same problems through `interop`'s plain form; floats compare with
``==``.
"""
import numpy as np
import pytest
import torch

from repro.core.binpack import heuristics as ref_h
from repro.core.binpack.problem import BinType as RefBinType
from repro.core.binpack.problem import Choice as RefChoice
from repro.core.binpack.problem import Item as RefItem
from repro.core.binpack.problem import Problem as RefProblem

from repro_torch.core.binpack import heuristics as h
from repro_torch.interop import problem_from_plain, problem_to_plain
from repro_torch.kernels import pack, placement

CATALOG = (
    ("c4.2xlarge", (8.0, 15.0, 0.0, 0.0), 0.419),
    ("c4.8xlarge", (36.0, 60.0, 0.0, 0.0), 1.675),
    ("g2.2xlarge", (8.0, 15.0, 1536.0, 4.0), 0.650),
)


def _ref_problem(items, catalog=CATALOG, cap=0.9):
    """A reference `Problem` from ``items``: (name, ((label, req), ...))."""
    return RefProblem(
        bin_types=tuple(RefBinType(n, c, cost) for n, c, cost in catalog),
        items=tuple(RefItem(n, tuple(RefChoice(lb, r) for lb, r in ch)) for n, ch in items),
        utilization_cap=cap,
    )


def _random_items(n, seed, k=4, cpu_only=False, gpu_only=False):
    """``n`` streams over ``k`` random kinds (the reference's golden fleets'
    generator): a CPU choice, an accelerator choice, or both."""
    rng = np.random.RandomState(seed)
    kinds = []
    for _ in range(k):
        cpu = rng.uniform(1.0, 5.0)
        kinds.append(((cpu, rng.uniform(0.2, 1.0), 0.0, 0.0),
                      (cpu * 0.13, rng.uniform(0.2, 1.0), rng.uniform(30, 300),
                       rng.uniform(0.1, 0.6))))
    items = []
    for i in range(n):
        c, g = kinds[i % k]
        if cpu_only:
            choices = (("cpu", c),)
        elif gpu_only:
            choices = (("accel", g),)
        elif rng.rand() < 0.3:  # one choice only: a padded choice row
            choices = (("cpu", c),) if rng.rand() < 0.5 else (("accel", g),)
        else:
            choices = (("cpu", c), ("accel", g))
        items.append((f"s{i}", choices))
    return items


def _port(ref_problem):
    return problem_from_plain(problem_to_plain(ref_problem))


def _assert_same(ref_problem, best_fit, got):
    placements, opened = ref_h._pack_raw(ref_problem, best_fit)
    got_placements, got_opened = got
    assert [tuple(int(x) for x in p) for p in got_placements] == [
        tuple(int(x) for x in p) for p in placements]
    assert [bt.name for bt in got_opened] == [bt.name for bt in opened]


FLEETS = {
    "random-a": lambda: _ref_problem(_random_items(10, 42, 3)),
    "random-b": lambda: _ref_problem(_random_items(25, 7, 5)),
    "random-c": lambda: _ref_problem(_random_items(60, 5, 6)),
    "gpu-only": lambda: _ref_problem(_random_items(9, 3, 3, gpu_only=True), CATALOG[2:]),
    "cpu-only": lambda: _ref_problem(_random_items(10, 11, 4, cpu_only=True), CATALOG[:2]),
    # Identical items over identical bins: every fit and every slack ties.
    "ties": lambda: _ref_problem(
        [(f"t{i}", (("a", (2.0, 2.0, 0.0, 0.0)), ("b", (2.0, 2.0, 0.0, 0.0))))
         for i in range(14)],
        (("x", (8.0, 8.0, 1.0, 1.0), 1.0), ("y", (8.0, 8.0, 1.0, 1.0), 1.0))),
    # Slack ties across dimensions and bins of one type, one choice each.
    "slack-ties": lambda: _ref_problem(
        [(f"u{i}", (("cpu", (1.0 + (i % 3), 3.0 - (i % 3), 0.0, 0.0)),))
         for i in range(12)],
        (("sq", (6.0, 6.0, 0.0, 0.0), 0.3),)),
    "one-type": lambda: _ref_problem(_random_items(12, 9, 3, cpu_only=True), CATALOG[:1]),
    "one-item": lambda: _ref_problem(_random_items(1, 1, 1)),
    # Each item fills most of a bin: 20 bins open, past the numpy path's 8.
    "many-bins": lambda: _ref_problem(
        [(f"m{i}", (("cpu", (6.5 + 0.01 * i, 1.0, 0.0, 0.0)),)) for i in range(20)],
        CATALOG[:1]),
}


@pytest.mark.parametrize("best_fit", [False, True], ids=["ffd", "bfd"])
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_plain_scan_decodes_to_the_numpy_packers_placements(fleet, best_fit):
    ref_problem = FLEETS[fleet]()
    got = h._batched_pack_raw([_port(ref_problem)], best_fit=best_fit, device="cpu")
    _assert_same(ref_problem, best_fit, got[0])
    if fleet == "many-bins":
        assert len(got[0][1]) == 20


@pytest.mark.parametrize("best_fit", [False, True], ids=["ffd", "bfd"])
def test_batched_fleets_with_padding_items_equal_per_fleet_packs(best_fit):
    """Fleets of 7 to 40 items (padding items in all but the largest) and
    of one or two choices (padded choices) in one batch."""
    refs = [_ref_problem(_random_items(n, seed, 4, cpu_only=(seed == 2)))
            for n, seed in ((7, 1), (40, 2), (23, 3), (31, 4))]
    ports = [_port(p) for p in refs]
    got = h._batched_pack_raw(ports, best_fit=best_fit, device="cpu")
    for ref_problem, g in zip(refs, got):
        _assert_same(ref_problem, best_fit, g)
    costs = h.batched_fleet_costs(ports, best_fit=best_fit, device="cpu")
    sols = h.batched_pack(ports, best_fit=best_fit, device="cpu")
    for ref_problem, cost, sol in zip(refs, costs, sols):
        want = ref_h._pack(ref_problem, best_fit)
        assert cost == want.cost == sol.cost  # summed in the same order
        assert [(a.item_index, a.choice_index, a.bin_index) for a in sol.assignments] == [
            (a.item_index, a.choice_index, a.bin_index) for a in want.assignments]


def test_scan_records_padding_items_as_minus_one():
    refs = [_ref_problem(_random_items(n, n, 3)) for n in (3, 8)]
    ts = [p.tensors() for p in (_port(r) for r in refs)]
    reqs, masks, scores, orders = h._pad_fleets([_port(r) for r in refs], ts)
    (b, c, t), n_open, total = pack.pack_scan(
        *(torch.from_numpy(a) for a in (reqs, masks, scores, orders, ts[0].caps, ts[0].costs)),
        best_fit=False)
    assert (b[0, 3:] == -1).all() and (c[0, 3:] == -1).all() and (t[0, 3:] == -1).all()
    assert (b[1] >= 0).all()
    assert n_open.tolist() == [int((t[i] >= 0).sum()) for i in range(2)]
    for i, r in enumerate(refs):
        assert float(total[i]) == ref_h._pack(r, False).cost


@pytest.mark.parametrize("best_fit", [False, True], ids=["ffd", "bfd"])
def test_device_packers_on_the_cpu_equal_the_reference(best_fit):
    ref_problem = FLEETS["random-b"]()
    sol = h.pack_device(_port(ref_problem), best_fit=best_fit, device="cpu")
    want = ref_h._pack(ref_problem, best_fit)
    assert [(a.item_index, a.choice_index, a.bin_index) for a in sol.assignments] == [
        (a.item_index, a.choice_index, a.bin_index) for a in want.assignments]
    named = (h.best_fit_decreasing_device if best_fit else h.first_fit_decreasing_device)
    assert named(_port(ref_problem), device="cpu").cost == want.cost


def test_mixed_catalog_raises():
    a = _port(_ref_problem(_random_items(5, 1, 2)))
    b = _port(_ref_problem(_random_items(5, 2, 2, cpu_only=True), CATALOG[:2]))
    for call in (h.batched_fleet_costs, h.batched_pack):
        with pytest.raises(ValueError, match="shared catalog"):
            call([a, b], device="cpu")
    assert h.batched_fleet_costs([], device="cpu").shape == (0,)
    assert h.batched_pack([], device="cpu") == []


def test_scan_wrapper_checks_its_inputs():
    p = _port(FLEETS["random-a"]())
    t = p.tensors()
    reqs, masks, scores, orders = h._pad_fleets([p], [t])
    args = [torch.from_numpy(a) for a in (reqs, masks, scores, orders, t.caps, t.costs)]
    before = pack.LAUNCHES
    with pytest.raises(TypeError, match="req must be torch.float64"):
        pack.pack_scan(args[0].float(), *args[1:], best_fit=False)
    with pytest.raises(ValueError, match="open_score must be"):
        pack.pack_scan(args[0], args[1], args[2][:, :, :1], *args[3:], best_fit=False)
    bad = args[3].clone()
    bad[0, 0] = reqs.shape[1]
    with pytest.raises(ValueError, match="order entries"):
        pack.pack_scan(*args[:3], bad, *args[4:], best_fit=False)
    pack.pack_scan(*args, best_fit=True)
    assert pack.LAUNCHES == before  # the CPU runs the plain version


def _scoring_inputs(seed, k, c, p, dim=4):
    rng = np.random.RandomState(seed)
    req = rng.uniform(0.1, 1.5, size=(k, c, dim))
    mask = rng.rand(k, c) < 0.8
    req[~mask] = np.inf  # padded choices are +inf rows
    resid = rng.uniform(0.0, 2.0, size=(p, dim))
    resid[0] = 0.0  # an exhausted bin: the 1e-300 floor
    req[0, 0] = resid[-1]  # an exact fit: slack 0 in every dimension
    mask[0, 0] = True
    return req, mask, resid


@pytest.mark.parametrize("k,c,p", [(1, 1, 2), (3, 2, 5), (17, 3, 40), (64, 2, 129)])
def test_placement_scores_equal_the_reference(k, c, p):
    req, mask, resid = _scoring_inputs(k * 100 + p, k, c, p)
    want = ref_h.placement_scores_np(req, mask, resid)
    assert np.isinf(want).any() and np.isfinite(want).any()
    got = h.placement_scores(req, mask, resid, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable
    plain = placement.placement_scores(
        torch.from_numpy(req), torch.from_numpy(mask), torch.from_numpy(resid))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(h.placement_scores_np(req, mask, resid), want)


def test_placement_scores_on_the_cpu_are_all_numpy(monkeypatch):
    """With ``device="cpu"`` every call is numpy, even above the card's
    threshold; the kernel wrapper is never reached."""
    monkeypatch.setattr(placement, "_dispatch", None)
    monkeypatch.setitem(h.PLACEMENT_ROUTES, "numpy", 0)
    monkeypatch.setitem(h.PLACEMENT_ROUTES, "kernel", 0)
    req, mask, resid = _scoring_inputs(5, 40, 2, 80)
    assert req.shape[0] * req.shape[1] * resid.shape[0] >= h._CUDA_MIN_CANDIDATES
    h.placement_scores(req, mask, resid, device="cpu")
    assert h.PLACEMENT_ROUTES == {"kernel": 0, "numpy": 1}


def test_placement_wrapper_checks_its_inputs():
    req, mask, resid = (torch.from_numpy(a) for a in _scoring_inputs(1, 3, 2, 4))
    with pytest.raises(TypeError, match="mask must be torch.bool"):
        placement.placement_scores(req, mask.double(), resid)
    with pytest.raises(ValueError, match="resid must be"):
        placement.placement_scores(req, mask, resid[:, :3])


def test_evacuation_scores_equal_the_reference():
    rng = np.random.RandomState(0)
    req = rng.uniform(0.1, 1.0, size=(5, 2, 3))
    mask = np.ones((5, 2), dtype=bool)
    mask[3, 1] = False
    resid = rng.uniform(0.5, 2.0, size=(4, 3))
    owner = np.array([0, 1, 2, 3, 0])
    got = h.evacuation_scores(req, mask, resid, owner)
    np.testing.assert_array_equal(got, ref_h.evacuation_scores(req, mask, resid, owner))
    for i in range(5):
        assert np.all(np.isinf(got[i, :, owner[i]]))
