"""Multiple-choice FFD / BFD heuristics for MC-VBP (vectorized).

Used (a) as the incumbent/upper bound for the exact branch-and-bound, and
(b) as the production path for very large fleets (hundreds of streams)
where exactness is not worth the latency.

The classic first-fit-decreasing is generalized to multiple choices and
heterogeneous costed bins:

* items are sorted by decreasing *minimum normalized size* (the smallest,
  over choices, of the max utilization fraction the choice occupies in the
  cheapest bin that fits it),
* each item tries its choices against every open bin (first-fit or
  best-fit), preferring placements that need no new bin,
* when a new bin must be opened we pick the bin type minimizing
  cost-per-packed-fraction for this item (a cost-density greedy).

All per-item work runs on the shared `ProblemTensors` cache: the sort keys
and the new-bin scores are one batched computation each, and the fit test
against open bins is a single `(bins, choices, dim)` broadcast per item
instead of a Python loop over bins and choices.

## The device pass

`pack_device` and the batched `batched_fleet_costs` / `batched_pack` run
the same pass over many fleets at once through `kernels.pack.pack_scan`
(the CUDA kernel on the card, its plain torch version on the CPU): one
launch packs every what-if fleet of an autoscaling lookahead, each fleet
padded to a common (n, C) by `_pad_fleets`.  All arithmetic is float64
with the first-occurrence argmin / argmax rule, so the placements are the
numpy path's bit for bit; the numpy path stays the reference and the
default for single fleets.  `placement_scores` scores a single (items x
open bins) candidate matrix for the controller's greedy repair through
`kernels.placement` on the card from `_CUDA_MIN_CANDIDATES` candidates up,
and in numpy below that; `evacuation_scores` stays numpy (its shape churns
every event).  Each of these runs on ``device`` (default: the card, see
`resolve_device`).
"""
from __future__ import annotations

import threading

import numpy as np

from ...device import resolve_device
from ...kernels import pack as _pack_kernel
from ...kernels import placement as _placement_kernel

from .problem import (
    BinType,
    InfeasibleError,
    Problem,
    ProblemTensors,
    Solution,
    build_solution,
)

__all__ = [
    "first_fit_decreasing",
    "best_fit_decreasing",
    "first_fit_decreasing_device",
    "best_fit_decreasing_device",
    "pack_device",
    "batched_fleet_costs",
    "batched_pack",
    "open_cost_score",
    "placement_scores",
    "placement_scores_np",
    "evacuation_scores",
    "PLACEMENT_ROUTES",
]

_FIT_EPS = 1e-9  # absolute slack on capacity comparisons
#: Candidate-matrix size (k * C * P) from which `placement_scores` on the
#: card launches the kernel; below it numpy scores the matrix on the host.
#: The crossover measured on an H100 (80GB HBM3, 700 W) by
#: ``scripts/torch_placement_crossover.py``: from 1,280 candidates up the
#: copies to the card, the launch and the copy back (some 0.1-0.2 ms) cost
#: less than the numpy broadcast at every measured shape.
_CUDA_MIN_CANDIDATES = 1280
#: `placement_scores` calls by route in this process: ``"kernel"`` (the
#: CUDA kernel) and ``"numpy"`` (on the host, by the size rule or on the CPU).
PLACEMENT_ROUTES = {"kernel": 0, "numpy": 0}
_ROUTES_LOCK = threading.Lock()
_FRAC_EPS = 1e-12  # relative slack on utilization fractions


def _check_feasible(problem: Problem, t: ProblemTensors) -> None:
    infeasible = np.where(~np.isfinite(t.cheapest_host))[0]
    if infeasible.size:
        item = problem.items[int(infeasible[0])]
        raise InfeasibleError(
            f"item {item.name}: no (choice, bin type) fits even when alone"
        )


def _pack_inputs(t: ProblemTensors) -> tuple[np.ndarray, np.ndarray]:
    """(order, open_score): the packing pass's precomputed inputs.

    `order` is decreasing minimum normalized size (stable, matching the
    original sorted(..., key=...) behaviour).  `open_score` scores opening
    a new bin per (item, bin type, choice): cheap bins the item nearly
    fills win over expensive bins it barely dents; +inf marks misfits.
    """
    order = np.argsort(-t.min_frac(_FRAC_EPS), kind="stable")
    frac_tb = np.swapaxes(t.frac, 1, 2)  # (n, n_bt, max_choices)
    fits_new = (frac_tb <= 1.0 + _FRAC_EPS) & t.choice_mask[:, None, :]
    open_score = np.where(
        fits_new, open_cost_score(t.costs[None, :, None], frac_tb), np.inf
    )
    return order, open_score


def open_cost_score(costs, frac):
    """The open-bin cost-density rule: cheap bins the item nearly fills
    win over expensive bins it barely dents.  Shared by the FFD/BFD
    packers, the controller's greedy repair, and the acting autoscaler's
    spare typing (`FleetController.open_host_bin`) — one implementation,
    so the spares held always match what re-plans actually open."""
    return costs - 0.5 * costs * np.minimum(frac, 1.0)


def _pack(problem: Problem, best_fit: bool) -> Solution:
    placements, opened = _pack_raw(problem, best_fit)
    return build_solution(problem, placements, opened)


def _pack_raw(problem: Problem, best_fit: bool):
    """The FFD/BFD decision pass alone: (placements, opened) triples,
    without materializing (and validating) a `Solution`."""
    t = problem.tensors()
    n = len(problem.items)
    dim = problem.dim
    _check_feasible(problem, t)
    order, open_score = _pack_inputs(t)

    opened: list[BinType] = []
    # Growable dense state for the open bins.
    cap_bins = 8
    loads = np.zeros((cap_bins, dim))
    caps_open = np.zeros((cap_bins, dim))
    n_open = 0
    placements: list[tuple[int, int, int]] = []

    for item_i in order.tolist():
        reqs = t.req[item_i]  # (max_choices, dim); padded rows are +inf
        placed = False
        if n_open:
            new_loads = loads[:n_open, None, :] + reqs[None, :, :]
            fit = (
                np.all(new_loads <= caps_open[:n_open, None, :] + _FIT_EPS, axis=-1)
                & t.choice_mask[item_i][None, :]
            )  # (bins, choices); padded choices never fit
            if not best_fit:
                flat = fit.ravel()
                pos = int(flat.argmax())
                if flat[pos]:
                    bin_i, choice_i = divmod(pos, fit.shape[1])
                    placed = True
            else:
                # best-fit: minimize residual slack; argmin's first-minimum
                # rule reproduces the bin-major, choice-minor tie-break.
                slack = (
                    (caps_open[:n_open, None, :] - new_loads)
                    / np.maximum(caps_open[:n_open, None, :], 1e-300)
                ).max(axis=-1)
                score = np.where(fit, slack, np.inf)
                pos = int(score.argmin())
                if np.isfinite(score.ravel()[pos]):
                    bin_i, choice_i = divmod(pos, fit.shape[1])
                    placed = True
        if placed:
            loads[bin_i] += reqs[choice_i]
            placements.append((item_i, choice_i, bin_i))
            continue

        # Open a new bin: precomputed (bin type, choice) score, first minimum
        # wins (bin-type-major order, matching the old nested loops).
        scores = open_score[item_i]
        pos = int(scores.argmin())
        assert np.isfinite(scores.ravel()[pos])  # cheapest_host guaranteed a fit
        bt_i, choice_i = divmod(pos, scores.shape[1])
        if n_open == cap_bins:
            cap_bins *= 2
            loads = np.vstack([loads, np.zeros_like(loads)])
            caps_open = np.vstack([caps_open, np.zeros_like(caps_open)])
        opened.append(problem.bin_types[bt_i])
        loads[n_open] = reqs[choice_i]
        caps_open[n_open] = t.caps[bt_i]
        placements.append((item_i, choice_i, n_open))
        n_open += 1

    return placements, opened


def first_fit_decreasing(problem: Problem) -> Solution:
    return _pack(problem, best_fit=False)


def best_fit_decreasing(problem: Problem) -> Solution:
    return _pack(problem, best_fit=True)


# --------------------------------------------------------------------------
# The device pass: the same scan as `_pack`, over many fleets at once.
# --------------------------------------------------------------------------


def pack_device(
    problem: Problem, *, best_fit: bool = False, device=None
) -> Solution:
    """FFD/BFD via the device scan; placements match `_pack` exactly."""
    return batched_pack([problem], best_fit=best_fit, device=device)[0]


def first_fit_decreasing_device(problem: Problem, *, device=None) -> Solution:
    return pack_device(problem, best_fit=False, device=device)


def best_fit_decreasing_device(problem: Problem, *, device=None) -> Solution:
    return pack_device(problem, best_fit=True, device=device)


def batched_fleet_costs(
    problems: "list[Problem]", *, best_fit: bool = False, device=None
) -> np.ndarray:
    """Heuristic packing cost of many what-if fleets in one launch.

    All fleets must share the same bin types (a mixed catalog raises
    ``ValueError``); fleets and choice axes are padded to common (n, C)
    with all-False choice masks (the scan skips padding items).  Runs on
    ``device`` (default: the card).
    """
    device = resolve_device(device)
    if not problems:
        return np.zeros(0)
    ts = [p.tensors() for p in problems]
    reqs, masks, scores, orders = _pad_fleets(problems, ts)
    _recs, _n_open, costs = _pack_kernel.pack_scan_host(
        reqs, masks, scores, orders, ts[0].caps, ts[0].costs,
        best_fit=best_fit, device=device,
    )
    return costs


def _pad_fleets(problems, ts):
    """Pad many fleets' tensors to common (n, C) for the batched scan.

    The shared padding contract of `batched_fleet_costs` and
    `batched_pack`: +inf-padded requirements, all-False choice-mask rows
    for padding items (the scan skips them), per-fleet FFD orders with
    identity tails, and a shared catalog (validated).
    """
    for p, t in zip(problems, ts):
        _check_feasible(p, t)
        if not (
            np.array_equal(t.caps, ts[0].caps)
            and np.array_equal(t.costs, ts[0].costs)
        ):
            raise ValueError("batched packing requires a shared catalog")
    n_max = max(t.req.shape[0] for t in ts)
    c_max = max(t.req.shape[1] for t in ts)
    n_bt, dim = ts[0].caps.shape[0], ts[0].caps.shape[1]
    reqs = np.full((len(ts), n_max, c_max, dim), np.inf)
    masks = np.zeros((len(ts), n_max, c_max), dtype=bool)
    scores = np.full((len(ts), n_max, n_bt, c_max), np.inf)
    orders = np.zeros((len(ts), n_max), dtype=np.int64)
    for b, t in enumerate(ts):
        n, c = t.req.shape[0], t.req.shape[1]
        order, open_score = _pack_inputs(t)
        reqs[b, :n, :c] = t.req
        masks[b, :n, :c] = t.choice_mask
        scores[b, :n, :, :c] = open_score
        # Padding items processed last, as no-ops (all-False mask).
        orders[b, :n] = order
        orders[b, n:] = np.arange(n, n_max)
    return reqs, masks, scores, orders


def batched_pack(
    problems: "list[Problem]", *, best_fit: bool = False, device=None
) -> "list[Solution]":
    """Full FFD/BFD packings of many fleets in ONE launch.

    Where `batched_fleet_costs` only keeps the scalar cost, this decodes
    the scan's per-step records into a validated `Solution` per fleet —
    placements are bit-equivalent to running the numpy `_pack` on each
    fleet separately.  Same padding contract as `batched_fleet_costs`
    (shared catalog asserted).  Runs on ``device`` (default: the card).
    """
    return [
        build_solution(p, placements, opened)
        for p, (placements, opened) in zip(
            problems, _batched_pack_raw(problems, best_fit=best_fit, device=device)
        )
    ]


def _batched_pack_raw(
    problems: "list[Problem]", *, best_fit: bool = False, device=None
):
    """The batched decision pass alone: per-fleet (placements, opened),
    decoded from one `pack_scan` launch — `Solution` materialization left
    to the caller."""
    device = resolve_device(device)
    if not problems:
        return []
    ts = [p.tensors() for p in problems]
    reqs, masks, scores, orders = _pad_fleets(problems, ts)
    (bin_rec, choice_rec, bt_rec), n_open, _costs = _pack_kernel.pack_scan_host(
        reqs, masks, scores, orders, ts[0].caps, ts[0].costs,
        best_fit=best_fit, device=device,
    )
    out = []
    for b, p in enumerate(problems):
        placed = bin_rec[b] >= 0  # padding items: skipped by the scan
        triples = np.stack(
            [orders[b][placed], choice_rec[b][placed], bin_rec[b][placed]],
            axis=1,
        )
        placements = [tuple(row) for row in triples.tolist()]
        opened: "list[BinType | None]" = [None] * int(n_open[b])
        opener = placed & (bt_rec[b] >= 0)
        for bin_i, bt_i in zip(
            bin_rec[b][opener].tolist(), bt_rec[b][opener].tolist()
        ):
            opened[bin_i] = p.bin_types[bt_i]
        assert all(bt is not None for bt in opened)
        out.append((placements, opened))
    return out


def _count_route(route: str) -> None:
    with _ROUTES_LOCK:
        PLACEMENT_ROUTES[route] += 1


def placement_scores(
    req: np.ndarray, choice_mask: np.ndarray, resid: np.ndarray, *, device=None
) -> np.ndarray:
    """Best-fit slack score for every (item, choice, open bin) candidate.

    `req` is (k, C, dim) (+inf padded), `resid` is (P, dim) residual
    effective capacity.  Returns (k, C, P): the tightest-fit score (the
    BFD rule's residual slack, lower is tighter), +inf where the candidate
    does not fit.  One pass — the controller scores every repair candidate
    for every displaced stream at once — as a writable numpy array, since
    callers update columns in place between placements.

    On the card, matrices of `_CUDA_MIN_CANDIDATES` candidates or more go
    to the CUDA kernel (`kernels.placement`); smaller ones to the numpy
    scorer (identical arithmetic), where the copies and the launch would
    cost more than the broadcast.  With ``device="cpu"`` every call is
    numpy.  `PLACEMENT_ROUTES` counts the calls by route.
    """
    device = resolve_device(device)
    n_candidates = req.shape[0] * req.shape[1] * resid.shape[0]
    if device.type == "cuda" and n_candidates >= _CUDA_MIN_CANDIDATES:
        out = _placement_kernel.placement_scores_host(req, choice_mask, resid, device=device)
        _count_route("kernel")
        return out
    _count_route("numpy")
    return placement_scores_np(req, choice_mask, resid)


def evacuation_scores(
    req: np.ndarray,
    choice_mask: np.ndarray,
    resid: np.ndarray,
    owner: np.ndarray,
) -> np.ndarray:
    """Relocation score for every (placed item, choice, other bin) candidate.

    The consolidation policy's scoring pass: `req` is the `(k, C, dim)`
    requirement tensor of *placed* streams, `resid` the `(P, dim)` residual
    effective capacity of every open bin, and `owner[i]` the bin currently
    hosting item ``i``.  Returns `(k, C, P)` best-fit slack scores exactly
    like `placement_scores`, except an item's own bin is masked to ``+inf``
    — a stream "relocates" only into *other* bins' residuals, so
    ``isfinite(scores[i]).any()`` means item ``i`` can evacuate its bin.

    One numpy broadcast covers the whole fleet, deliberately on the host:
    the candidate matrix's (items, bins) shape churns every event, and the
    broadcast at fleet scale costs under a millisecond.
    """
    owner = np.asarray(owner, dtype=np.int64)
    scores = placement_scores_np(req, choice_mask, resid)
    same = np.arange(resid.shape[0])[None, None, :] == owner[:, None, None]
    return np.where(same, np.inf, scores)


def placement_scores_np(
    req: np.ndarray, choice_mask: np.ndarray, resid: np.ndarray
) -> np.ndarray:
    """Numpy `placement_scores` (identical arithmetic).

    The host route of `placement_scores`, and the scorer for cheap
    incremental updates — a caller that scored the full candidate matrix
    once can rescore a single bin's column here without another launch.
    """
    r = np.asarray(req)[:, :, None, :]
    rb = np.asarray(resid)[None, None, :, :]
    with np.errstate(invalid="ignore"):
        fit = np.all(r <= rb + _FIT_EPS, axis=-1) & np.asarray(choice_mask)[
            :, :, None
        ]
        slack = ((rb - r) / np.maximum(rb, 1e-300)).max(axis=-1)
    return np.where(fit, slack, np.inf)
