"""Multiple-choice FFD / BFD heuristics for MC-VBP (vectorized numpy).

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

The batched device pass over many fleets (the reference's `_pack_core`
family) is not part of this module yet.
"""
from __future__ import annotations

import numpy as np

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
    "open_cost_score",
    "placement_scores_np",
]

_FIT_EPS = 1e-9  # absolute slack on capacity comparisons
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


def placement_scores_np(
    req: np.ndarray, choice_mask: np.ndarray, resid: np.ndarray
) -> np.ndarray:
    """Best-fit slack score for every (item, choice, open bin) candidate.

    `req` is (k, C, dim) (+inf padded), `resid` is (P, dim) residual
    effective capacity.  Returns (k, C, P): the tightest-fit score (the
    BFD rule's residual slack, lower is tighter), +inf where the candidate
    does not fit.
    """
    r = np.asarray(req)[:, :, None, :]
    rb = np.asarray(resid)[None, None, :, :]
    with np.errstate(invalid="ignore"):
        fit = np.all(r <= rb + _FIT_EPS, axis=-1) & np.asarray(choice_mask)[
            :, :, None
        ]
        slack = ((rb - r) / np.maximum(rb, 1e-300)).max(axis=-1)
    return np.where(fit, slack, np.inf)
