"""Exhaustive MC-VBP oracle for property tests (tiny instances only)."""
from __future__ import annotations

import itertools

import numpy as np

from .problem import InfeasibleError, Problem, Solution, build_solution

__all__ = ["solve_bruteforce"]


def _set_partitions(items: list[int]):
    """Yield all set partitions of `items` (Bell-number many)."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for partition in _set_partitions(rest):
        # Put first into each existing block.
        for i in range(len(partition)):
            yield partition[:i] + [[first] + partition[i]] + partition[i + 1 :]
        # Or its own block.
        yield [[first]] + partition


def solve_bruteforce(problem: Problem) -> Solution:
    n = len(problem.items)
    if n > 7:
        raise ValueError("bruteforce oracle limited to <=7 items")
    reqs = problem.choice_matrix()
    caps = [problem.effective_capacity(bt) for bt in problem.bin_types]

    best_cost = np.inf
    best = None
    for partition in _set_partitions(list(range(n))):
        # Cheapest feasible bin type per block, minimizing over per-item choices.
        total = 0.0
        config = []
        ok = True
        for block in partition:
            best_block = None  # (cost, bt_index, choices)
            n_choices = [len(reqs[i]) for i in block]
            for choice_combo in itertools.product(*[range(c) for c in n_choices]):
                load = np.sum(
                    [reqs[i][c] for i, c in zip(block, choice_combo)], axis=0
                )
                for bt_i, cap in enumerate(caps):
                    if np.all(load <= cap + 1e-9):
                        cost = problem.bin_types[bt_i].cost
                        if best_block is None or cost < best_block[0]:
                            best_block = (cost, bt_i, choice_combo)
            if best_block is None:
                ok = False
                break
            total += best_block[0]
            config.append((block, best_block[1], best_block[2]))
            if total >= best_cost:
                ok = False
                break
        if ok and total < best_cost:
            best_cost = total
            best = config
    if best is None:
        raise InfeasibleError("no feasible packing exists")

    opened = [problem.bin_types[bt_i] for _, bt_i, _ in best]
    placements = []
    for bin_i, (block, _, choices) in enumerate(best):
        for item_i, choice_i in zip(block, choices):
            placements.append((item_i, choice_i, bin_i))
    return build_solution(problem, placements, opened)
