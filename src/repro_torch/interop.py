"""State carried across packages as plain values.

This system has no model weights: its state is the catalog, the profile
table and the problem.  These helpers convert between the port's objects
and plain tuples and numpy arrays — names, capacities, costs, requirement
vectors, assignments — so that any producer of the same plain form (a
file, another implementation of the manager) can feed the port identical
inputs, and results can be compared value for value.

The ``*_to_plain`` functions read attributes only, so they accept any
object with the port's field names.
"""
from __future__ import annotations

import numpy as np

from .core.binpack.problem import BinType, Choice, Item, Problem
from .core.profiler import ProfileTable, ResourceProfile

__all__ = [
    "problem_to_plain",
    "problem_from_plain",
    "profile_table_to_plain",
    "profile_table_from_plain",
    "plan_to_plain",
]


def problem_to_plain(problem) -> dict:
    """``{"bin_types", "items", "utilization_cap"}`` of plain values.

    ``bin_types``: ``(name, capacity, cost, hazard, rent)`` per type;
    ``items``: ``(name, ((label, requirement), ...))`` per item.
    """
    return {
        "bin_types": tuple(
            (
                bt.name,
                tuple(float(c) for c in bt.capacity),
                float(bt.cost),
                float(bt.hazard),
                None if bt.rent is None else float(bt.rent),
            )
            for bt in problem.bin_types
        ),
        "items": tuple(
            (
                it.name,
                tuple(
                    (c.label, tuple(float(r) for r in c.requirement))
                    for c in it.choices
                ),
            )
            for it in problem.items
        ),
        "utilization_cap": float(problem.utilization_cap),
    }


def problem_from_plain(plain: dict) -> Problem:
    """The port's `Problem` from `problem_to_plain`'s form."""
    bins = tuple(
        BinType(name, tuple(cap), cost, hazard=hazard, rent=rent)
        for name, cap, cost, hazard, rent in plain["bin_types"]
    )
    items = tuple(
        Item(name, tuple(Choice(label, tuple(req)) for label, req in choices))
        for name, choices in plain["items"]
    )
    return Problem(
        bin_types=bins, items=items, utilization_cap=plain["utilization_cap"]
    )


def profile_table_to_plain(table) -> tuple:
    """``(program_id, frame_size, device, reference_fps, requirement,
    max_fps)`` per profile, in insertion order."""
    return tuple(
        (
            p.program_id,
            p.frame_size,
            p.device,
            float(p.reference_fps),
            tuple(float(r) for r in p.requirement),
            float(p.max_fps),
        )
        for p in table._profiles.values()
    )


def profile_table_from_plain(rows) -> ProfileTable:
    """The port's `ProfileTable` from `profile_table_to_plain`'s rows."""
    table = ProfileTable()
    for program_id, frame_size, device, ref_fps, req, max_fps in rows:
        table.add(
            ResourceProfile(
                program_id=program_id,
                frame_size=frame_size,
                device=device,
                reference_fps=ref_fps,
                requirement=tuple(req),
                max_fps=max_fps,
            )
        )
    return table


def plan_to_plain(plan) -> dict:
    """An `AllocationPlan` as plain values.

    ``placements``: ``(stream name, instance index, instance type, device)``;
    ``assignments``: ``(item, choice, bin)`` int64 array; ``loads``: the
    recorded per-instance load vectors.
    """
    sol = plan.solution
    return {
        "strategy": plan.strategy,
        "instances": tuple(plan.instances),
        "placements": tuple(
            (p.stream.name, int(p.instance_index), p.instance_type, p.device)
            for p in plan.placements
        ),
        "hourly_cost": float(plan.hourly_cost),
        "optimal": bool(plan.optimal),
        "assignments": np.asarray(
            [(a.item_index, a.choice_index, a.bin_index) for a in sol.assignments],
            dtype=np.int64,
        ).reshape(-1, 3),
        "loads": np.asarray(
            [b.load for b in sol.bins], dtype=np.float64
        ).reshape(len(sol.bins), -1),
    }
