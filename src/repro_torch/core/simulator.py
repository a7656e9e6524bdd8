"""Fleet execution simulator (validates the 90%-utilization rule, Fig 5/6).

Models the paper's observed behaviour: analysis performance (actual/desired
frame rate, averaged over streams) stays at 100% while every resource on an
instance is under-utilized, and degrades proportionally once a compute
resource saturates — the streams on that instance share the saturated
resource fairly, so each achieves ``cap/load`` of its desired rate.

The reference's churn replay (`simulate_churn`) waits for the live-loop
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .binpack.problem import BinType
from .manager import AllocationPlan
from .profiler import DIM_ACC, DIM_CPU, ProfileTable

__all__ = [
    "InstanceLoad",
    "simulate_plan",
    "simulate_instance",
    "fleet_fragmentation",
]

_COMPUTE_DIMS = (DIM_CPU, DIM_ACC)


@dataclasses.dataclass(frozen=True)
class InstanceLoad:
    instance_type: str
    utilization: tuple[float, ...]  # per dim, fraction of raw capacity
    performance: float  # avg actual/desired frame rate of its streams
    residual: tuple[float, ...] = ()  # per dim, unused raw capacity


def simulate_instance(
    bin_type: BinType, requirement_vectors: Sequence[np.ndarray]
) -> InstanceLoad:
    cap = np.asarray(bin_type.capacity, dtype=np.float64)
    load = np.sum(requirement_vectors, axis=0) if requirement_vectors else np.zeros_like(cap)
    with np.errstate(divide="ignore", invalid="ignore"):
        util = np.where(cap > 0, load / np.maximum(cap, 1e-300), 0.0)
    # Saturated compute resources are shared fairly: every stream on this
    # instance runs at cap/load of its desired rate for the worst compute dim.
    slowdown = 1.0
    for d in _COMPUTE_DIMS:
        if util[d] > 1.0:
            slowdown = min(slowdown, 1.0 / util[d])
    return InstanceLoad(
        instance_type=bin_type.name,
        utilization=tuple(util.tolist()),
        performance=slowdown,
        residual=tuple(np.maximum(cap - load, 0.0).tolist()),
    )


def fleet_fragmentation(instances: Sequence[InstanceLoad]) -> dict:
    """Per-dim residual-capacity dispersion of a fleet (0 = consolidated).

    For each resource dimension with total residual ``R_d > 0`` across the
    open instances, dispersion is ``1 - max_i(resid[i, d]) / R_d``: zero
    when all free capacity sits in one instance (a future stream can use
    it whole), approaching ``1 - 1/N`` when it is shredded evenly across
    ``N`` instances (plenty of paid-for capacity, none of it usable by a
    large stream).  ``overall`` averages the dims that have residual at
    all.  This is the drift signal pure-pinning controllers accumulate and
    consolidation policies are judged by.
    """
    if not instances:
        return {"per_dim": (), "overall": 0.0}
    # A hand-built InstanceLoad may carry the default empty residual;
    # treat it as "no free capacity" rather than raggedly crashing the
    # stack below (simulate_instance always fills the field).
    dim = max((len(i.residual) for i in instances), default=0)
    if dim == 0:
        return {"per_dim": (), "overall": 0.0}
    if len(instances) == 1:
        # A single instance holds all free capacity by definition: zero
        # dispersion, clamped explicitly (the max/total ratio is 0/0-prone
        # when that lone residual is zero or non-finite).
        return {"per_dim": (0.0,) * dim, "overall": 0.0}
    resid = np.zeros((len(instances), dim))
    for row, inst in enumerate(instances):
        if inst.residual:
            resid[row] = inst.residual
    # Overloaded bins report negative residual in hand-built loads and
    # non-finite entries can leak from degenerate profiles; both would
    # drive the ratio (and the mean) to NaN — clamp to "no free capacity".
    resid = np.clip(np.nan_to_num(resid, nan=0.0, posinf=0.0, neginf=0.0), 0.0, None)
    totals = resid.sum(axis=0)  # (dim,)
    per_dim = np.where(
        totals > 1e-12, 1.0 - resid.max(axis=0) / np.maximum(totals, 1e-300), 0.0
    )
    per_dim = np.clip(per_dim, 0.0, 1.0)
    active = totals > 1e-12
    overall = float(per_dim[active].mean()) if active.any() else 0.0
    return {"per_dim": tuple(per_dim.tolist()), "overall": overall}


def simulate_plan(
    plan: AllocationPlan, profiles: ProfileTable, *, target: float = 0.9
) -> dict:
    """Returns overall performance + per-instance utilizations for a plan.

    ``target`` is the performance floor `meets_target` is judged against
    (paper: 90%).  Callers planning with a non-default utilization cap
    should pass their manager's ``utilization_cap`` here so the packing
    cap and the performance target cannot silently diverge.

    Placements are bucketed by instance in one pass — the former
    per-instance rescan was O(instances x placements), which dominated
    repeated re-plan/simulate loops on large fleets."""
    by_instance: list[list[np.ndarray]] = [[] for _ in plan.solution.bins]
    for p in plan.placements:
        prof = profiles.get(
            p.stream.program.program_id, str(p.stream.frame_size), p.device
        )
        assert prof is not None
        by_instance[p.instance_index].append(prof.at_fps(p.stream.desired_fps))
    per_instance: list[InstanceLoad] = []
    perf_by_stream: list[float] = []
    for bin_, reqs in zip(plan.solution.bins, by_instance):
        info = simulate_instance(bin_.bin_type, reqs)
        per_instance.append(info)
        perf_by_stream += [info.performance] * len(reqs)
    overall = float(np.mean(perf_by_stream)) if perf_by_stream else 1.0
    return {
        "overall_performance": overall,
        "instances": per_instance,
        "meets_target": overall >= target,  # paper: >= 90% by default
        "fragmentation": fleet_fragmentation(per_instance),
    }
