"""State carried across packages as plain values.

The manager's state is the catalog, the profile table and the problem; the
serving path's is the model's weights.  These helpers convert between the
port's objects and plain tuples and numpy arrays — names, capacities,
costs, requirement vectors, assignments, weight arrays — so that any
producer of the same plain form (a file, another implementation of the
manager or the model) can feed the port identical inputs, and results can
be compared value for value.

The ``*_to_plain`` functions read attributes only, so they accept any
object with the port's field names.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.binpack.problem import BinType, Choice, Item, Problem
from .core.profiler import ProfileTable, ResourceProfile
from .device import resolve_device
from .models import moe, rglru, ssm
from .models import transformer as tfm
from .models.attention import Attention
from .models.layers import MLP
from .models.moe import MoE
from .models.rglru import RGLRU
from .models.ssm import Mamba2

__all__ = [
    "problem_to_plain",
    "problem_from_plain",
    "profile_table_to_plain",
    "profile_table_from_plain",
    "plan_to_plain",
    "params_from_plain",
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


def params_from_plain(cfg, tree: dict, *, device=None) -> tfm.Transformer:
    """The port's `Transformer` from the reference's parameter pytree.

    ``tree`` is what the reference's ``init_params`` returns, with every
    leaf a float32 numpy array: ``embed`` (K, V, d), ``final_norm``,
    optional ``unembed`` and ``vision_proj``, and ``blocks``, one dict per
    pattern slot whose leaves are stacked over layer groups.  Layer ``i``
    is group ``i // len(pattern)`` of slot ``i % len(pattern)``; a slot's
    dict holds ``ln1`` and ``attn``, ``mamba`` or ``rec``, and, unless it
    is ``"ssd"``, ``ln2`` and ``mlp`` or (``"moe"``) ``moe``.  Each leaf is
    cast, on ``device`` (default: the card), to the type the port's own
    ``init_params`` gives it, which is the reference's: ``cfg.dtype``,
    except the float32 leaves of `ssm.FLOAT32_PARAMS`,
    `rglru.FLOAT32_PARAMS` and `moe.FLOAT32_PARAMS`.  A bf16 array widened
    to float32 comes back exactly.
    """
    dev = resolve_device(device)
    dt = tfm.torch_dtype(cfg)

    def put(a, dtype=dt) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    def opt(d: dict, key: str, grp: int | None = None):
        if key not in d:
            return None
        return put(d[key] if grp is None else d[key][grp])

    def leaves(d: dict, grp: int, float32: tuple[str, ...]) -> dict:
        return {k: put(v[grp], torch.float32 if k in float32 else dt) for k, v in d.items()}

    blocks = []
    for i in range(cfg.num_layers):
        grp, slot = divmod(i, len(cfg.layer_pattern))
        kind = cfg.layer_pattern[slot]
        p = tree["blocks"][slot]
        ln1 = put(p["ln1"][grp])
        if kind == "ssd":
            blocks.append(tfm.Block(kind, ln1, Mamba2(**leaves(p["mamba"], grp,
                                                              ssm.FLOAT32_PARAMS))))
            continue
        if kind == "recurrent":
            mixer = RGLRU(**leaves(p["rec"], grp, rglru.FLOAT32_PARAMS))
        else:
            a = p["attn"]
            mixer = Attention(put(a["wq"][grp]), put(a["wk"][grp]), put(a["wv"][grp]),
                              put(a["wo"][grp]), opt(a, "q_norm", grp), opt(a, "k_norm", grp))
        if kind == "moe":
            blocks.append(tfm.Block(kind, ln1, mixer, put(p["ln2"][grp]),
                                    moe=MoE(**leaves(p["moe"], grp, moe.FLOAT32_PARAMS))))
            continue
        m = p["mlp"]
        blocks.append(tfm.Block(kind, ln1, mixer, put(p["ln2"][grp]),
                                MLP(put(m["up"][grp]), put(m["down"][grp]), opt(m, "gate", grp))))
    return tfm.Transformer(put(tree["embed"]), put(tree["final_norm"]), blocks,
                           unembed=opt(tree, "unembed"), vision_proj=opt(tree, "vision_proj"))
