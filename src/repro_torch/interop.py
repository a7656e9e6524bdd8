"""State carried across packages as plain values.

The manager's state is the catalog, the profile table and the problem; the
live controller's adds the fleet, its churn trace and its billing
contracts; the serving path's and the analysis programs' are their
weights, the training path's its weights and optimizer moments.  These
helpers convert between the port's objects and plain
tuples and numpy arrays — names, capacities, costs, requirement vectors,
streams, events, assignments, weight arrays — so that any producer of the
same plain form (a file, another implementation of the manager or the
model) can feed the port identical inputs, and results can be compared
value for value.

A model's plain form is the reference's parameter pytree: nested dicts
and, under ``blocks``, a tuple of one dict per pattern slot, whose leaves
are stacked over layer groups.  A leaf's path is its keys joined by
``/``, a tuple index written ``[i]`` (``blocks/[0]/attn/wq``), and leaves
are ordered as jax flattens the tree: dict keys sorted, tuples in order
(`flatten_plain`).

The ``*_to_plain`` functions read attributes only, so they accept any
object with the port's field names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import streams as _streams
from .core.binpack.problem import BinType, Choice, Item, Problem
from .core.lifecycle import BillingModel
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
    "catalog_to_plain",
    "catalog_from_plain",
    "stream_to_plain",
    "stream_from_plain",
    "event_to_plain",
    "event_from_plain",
    "trace_to_plain",
    "trace_from_plain",
    "billing_to_plain",
    "billing_from_plain",
    "replan_result_to_plain",
    "problem_to_plain",
    "problem_from_plain",
    "profile_table_to_plain",
    "profile_table_from_plain",
    "plan_to_plain",
    "params_from_plain",
    "params_to_plain",
    "param_leaves",
    "plain_shapes",
    "flatten_plain",
    "unflatten_plain",
    "opt_state_to_plain",
    "opt_state_from_plain",
    "analysis_params_from_plain",
]


def catalog_to_plain(catalog) -> tuple:
    """``(name, capacity, cost, hazard, rent)`` per instance type, spot
    types (``hazard > 0``, ``rent`` set) included."""
    return tuple(
        (
            bt.name,
            tuple(float(c) for c in bt.capacity),
            float(bt.cost),
            float(bt.hazard),
            None if bt.rent is None else float(bt.rent),
        )
        for bt in catalog
    )


def catalog_from_plain(rows) -> tuple[BinType, ...]:
    """The port's catalog from `catalog_to_plain`'s rows."""
    return tuple(
        BinType(name, tuple(cap), cost, hazard=hazard, rent=rent)
        for name, cap, cost, hazard, rent in rows
    )


_TIER_FIELDS = ("name", "rank", "rate_ladder", "blackout_budget_s",
                "rung_penalty", "blackout_penalty", "parkable")


def stream_to_plain(spec) -> tuple:
    """``(name, (program name, program_id), desired_fps, (width, height),
    tier)``, the tier as its `SLATier` fields in declaration order."""
    tier = spec.tier
    return (
        spec.name,
        (spec.program.name, spec.program.program_id),
        float(spec.desired_fps),
        (int(spec.frame_size.width), int(spec.frame_size.height)),
        tuple(
            tuple(getattr(tier, f)) if f == "rate_ladder" else getattr(tier, f)
            for f in _TIER_FIELDS
        ),
    )


def stream_from_plain(plain) -> _streams.StreamSpec:
    """The port's `StreamSpec` from `stream_to_plain`'s form."""
    name, (prog_name, program_id), fps, (w, h), tier = plain
    return _streams.StreamSpec(
        name,
        _streams.AnalysisProgram(prog_name, program_id),
        fps,
        _streams.FrameSize(w, h),
        _streams.SLATier(**dict(zip(_TIER_FIELDS, tier))),
    )


#: The fleet events `event_to_plain` knows, by class name.
_EVENTS = ("StreamAdded", "StreamRemoved", "StreamRateChanged", "PriceChanged",
           "InstancePreempted", "InstancePreemptionNotice")


def event_to_plain(event) -> tuple:
    """``(class name, {field: value})`` of a fleet event, ``at`` included;
    a `StreamAdded`'s stream in `stream_to_plain`'s form."""
    kind = type(event).__name__
    if kind not in _EVENTS:
        raise TypeError(f"unknown fleet event {event!r}")
    fields = {
        f.name: getattr(event, f.name) for f in dataclasses.fields(event)
    }
    if "stream" in fields:
        fields["stream"] = stream_to_plain(fields["stream"])
    return kind, fields


def event_from_plain(plain) -> _streams.FleetEvent:
    """The port's fleet event from `event_to_plain`'s form."""
    kind, fields = plain
    if kind not in _EVENTS:
        raise TypeError(f"unknown fleet event kind {kind!r}")
    fields = dict(fields)
    if "stream" in fields:
        fields["stream"] = stream_from_plain(fields["stream"])
    return getattr(_streams, kind)(**fields)


def trace_to_plain(trace) -> dict:
    """``{"events", "horizon"}``: a `TimedTrace`'s events in
    `event_to_plain`'s form and its horizon."""
    return {
        "events": tuple(event_to_plain(ev) for ev in trace.events),
        "horizon": float(trace.horizon),
    }


def trace_from_plain(plain: dict) -> _streams.TimedTrace:
    """The port's `TimedTrace` from `trace_to_plain`'s form."""
    return _streams.TimedTrace(
        events=tuple(event_from_plain(ev) for ev in plain["events"]),
        horizon=plain["horizon"],
    )


def billing_to_plain(billing) -> tuple:
    """``(boot_hours, quantum_hours, min_billed_hours)``."""
    return (
        float(billing.boot_hours),
        float(billing.quantum_hours),
        float(billing.min_billed_hours),
    )


def billing_from_plain(plain) -> BillingModel:
    """The port's `BillingModel` from `billing_to_plain`'s form."""
    boot, quantum, minimum = plain
    return BillingModel(boot_hours=boot, quantum_hours=quantum,
                        min_billed_hours=minimum)


def replan_result_to_plain(result) -> dict:
    """A `ReplanResult` as plain values: ``mode``, ``cost`` (the plan's
    $/h), ``gap``, ``lower_bound``, ``displaced``, ``migrated``,
    ``actions``, ``at`` and ``assignments``: ``(stream name, instance
    index, instance type, device)`` per placement, in the plan's order."""
    plan = result.plan
    return {
        "mode": result.mode,
        "cost": float(plan.hourly_cost),
        "gap": float(result.gap),
        "lower_bound": float(result.lower_bound),
        "displaced": tuple(result.displaced),
        "migrated": tuple(result.migrated),
        "actions": tuple(result.actions),
        "at": float(result.at),
        "assignments": tuple(
            (p.stream.name, int(p.instance_index), p.instance_type, p.device)
            for p in plan.placements
        ),
    }


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


def flatten_plain(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a plain tree in jax's leaf order: dicts by sorted
    key, tuples by index (``[i]``); anything else (an array, a tensor, a
    list) is a leaf."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat = {}
    for key, value in items:
        flat.update(flatten_plain(value, f"{prefix}/{key}" if prefix else key))
    return flat


def unflatten_plain(flat: dict):
    """The tree `flatten_plain` flattened: a path component ``[i]`` is a
    tuple index, any other a dict key."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") and k.endswith("]") for k in node):
            return tuple(fix(node[f"[{i}]"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def param_leaves(cfg, model: tfm.Transformer) -> dict:
    """``{path: parameters}`` in the reference's leaf order: a top-level
    leaf's value is its tensor, a block leaf's the list of the
    ``num_groups`` layer tensors it stacks (group ``g`` at index ``g``).
    The tensors are the model's own parameters, not copies."""
    tree = {}
    for name in ("embed", "final_norm", "unembed", "vision_proj"):
        if getattr(model, name) is not None:
            tree[name] = getattr(model, name)
    n = len(cfg.layer_pattern)
    blocks = []
    for slot in range(n):
        layers = list(model.blocks[slot::n])
        names = [name for name, _ in layers[0].named_parameters()]
        blocks.append(unflatten_plain({
            name.replace(".", "/"): [layer.get_parameter(name) for layer in layers]
            for name in names}))
    tree["blocks"] = tuple(blocks)
    return flatten_plain(tree)


def plain_shapes(cfg, model: tfm.Transformer) -> dict:
    """``{path: shape}`` of `params_to_plain`'s leaves, without copying."""
    return {path: tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
            else (len(leaf),) + tuple(leaf[0].shape)
            for path, leaf in param_leaves(cfg, model).items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def params_to_plain(cfg, model: tfm.Transformer) -> dict:
    """The reference's parameter pytree from the port's `Transformer`: the
    inverse of `params_from_plain`, every leaf a float32 numpy array, block
    leaves stacked over layer groups.  A bf16 weight widens exactly."""
    return unflatten_plain({
        path: _to_numpy(leaf) if isinstance(leaf, torch.Tensor)
        else np.stack([_to_numpy(t) for t in leaf])
        for path, leaf in param_leaves(cfg, model).items()})


def opt_state_to_plain(state: dict) -> dict:
    """The reference's optimizer state (``{"mu", "nu", "step"}``, moments
    shaped like its parameter pytree) from the port's, whose ``mu`` and
    ``nu`` are ``{path: float32 tensor}`` (`repro_torch.train.optimizer`)."""
    return {
        "mu": unflatten_plain({k: _to_numpy(v) for k, v in state["mu"].items()}),
        "nu": unflatten_plain({k: _to_numpy(v) for k, v in state["nu"].items()}),
        "step": np.asarray(int(state["step"]), dtype=np.int32),
    }


def opt_state_from_plain(plain: dict, *, device=None) -> dict:
    """The port's optimizer state from the reference's, on ``device``
    (default: the card); the moments float32, ``step`` an int32 scalar."""
    dev = resolve_device(device)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return {
        "mu": {k: put(v) for k, v in flatten_plain(plain["mu"]).items()},
        "nu": {k: put(v) for k, v in flatten_plain(plain["nu"]).items()},
        "step": torch.tensor(int(np.asarray(plain["step"])), dtype=torch.int32, device=dev),
    }


def analysis_params_from_plain(program_id: str, tree: dict, *, device=None) -> dict:
    """The port's VGG-16 or ZF parameters from the reference's pytree.

    ``tree`` is what the reference's ``init_vgg16``/``init_zf`` returns,
    with every leaf a numpy array: ``convs``, one ``{"w": (kh, kw, cin,
    cout) HWIO, "b"}`` per conv, and ``fc``, one ``{"w": (d_in, d_out),
    "b"}`` per head layer.  Conv weights become OIHW; the fc weights keep
    their layout, fc6's rows included, since the port flattens the trunk's
    output in the reference's (h, w, c) order.  float32, on ``device``
    (default: the card).
    """
    if program_id not in ("vgg16", "zf"):
        raise KeyError(program_id)
    dev = resolve_device(device)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return {
        "convs": [{"w": put(np.transpose(p["w"], (3, 2, 0, 1))), "b": put(p["b"])}
                  for p in tree["convs"]],
        "fc": [{"w": put(p["w"]), "b": put(p["b"])} for p in tree["fc"]],
    }
