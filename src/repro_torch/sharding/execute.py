"""Placing a model and its state by the sharding plan, and running steps on it.

The plan (`repro_torch.sharding.specs`) gives a spec for each of the
reference's leaves, a block leaf stacked over layer groups.  Here every
leaf is held as a `DTensor` of that stacked shape at its spec's
placements, so each rank holds exactly the bytes the plan gives it: the
parameters, the AdamW moments (placed like the parameters; the step
counter replicated), the batch (`train_batch_specs`,
`decode_input_specs`) and the caches (`cache_specs`, one per layer: the
slot's spec without its group entry).  `place` cuts a rank's shard out of
the full tensor every rank holds alike (nothing is sent); `full` gathers
one back.

A step runs each layer on the local shards (`repro_torch.sharding.parallel`
has the context the layers read and the collectives they call).  Layer
``i`` is row ``i // n`` of its slot's stacked leaves (n the pattern's
length), and `_Layers` hands a layer group its parameters at use:

* a dim sharded over ``model`` stays local: the layers compute on their
  own heads, columns, experts or vocabulary;
* a dim sharded over ``data`` (FSDP) is gathered over ``data`` (its
  gradient reduce-scattered back);
* a group axis sharded over ``data`` (mamba2-1.3b's 48 groups over 16
  data ranks at full size): each data rank holds its contiguous run of
  groups, and a group's layer reaches the other ranks from its owner
  (`parallel.from_owner`), its gradient summed back to the owner.

Under remat the gathers run again in the backward, inside each group's
checkpoint.  The hand-written kernels run on each rank's local tensors:
`flash_attention` on its q heads and the KV heads they read, the SSD scan
on its heads, the RG-LRU scan on its run of the width, the grouped GEMM
on its experts (or its columns of every expert), `decode_attention` on
its heads and, where the decode caches' slots are split, on its slots,
merged by log-sum-exp.

Gradients: every rank's loss is its micro-batch's; a parameter's gradient
is summed over the batch dims its spec does not use (the others were
reduce-scattered or summed to their owner), so each micro-batch's rows
count once; the global-norm clip adds the squares of each distinct shard
once, over the whole mesh.

Micro-batches (`make_sharded_train_step`): with M micro-batches of B/M
rows over D batch ranks, each rank cuts every micro-batch from its own
rows where B/M >= D.  Where B/M < D (grok-1-314b's train_4k: 8 rows over
16 or 32), the batch ranks split, in mesh order, into G = D / (B/M)
sub-groups of B/M ranks; in local step j every rank takes its row j, so
the G sub-groups each run one micro-batch side by side.  The step's layers
then run under a step-local mesh of the same ranks whose batch dims are
cut into (G, B/M) (`microbatch_mesh`): the loss, the MoE's token count,
capacity, dispatch groups and aux reduce over a micro-batch's sub-group,
while the FSDP gathers, the gradient sums and the clip stay over the whole
mesh.
"""
from __future__ import annotations

import functools
import types

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..interop import param_leaves
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..train.optimizer import AdamWConfig, adamw_update
from ..train.train_loop import _micro_batches
from . import parallel
from .specs import placements

__all__ = [
    "axes_of",
    "local_slice",
    "place",
    "full",
    "place_params",
    "place_train_state",
    "place_tree",
    "place_caches",
    "resident_bytes",
    "copy_into",
    "layer_spec",
    "owned_groups",
    "make_sharded_train_step",
    "make_sharded_prefill",
    "make_sharded_decode",
    "to_decode_caches",
    "sharded_forward_train",
    "microbatch_groups",
    "microbatch_rows",
    "microbatch_mesh",
    "SIDE_BY_SIDE",
    "WITHIN",
]


# ---- placement ------------------------------------------------------------------------


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, outer first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(axes: tuple, mesh) -> tuple[int, int]:
    """(this rank's shard, shards) of a dim split over ``axes`` (outer
    first, as DTensor splits it)."""
    n, i = 1, 0
    for ax in axes:
        size = mesh.size(mesh.mesh_dim_names.index(ax))
        n, i = n * size, i * size + mesh.get_local_rank(ax)
    return i, n


def local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` at ``spec`` (a view; shards even)."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        i, n = _index(axes, mesh)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {n} at {spec}")
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t


def _pad(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _dtensor(local: torch.Tensor, spec, mesh, shape):
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(_pad(spec, len(shape)), mesh),
                              run_check=False, shape=shape, stride=stride)


def place(t: torch.Tensor, spec, mesh):
    """``t`` (the same full tensor on every rank) as a DTensor at ``spec``:
    each rank keeps its own shard, a contiguous copy; nothing is sent."""
    spec = _pad(spec, t.dim())
    local = local_slice(t, spec, mesh).clone(memory_format=torch.contiguous_format)
    return _dtensor(local, spec, mesh, t.shape)


def _spec_of(dt) -> tuple:
    """The spec of a DTensor's placements (the inverse of `placements`)."""
    names = dt.device_mesh.mesh_dim_names
    entries = [[] for _ in range(dt.dim())]
    for name, p in zip(names, dt.placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries)


@torch.no_grad()
def full(dt) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (gathered by this
    module's collectives, so that it also runs where the backend lacks
    DTensor's)."""
    mesh, t = dt.device_mesh, dt.to_local()
    names = mesh.mesh_dim_names
    for d in reversed(range(len(names))):  # inner mesh dims first
        p = dt.placements[d]
        if p.is_shard():
            t = parallel._gather(t, p.dim, mesh.get_group(names[d]))
    return t


def layer_spec(spec) -> tuple:
    """A block leaf's per-layer spec: its stacked spec without the group
    entry."""
    return tuple(spec[1:])


def owned_groups(n_groups: int, spec, mesh) -> range:
    """The layer groups this rank holds of a stacked leaf at ``spec``: all,
    unless its group axis is sharded, then its contiguous run."""
    i, n = _index(axes_of(spec[0]), mesh)
    if n_groups % n:
        raise ValueError(f"{n_groups} groups do not split into {n}")
    per = n_groups // n
    return range(i * per, (i + 1) * per)


def _leaf_local(leaf, spec, mesh) -> tuple[torch.Tensor, tuple]:
    """(this rank's shard, the stacked shape) of a `param_leaves` leaf: a
    tensor, or a block leaf's per-group tensors, stacked only over the
    groups this rank holds."""
    if isinstance(leaf, torch.Tensor):
        local = local_slice(leaf, _pad(spec, leaf.dim()), mesh)
        return local.clone(memory_format=torch.contiguous_format), tuple(leaf.shape)
    spec = _pad(spec, leaf[0].dim() + 1)
    rows = [local_slice(leaf[g], spec[1:], mesh)
            for g in owned_groups(len(leaf), spec, mesh)]
    return torch.stack(rows), (len(leaf),) + tuple(leaf[0].shape)


@torch.no_grad()
def place_params(cfg: ModelConfig, model, pspecs: dict, mesh) -> dict:
    """``{path: DTensor}``: the reference's stacked leaves of ``model`` (a
    `Transformer`, the same weights on every rank) at ``pspecs``."""
    out = {}
    for path, leaf in param_leaves(cfg, model).items():
        local, shape = _leaf_local(leaf, pspecs[path], mesh)
        out[path] = _dtensor(local, _pad(pspecs[path], len(shape)), mesh, shape)
    return out


@torch.no_grad()
def place_tree(tree: dict, specs: dict, mesh) -> dict:
    """``{key: DTensor}`` of a flat dict of full tensors (stacked leaves, a
    batch) at ``specs``."""
    return {k: place(v, specs[k], mesh) for k, v in tree.items()}


@torch.no_grad()
def place_train_state(cfg: ModelConfig, model, state_specs: dict, mesh, opt=None) -> dict:
    """The sharded train state: the parameters of ``model`` and the moments
    of ``opt`` (the one-device optimizer state, `init_opt_state`'s form;
    zeros without one) at ``state_specs`` (`make_train_setup`'s), and
    the step counter, replicated."""
    pspecs = state_specs["params"]
    params = place_params(cfg, model, pspecs, mesh)

    def moments(key):
        if opt is not None:
            return {p: place(opt[key][p], pspecs[p], mesh) for p in params}
        return {p: _dtensor(torch.zeros(dt.to_local().shape, dtype=torch.float32,
                                        device=dt.to_local().device),
                            _pad(pspecs[p], dt.dim()), mesh, dt.shape)
                for p, dt in params.items()}

    device = next(iter(params.values())).to_local().device
    step = (opt["step"].to(device) if opt is not None
            else torch.zeros((), dtype=torch.int32, device=device))
    return {"params": params,
            "opt": {"mu": moments("mu"), "nu": moments("nu"),
                    "step": _dtensor(step.clone(), (), mesh, ())}}


@torch.no_grad()
def place_caches(caches: list, cspecs: tuple, cfg: ModelConfig, mesh) -> list:
    """One dict of DTensors per layer: layer ``i``'s caches at its slot's
    spec without the group entry (`cache_specs`)."""
    n = len(cfg.layer_pattern)
    return [{k: place(v, layer_spec(cspecs[i % n][k]), mesh) for k, v in c.items()}
            for i, c in enumerate(caches)]


@torch.no_grad()
def copy_into(cfg: ModelConfig, model, params: dict) -> None:
    """Write the whole of `place_params`' DTensors back into ``model``'s
    parameters (every rank gathers every leaf)."""
    for path, leaf in param_leaves(cfg, model).items():
        value = full(params[path])
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(value)
        else:
            for g, t in enumerate(leaf):
                t.copy_(value[g])


def resident_bytes(tree) -> int:
    """Bytes of this rank's shards of every DTensor in ``tree`` (dicts and
    lists of them)."""
    if isinstance(tree, dict):
        return sum(resident_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(resident_bytes(v) for v in tree)
    local = tree.to_local()
    return local.numel() * local.element_size()


# ---- the layers at use ---------------------------------------------------------------


#: The row-parallel weight of each sub-module: sharded over ``model``
#: exactly when the sub-module's work is (its ``tp`` flag).
_ROW_PARALLEL = {"attn": "wo", "mlp": "down", "moe": "down", "rec": "out",
                 "mamba": "out_proj"}
_OPTIONAL = {"attn": ("q_norm", "k_norm"), "mlp": ("gate",), "moe": ("gate",)}


class _Layers:
    """The parameters of each layer group at use, from the local shards of
    the stacked leaves (see the module's docstring).  ``par`` places them
    (the gathers run over its mesh); ``ctx``, the context the layers run
    under, is ``par`` unless the step's micro-batches run side by side on
    sub-groups of the batch ranks (`microbatch_mesh`)."""

    def __init__(self, cfg: ModelConfig, local: dict, pspecs: dict, par: parallel.Parallel,
                 ctx: parallel.Parallel | None = None):
        self.cfg, self.local, self.pspecs, self.par = cfg, local, pspecs, par
        self.ctx = par if ctx is None else ctx

    def _gather_fsdp(self, t: torch.Tensor, spec) -> torch.Tensor:
        for dim, entry in enumerate(spec):
            for ax in reversed(axes_of(entry)):
                if ax != self.par.model:
                    t = parallel.gather(t, dim, self.par.group(ax))
        return t

    def top(self) -> types.SimpleNamespace:
        """``embed``, ``final_norm``, ``unembed`` and ``vision_proj``."""
        ns = types.SimpleNamespace(embed=None, final_norm=None, unembed=None, vision_proj=None)
        for name in vars(ns):
            if name in self.local:
                setattr(ns, name, self._gather_fsdp(self.local[name], self.pspecs[name]))
        return ns

    def _row(self, path: str, g: int) -> torch.Tensor:
        spec = self.pspecs[path]
        stacked = self.local[path]
        axes = axes_of(spec[0])
        if not axes:
            t = stacked[g]
        else:
            if len(axes) != 1:
                raise ValueError(f"{path}: group axis over {axes}")
            groups = owned_groups(self.cfg.num_groups, spec, self.par.mesh)
            per = len(groups)
            owner = g // per
            if g in groups:
                t = stacked[g - groups.start]
            else:
                # A stand-in of the owner's shard; it asks for a gradient as
                # the owner's does, so that every rank's backward reaches
                # the same collectives in the same order.
                t = torch.zeros_like(stacked[0]).requires_grad_(stacked.requires_grad)
            t = parallel.from_owner(t, owner, self.par.group(axes[0]))
        return self._gather_fsdp(t, layer_spec(spec))

    def group(self, g: int) -> list:
        """The layers of group ``g``, one namespace each, in slot order."""
        layers = []
        for slot, kind in enumerate(self.cfg.layer_pattern):
            prefix = f"blocks/[{slot}]/"
            tree: dict = {}
            for path in self.local:
                if path.startswith(prefix):
                    node = tree
                    parts = path[len(prefix):].split("/")
                    for part in parts[:-1]:
                        node = node.setdefault(part, {})
                    node[parts[-1]] = path
            layer = types.SimpleNamespace(kind=kind, ln1=None, ln2=None, mlp=None, moe=None)
            for name, value in tree.items():
                if isinstance(value, str):
                    setattr(layer, name, self._row(value, g))
                    continue
                sub = types.SimpleNamespace(**{k: None for k in _OPTIONAL.get(name, ())})
                for leaf, path in value.items():
                    setattr(sub, leaf, self._row(path, g))
                # Any dim of the row-parallel weight over ``model``: its rows
                # (heads, width, experts), or the hidden columns of every
                # expert where the experts do not divide the axis.
                row = value[_ROW_PARALLEL[name]]
                sub.tp = self.par.model in _used(layer_spec(self.pspecs[row]))
                setattr(layer, name, sub)
            layers.append(layer)
        return layers


# ---- forward and loss ------------------------------------------------------------------


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _group_fn(cfg, layers: _Layers, g: int, positions, x):
    with parallel.active(layers.ctx):
        return tfm._apply_group_train(cfg, layers.group(g), positions, x)


def _forward(cfg: ModelConfig, layers: _Layers, batch: dict, *, remat: bool):
    """(local logits, aux, the vocabulary's ``(first id, ids)`` on this
    rank) of `transformer.forward_train` on this rank's rows."""
    with parallel.active(layers.ctx):
        top = layers.top()
        x = tfm.embed_inputs(top, cfg, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(cfg.num_groups):
            fn = functools.partial(_group_fn, cfg, layers, g, positions)
            x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
            aux = aux + a
        logits = tfm.unembed(top, cfg, x)
        vocab = tfm.vocab_shard(top, cfg)
    return logits, {"router_aux": aux / max(cfg.num_layers, 1)}, vocab


def _sum_over(x: torch.Tensor, par: parallel.Parallel) -> torch.Tensor:
    for dim in par.batch_dims:
        x = parallel.leave(x, par.group(dim))
    return x


def _cross_entropy_sum(logits, labels, vocab, par: parallel.Parallel):
    """Summed next-token cross entropy of this rank's rows over its run of
    the vocabulary ``vocab = (first id, ids)``, the max, the sum of
    exponentials and the label's logit completed over ``model``."""
    logits = logits.reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1).long()
    v0, ids = vocab
    if logits.shape[-1] != ids:
        raise ValueError(f"logits of {logits.shape[-1]} ids for a shard of {ids}")
    pg = par.group(par.model)
    m = parallel.all_reduce(logits.detach().amax(-1, keepdim=True), pg, "max")
    sumexp = parallel.leave(torch.exp(logits - m).sum(-1), pg)
    local = labels - v0
    inside = (local >= 0) & (local < ids)
    tgt = logits.gather(-1, local.clamp(0, ids - 1)[:, None])[:, 0] * inside
    tgt = parallel.leave(tgt, pg)
    return (torch.log(sumexp) + m[:, 0] - tgt).sum()


def _loss(cfg: ModelConfig, layers: _Layers, batch: dict, *, remat: bool):
    """`transformer.loss_fn` over the micro-batch this rank's rows belong
    to (the global batch, or a sub-group's): (total, parts), alike on each
    of its ranks."""
    par = layers.ctx
    logits, aux, vocab = _forward(cfg, layers, batch, remat=remat)
    labels = batch["labels"]
    if cfg.num_codebooks > 1 and labels.dim() != 3:
        raise ValueError(f"{cfg.name} takes (B, S, K) labels, got {tuple(labels.shape)}")
    if cfg.modality == "vision_prefix" and "vision_embeds" in batch:
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    with parallel.active(par):
        if vocab[1] == cfg.vocab_size:
            ce_sum = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     labels.reshape(-1).long(), reduction="sum")
        else:
            ce_sum = _cross_entropy_sum(logits, labels, vocab, par)
        ce = _sum_over(ce_sum, par) / (labels.numel() * par.batch_shards)
    total = ce + cfg.router_aux_loss_coef * aux["router_aux"]
    return total, {"ce": ce, **aux}


def _train_par(mesh, batch_specs: dict) -> parallel.Parallel:
    return parallel.Parallel(mesh, batch_dims=axes_of(batch_specs["tokens"][0]))


def sharded_forward_train(cfg: ModelConfig, mesh, pspecs: dict, batch_specs: dict):
    """``fwd(params, batch) -> (logits, aux)``, `transformer.forward_train`
    over the mesh: ``params`` `place_params`' DTensors, ``batch`` DTensors
    at ``batch_specs``; the logits a DTensor split over the batch's data
    axes and, where the unembedding is, over ``model`` on the vocabulary."""

    @torch.no_grad()
    def fwd(params: dict, batch: dict):
        par = _train_par(mesh, batch_specs)
        layers = _Layers(cfg, {p: dt.to_local() for p, dt in params.items()}, pspecs, par)
        local = {k: _local(v) for k, v in batch.items()}
        logits, aux, vocab = _forward(cfg, layers, local, remat=False)
        return _logits_dtensor(cfg, logits, vocab, par, batch_specs["tokens"][0]), aux

    return fwd


def _logits_dtensor(cfg, logits, vocab, par, batch_entry):
    spec = [batch_entry] + [None] * (logits.dim() - 1)
    if vocab[1] != cfg.vocab_size:
        spec[-1] = par.model
    shape = list(logits.shape)
    shape[0] *= par.batch_shards
    shape[-1] = cfg.vocab_size
    return _dtensor(logits, tuple(spec), par.mesh, shape)


# ---- the train step ---------------------------------------------------------------

#: The dims of `microbatch_mesh` that take the batch dims' place: which of
#: the micro-batches run side by side, and the ranks one is split over.
SIDE_BY_SIDE, WITHIN = "microbatch", "microbatch_rank"


def microbatch_groups(batch: int, shards: int, microbatches: int) -> int:
    """G, the micro-batches a sharded step runs side by side: 1 where a
    micro-batch's B/M rows are cut from every one of the D batch ranks'
    rows (B/M a multiple of D), D / (B/M) where it has fewer rows than there
    are batch ranks (B/M dividing D: a row on each rank of a sub-group).
    Raises `ValueError` naming B, M and D where the rows cut neither way."""
    if microbatches > 0 and batch % microbatches == 0 and batch % shards == 0:
        rows = batch // microbatches
        if rows % shards == 0:
            return 1
        if shards % rows == 0:
            return shards // rows
    raise ValueError(f"B {batch} rows in M {microbatches} micro-batches over D {shards} batch "
                     "ranks: B/M must be a multiple of D or divide it")


def microbatch_rows(batch: int, shards: int, microbatches: int) -> list[int]:
    """The global row order whose one-device micro-batches (contiguous, in
    order) are the sharded step's: micro-batch ``j·G + g`` (G from
    `microbatch_groups`) takes ``c`` rows from each of the ``q = D / G``
    ranks of sub-group ``g``, rows ``(g·q + s)·per + j·c + t``.  With G = 1
    that is the ``j``-th slice of every shard's rows; with G > 1, ``c`` is 1:
    row ``j`` of each rank of the sub-group."""
    groups = microbatch_groups(batch, shards, microbatches)
    per = batch // shards
    c = batch // microbatches * groups // shards
    q = shards // groups
    return [(g * q + s) * per + j * c + t for j in range(per // c) for g in range(groups)
            for s in range(q) for t in range(c)]


def microbatch_mesh(mesh, batch_dims: tuple, groups: int):
    """``mesh``'s ranks with its batch dims (its leading dims) flattened in
    mesh order, as `Parallel.batch_rank` counts them, and cut into
    ``(groups, D / groups)`` over ``(SIDE_BY_SIDE, WITHIN)``: sub-group
    ``g`` holds batch ranks ``g·D/G`` to ``(g + 1)·D/G - 1``.  Its other
    dims are ``mesh``'s.  It makes process groups, so every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(mesh.mesh_dim_names)
    k = len(batch_dims)
    if names[:k] != tuple(batch_dims):
        raise ValueError(f"batch dims {batch_dims} do not lead the mesh's {names}")
    ranks = mesh.mesh
    grid = ranks.reshape((groups, -1) + tuple(ranks.shape[k:]))
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=(SIDE_BY_SIDE, WITHIN) + names[k:])


def _used(spec) -> set:
    """The mesh axes a spec shards over."""
    return {ax for entry in spec for ax in axes_of(entry)}


def _grad_weights(pspecs: dict, mesh) -> dict:
    """1 where this rank holds the first copy of a leaf's shard (its
    coordinate is 0 on every mesh dim the leaf's spec does not use), else 0."""
    return {path: float(all(mesh.get_local_rank(d) == 0
                            for d in mesh.mesh_dim_names if d not in _used(spec)))
            for path, spec in pspecs.items()}


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, state_specs: dict,
                            batch_specs: dict, *, remat: bool = True, microbatches: int = 1):
    """``step(state, batch, events=None) -> (state, metrics)`` over the
    mesh: `train_loop.make_train_step`'s step on `place_train_state`'s
    state and a batch of DTensors at ``batch_specs``.  The M micro-batches
    are cut from each rank's own rows or, where they have fewer rows than
    there are batch ranks, run side by side on sub-groups of them (see the
    module's docstring; `microbatch_groups` raises where neither fits);
    `microbatch_rows` gives the row order of the equal one-device step.
    The state's shards are updated in place; ``events``, as the one-device
    step's."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")
    pspecs = state_specs["params"]
    weights = _grad_weights(pspecs, mesh)
    names = mesh.mesh_dim_names
    sub_mesh = []  # [G, its `microbatch_mesh`], made on the first grouped call

    def record(events, i):
        if events is not None:
            events[i].record()

    def context(par: parallel.Parallel, rows: int) -> tuple[int, parallel.Parallel]:
        """(G, the context the layers run under) for a batch of ``rows``
        rows a rank."""
        groups = microbatch_groups(rows * par.batch_shards, par.batch_shards, microbatches)
        if groups == 1:
            return 1, par
        if not sub_mesh or sub_mesh[0] != groups:
            sub_mesh[:] = [groups, microbatch_mesh(mesh, par.batch_dims, groups)]
        return groups, parallel.Parallel(sub_mesh[1], batch_dims=(WITHIN,))

    def train_step(state: dict, batch: dict, events=None):
        par = _train_par(mesh, batch_specs)
        local = {p: dt.to_local() for p, dt in state["params"].items()}
        for t in local.values():
            t.requires_grad_(True)
            t.grad = None
        rows = {k: _local(v) for k, v in batch.items()}
        groups, ctx = context(par, next(iter(rows.values())).shape[0])
        layers = _Layers(cfg, local, pspecs, par, ctx)
        record(events, 0)
        totals, parts, sums = [], [], None
        for one in _micro_batches(rows, microbatches // groups):
            total, part = _loss(cfg, layers, one, remat=remat)
            if microbatches == 1:
                record(events, 1)
            total.backward()
            if microbatches == 1:
                sums = {p: t.grad if t.grad is not None else torch.zeros_like(t)
                        for p, t in local.items()}
            else:
                if sums is None:
                    sums = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                            for p, t in local.items()}
                for p, t in local.items():
                    if t.grad is not None:
                        sums[p].add_(t.grad)
            for t in local.values():
                t.grad = None
            totals.append(total.detach())
            parts.append({k: v.detach() for k, v in part.items()})
        if microbatches > 1:
            record(events, 1)
            sums = {p: g.div_(microbatches) for p, g in sums.items()}
        # Each rank's gradient covers its own rows: add them over the batch
        # dims the leaf does not use (the others were reduce-scattered), so
        # each of the G sub-groups' micro-batches counts once.
        grads = {}
        for p, g in sums.items():
            for dim in par.batch_dims:
                if dim not in _used(pspecs[p]):
                    g = parallel.all_reduce(g, par.group(dim))
            grads[p] = g
        record(events, 2)
        for t in local.values():
            t.requires_grad_(False)

        def global_sq(gs: dict) -> torch.Tensor:
            sq = sum(weights[p] * g.float().square().sum() for p, g in gs.items())
            for d in names:
                sq = parallel.all_reduce(sq, mesh.get_group(d))
            return sq

        opt = state["opt"]
        local_opt = {"mu": {p: dt.to_local() for p, dt in opt["mu"].items()},
                     "nu": {p: dt.to_local() for p, dt in opt["nu"].items()},
                     "step": opt["step"].to_local()}
        _, local_opt, opt_metrics = adamw_update(opt_cfg, local, grads, local_opt,
                                                 global_sq=global_sq)
        opt["step"] = _dtensor(local_opt["step"], (), mesh, ())
        record(events, 3)
        # The loss and its parts, a row a local step; summed over the other
        # sub-groups' micro-batches, then averaged over all M.
        keys = list(parts[0])
        table = torch.stack([torch.stack([t.float()] + [row[k].float() for k in keys])
                             for t, row in zip(totals, parts)])
        if groups > 1:
            table = parallel.all_reduce(table, ctx.group(SIDE_BY_SIDE))
        means = table.sum(0) / microbatches
        metrics = {"loss": means[0], **dict(zip(keys, means[1:])), **opt_metrics}
        return state, metrics

    return train_step


# ---- serving ----------------------------------------------------------------------


def _serve(cfg, mesh, pspecs, params, x_fn, positions_fn, cur_pos, caches, par, *,
           decode: bool, long_context: bool):
    local = {p: dt.to_local() for p, dt in params.items()}
    layers = _Layers(cfg, local, pspecs, par)
    cache_local = [{k: v.to_local() for k, v in c.items()} for c in caches]
    if len(cache_local) != cfg.num_layers:
        raise ValueError(f"{len(cache_local)} caches for {cfg.num_layers} layers")
    n = len(cfg.layer_pattern)
    with parallel.active(par):
        top = layers.top()
        x = x_fn(top)
        positions = positions_fn(x)
        for grp in range(cfg.num_groups):
            for slot, layer in enumerate(layers.group(grp)):
                i = grp * n + slot
                window = cfg.window_for_slot(slot, long_context=long_context)
                x, cache_local[i] = tfm._apply_layer_serve(cfg, window, layer, cache_local[i],
                                                           x, positions, cur_pos, decode)
        logits = tfm.unembed(top, cfg, x)
        vocab = tfm.vocab_shard(top, cfg)
    new = []
    for i, c in enumerate(cache_local):
        new.append({k: _dtensor(v.contiguous(), _spec_of(caches[i][k]), mesh, caches[i][k].shape)
                    for k, v in c.items()})
    return logits, vocab, new


def make_sharded_prefill(cfg: ModelConfig, mesh, pspecs: dict, batch_specs: dict,
                         cspecs: tuple, *, long_context: bool = False):
    """``prefill(params, batch, caches) -> (logits, caches)`` over the mesh:
    `transformer.forward_prefill` on `place_params`' parameters, a batch of
    DTensors and `place_caches`' caches at ``cspecs``
    (``cache_specs(..., decode=False)``), which it returns filled."""
    batch_entry = batch_specs["tokens"][0]

    @torch.no_grad()
    def prefill(params: dict, batch: dict, caches: list):
        par = parallel.Parallel(mesh, batch_dims=axes_of(batch_entry))
        local = {k: _local(v) for k, v in batch.items()}
        logits, vocab, caches = _serve(
            cfg, mesh, pspecs, params, lambda top: tfm.embed_inputs(top, cfg, local),
            lambda x: torch.arange(x.shape[1], dtype=torch.int32, device=x.device), None,
            caches, par, decode=False, long_context=long_context)
        return _logits_dtensor(cfg, logits, vocab, par, batch_entry), caches

    return prefill


def to_decode_caches(caches: list, cspecs: tuple, cfg: ModelConfig, mesh) -> list:
    """Caches moved to the decode placements (``cache_specs(...,
    decode=True)``): a dim that decode splits further is cut locally, with
    nothing sent; anything else raises."""
    n = len(cfg.layer_pattern)
    out = []
    for i, c in enumerate(caches):
        layer = {}
        for k, dt in c.items():
            want = _pad(layer_spec(cspecs[i % n][k]), dt.dim())
            have = _spec_of(dt)
            if have == want:
                layer[k] = dt
                continue
            local = dt.to_local()
            for dim, (h, w) in enumerate(zip(have, want)):
                h, w = axes_of(h), axes_of(w)
                if h == w:
                    continue
                if w[:len(h)] != h:
                    raise ValueError(f"cache {k}: {have} -> {want} needs communication")
                extra = w[len(h):]
                j, m = _index(extra, mesh)
                size = local.shape[dim] // m
                local = local.narrow(dim, j * size, size)
            layer[k] = _dtensor(local.contiguous(), want, mesh, dt.shape)
        out.append(layer)
    return out


def make_sharded_decode(cfg: ModelConfig, mesh, pspecs: dict, in_specs: dict, cspecs: tuple,
                        *, long_context: bool = False):
    """``decode(params, tokens, cur_pos, caches) -> (logits, caches)`` over
    the mesh: `transformer.forward_decode` on `place_params`' parameters,
    tokens (a DTensor at ``in_specs["tokens"]``) and caches, which it first
    moves to the decode placements ``cspecs`` (`to_decode_caches`: a
    prefill's caches come at ``decode=False``'s).  Where ``cspecs`` split a
    cache's slots, each rank attends over its own and the parts merge by
    log-sum-exp."""
    batch_entry = in_specs["tokens"][0]
    seq_dims = ()
    for slot_specs in cspecs:
        if "pos" in slot_specs:
            seq_dims = axes_of(slot_specs["pos"][1])
            break

    @torch.no_grad()
    def decode(params: dict, tokens, cur_pos: int, caches: list):
        par = parallel.Parallel(mesh, batch_dims=axes_of(batch_entry), seq_dims=seq_dims)
        caches = to_decode_caches(caches, cspecs, cfg, mesh)
        tok = _local(tokens)
        logits, vocab, caches = _serve(
            cfg, mesh, pspecs, params, lambda top: tfm.embed_inputs(top, cfg, {"tokens": tok}),
            lambda x: None, int(cur_pos), caches, par, decode=True, long_context=long_context)
        return _logits_dtensor(cfg, logits, vocab, par, batch_entry), caches

    return decode

