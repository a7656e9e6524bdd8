"""Sharding rules for params, activations and caches on the production meshes.

Mirrors `repro/sharding/specs.py`.  A spec is a plain tuple with one entry
per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
axis names that shard the dim together, outer axis first.  These are the
entries of the reference's ``PartitionSpec`` (a one-name tuple is written
as the bare name, as ``PartitionSpec`` normalizes it), so a spec compares
equal to ``tuple(P)`` of the reference's.  `placements` turns a spec into
DTensor placements over a `DeviceMesh`.

The plan:

* ``model`` axis — tensor parallel: attention q/k/v column-sharded, o
  row-sharded; MLP up/gate column-, down row-sharded; vocab/embedding
  sharded; MoE experts expert-parallel when E % axis == 0 (qwen3:
  128/16=8), else tensor-parallel inside each expert (grok: 8 experts,
  d_ff 32768/16); Mamba z/x projections and RG-LRU width column-sharded
  with block-local gates.
* ``data`` (x ``pod``) axis — batch sharding for train/prefill/decode; for
  long_500k (batch=1) the KV cache *sequence* dim shards over ``data``
  (context-parallel decode) while recurrent states shard nothing.

Rules are keyed on the reference's leaf paths (`repro_torch.interop
.param_leaves`), and specs are over the reference's stacked leaves: a
block leaf carries a leading layer-group axis, and `apply_fsdp` counts
and may shard it (mamba2-1.3b's 48 groups over 16 data ranks), as the
reference does.
"""
from __future__ import annotations

import re

import numpy as np

from ..interop import plain_shapes
from ..models.config import ModelConfig

__all__ = [
    "Spec",
    "param_specs",
    "apply_fsdp",
    "train_batch_specs",
    "decode_input_specs",
    "cache_specs",
    "data_axes",
    "placements",
]

Spec = tuple  # one entry per dim: None, an axis name, or a tuple of axis names


def _entry(axes) -> str | tuple | None:
    """One spec entry from a sequence of axis names, as ``PartitionSpec``
    writes it: None for none, the name for one, the tuple for more."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def data_axes(multi_pod: bool) -> tuple:
    """The composite data-parallel mesh axes."""
    return ("pod", "data") if multi_pod else ("data",)


# ---- parameters ---------------------------------------------------------------


def _param_rule(path: str, ndim: int, cfg: ModelConfig, model_axis: int) -> Spec:
    """The spec of a parameter leaf (stacked leaves included).

    ``path`` is the leaf's path with ``blocks/[i]/`` written ``blocks/``;
    a stacked block leaf carries a leading group axis (never sharded here).
    """
    expert_parallel = cfg.num_experts > 0 and cfg.num_experts % model_axis == 0

    def stacked(*spec):
        # Prepend None for the group axis if this leaf is depth-stacked.
        return (None, *spec) if "blocks/" in path else tuple(spec)

    # --- embeddings / head ---
    if path == "embed":  # (K, V, D)
        return (None, "model", None)
    if path == "unembed":  # (D, K*V)
        return (None, "model")
    if path == "vision_proj":
        return (None, "model")
    if path == "final_norm":
        return (None,)

    # --- attention ---
    if re.search(r"attn/w[qkv]$", path):  # (D, H*hd) column parallel
        return stacked(None, "model")
    if path.endswith("attn/wo"):  # (H*hd, D) row parallel
        return stacked("model", None)
    if re.search(r"attn/[qk]_norm$", path):
        return stacked(None)

    # --- dense MLP ---
    if re.search(r"mlp/(up|gate)$", path):
        return stacked(None, "model")
    if path.endswith("mlp/down"):
        return stacked("model", None)

    # --- MoE ---
    if path.endswith("moe/router"):  # (D, E)
        return stacked(None, None)
    if re.search(r"moe/(up|gate)$", path):  # (E, D, F)
        return stacked("model", None, None) if expert_parallel else stacked(
            None, None, "model")
    if path.endswith("moe/down"):  # (E, F, D)
        return stacked("model", None, None) if expert_parallel else stacked(
            None, "model", None)

    # --- Mamba-2 ---
    if re.search(r"mamba/in_[zx]$", path):  # (D, d_inner) column parallel
        return stacked(None, "model")
    if re.search(r"mamba/(in_bc|in_dt|conv_bc_w|conv_bc_b|A_log|D|dt_bias)$", path):
        return stacked(*([None] * (ndim - (1 if "blocks/" in path else 0))))
    if path.endswith("mamba/conv_x_w"):  # (width, d_inner)
        return stacked(None, "model")
    if path.endswith("mamba/conv_x_b"):
        return stacked("model")
    if path.endswith("mamba/norm"):
        return stacked("model")
    if path.endswith("mamba/out_proj"):  # (d_inner, D) row parallel
        return stacked("model", None)

    # --- RG-LRU ---
    if re.search(r"rec/in_(x|gate)$", path):
        return stacked(None, "model")
    if re.search(r"rec/w_[ri]$", path):  # (_NB, blk, blk) block-diagonal
        return stacked("model", None, None)
    if re.search(r"rec/(b_[ri]|lam|conv_w|conv_b)$", path):
        if path.endswith("conv_w"):
            return stacked(None, "model")
        return stacked("model")
    if path.endswith("rec/out"):  # (W, D) row parallel
        return stacked("model", None)

    # --- norms & defaults ---
    if re.search(r"ln[12]$", path):
        return stacked(None)
    # Fallback: replicate.
    n_extra = ndim - (1 if "blocks/" in path else 0)
    return stacked(*([None] * n_extra))


def _check_divisible(spec: Spec, shape, model_axis: int) -> Spec:
    """``spec`` over ``shape``'s dims, with "model" stripped where the dim
    does not divide by ``model_axis``."""
    return tuple(None if ax == "model" and dim % model_axis else ax
                 for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def param_specs(model, cfg: ModelConfig, *, model_axis: int) -> dict:
    """``{path: spec}`` for the reference's parameter leaves of ``model``
    (a `Transformer`, on any device, meta included), each over the
    stacked leaf's shape (`repro_torch.interop.plain_shapes`)."""
    specs = {}
    for path, shape in plain_shapes(cfg, model).items():
        norm = re.sub(r"blocks/\[\d+\]/", "blocks/", path)
        spec = _param_rule(norm, len(shape), cfg, model_axis)
        # Guard: never shard a dim that isn't divisible by the axis size.
        specs[path] = _check_divisible(spec, shape, model_axis)
    return specs


def apply_fsdp(specs: dict, shapes: dict, *, fsdp_axes=("data",),
               axis_size: int = 16, min_elements: int = 1 << 16) -> dict:
    """ZeRO/FSDP-style extra sharding: on each leaf of at least
    ``min_elements`` elements, shard the biggest still-replicated dim over
    ``fsdp_axes`` when divisible.  ``shapes`` is ``{path: shape}`` of the
    stacked leaves (`repro_torch.interop.plain_shapes`), so a block leaf's
    count and its candidate dims include its group axis.  Applied to both
    params and optimizer state for the train steps."""
    def one(spec: Spec, shape) -> Spec:
        shape = tuple(shape)
        if np.prod(shape) < min_elements:
            return spec
        entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
        # Largest still-replicated dim, the first of equals.
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if entries[i] is None and shape[i] % axis_size == 0:
                entries[i] = _entry(fsdp_axes)
                break
        return tuple(entries)

    return {path: one(spec, shapes[path]) for path, spec in specs.items()}


# ---- inputs --------------------------------------------------------------------


def train_batch_specs(cfg: ModelConfig, *, multi_pod: bool) -> dict:
    dp = _entry(data_axes(multi_pod))
    specs = {"tokens": (dp, None), "labels": (dp, None)}
    if cfg.num_codebooks > 1:
        specs = {"tokens": (dp, None, None), "labels": (dp, None, None)}
    if cfg.modality == "vision_prefix":
        specs["vision_embeds"] = (dp, None, None)
    return specs


def decode_input_specs(cfg: ModelConfig, batch: int, *, multi_pod: bool,
                       n_data: int) -> dict:
    dp = _entry(data_axes(multi_pod))
    shard_batch = batch % (n_data * (2 if multi_pod else 1)) == 0
    bspec = dp if shard_batch else None
    tok = (bspec, None, None) if cfg.num_codebooks > 1 else (bspec, None)
    return {"tokens": tok, "cur_pos": ()}


def cache_specs(cfg: ModelConfig, batch: int, *, multi_pod: bool,
                n_data: int, model_axis: int, context_parallel: bool,
                decode: bool = False) -> tuple:
    """Per-slot cache specs over the reference's stacked caches: slot
    ``s``'s entries stack the caches of layers ``s, s + n, s + 2n, ...``
    (n the pattern's length) of `transformer.init_serve_cache`.

    ``context_parallel=True`` (long_500k, batch too small to shard) shards
    attention cache *sequence* over ``data`` instead of batch.

    ``decode=True`` additionally shards the cache sequence over the
    ``model`` axis whenever KV heads cannot shard it (kv % model != 0):
    flash-decode-style context parallelism.
    """
    dp = data_axes(multi_pod)
    total_dp = n_data * (2 if multi_pod else 1)
    shard_batch = batch % total_dp == 0 and not context_parallel
    b = _entry(dp) if shard_batch else None
    kv_ax = "model" if cfg.num_kv_heads % model_axis == 0 else None

    specs = []
    for kind in cfg.layer_pattern:
        if kind in ("attention", "moe"):
            seq_axes = []
            if context_parallel:
                seq_axes += list(dp)
            if decode and kv_ax is None:
                seq_axes.append("model")
            seq_ax = _entry(seq_axes)
            specs.append({
                "k": (None, b, seq_ax, kv_ax, None),  # (G,B,L,KV,hd)
                "v": (None, b, seq_ax, kv_ax, None),
                "pos": (None, seq_ax),  # (G, L)
            })
        elif kind == "ssd":
            h_ax = "model" if cfg.ssm_heads % model_axis == 0 else None
            specs.append({
                "ssm": (None, b, h_ax, None, None),  # (G,B,H,P,N)
                "conv": (None, b, None, None),  # (G,B,w-1,C)
            })
        elif kind == "recurrent":
            w_ax = "model" if cfg.resolved_lru_width % model_axis == 0 else None
            specs.append({
                "h": (None, b, w_ax),  # (G,B,W)
                "conv": (None, b, None, w_ax),  # (G,B,w-1,W)
            })
        else:  # pragma: no cover
            raise ValueError(kind)
    return tuple(specs)


# ---- DTensor placements --------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a `DeviceMesh` with
    named dims): ``Shard(d)`` on each mesh dim that shards tensor dim
    ``d``, ``Replicate()`` on the others.  A composite entry shards one
    dim over several mesh dims; DTensor splits it over them in mesh order,
    so its axes must come in that order (``("pod", "data")``: pod-major,
    as JAX shards it)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        index = [names.index(ax) if ax in names else -1 for ax in axes]
        if -1 in index:
            raise ValueError(f"spec {spec}: axes {axes} not all on mesh {names}")
        if index != sorted(index):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in index:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(dim)
    return tuple(out)
