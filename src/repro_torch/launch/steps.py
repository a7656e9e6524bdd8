"""Step builders shared by the dry-run and the launchers.

Mirrors `repro/launch/steps.py`.  Each builder returns ``(step, abstract
args, specs)``: the step, its arguments as meta tensors (shapes and
dtypes, no memory) and the sharding plan of those arguments
(`repro_torch.sharding.specs`), as the reference's return its jitted step,
its ``ShapeDtypeStruct`` arguments and its ``PartitionSpec`` trees.

The reference's steps run over any mesh, since GSPMD partitions the
jitted program.  PyTorch has no such compiler.  On a one-rank mesh a
step runs on plain tensors on the mesh's device (on the card through the
port's CUDA kernels): the train step on ``{"params": Transformer, "opt":
moments}``, prefill and decode on a `Transformer` and per-layer caches.
On a mesh of more ranks it runs the same layers on each rank's shards
(`repro_torch.sharding.execute`): its arguments are DTensors placed at
the specs the builder returns (`execute.place_train_state`,
`place_params`, `place_tree`, `place_caches`), and its results too.

The reference's ``analysis`` flag unrolls the depth scan for XLA's cost
analysis.  The port runs its layers in a Python loop, so there is nothing
to unroll: ``analysis`` only forces one micro-batch in the train step, as
in the reference, and changes nothing else.
"""
from __future__ import annotations

from typing import Any

import torch

from ..interop import param_leaves, plain_shapes
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..sharding import execute
from ..sharding import specs as sh
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_loop import make_train_step
from .mesh import mesh_device

__all__ = [
    "SHAPES",
    "abstract_batch",
    "make_train_setup",
    "make_prefill_setup",
    "make_decode_setup",
    "needs_fsdp",
    "mesh_axes",
]

#: The assigned input shapes: name -> (seq_len, global_batch, step kind).
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

def needs_fsdp(cfg: ModelConfig, *, model_axis: int = 16,
               budget_bytes: float = 8e9) -> bool:
    """True when bf16 params per chip exceed budget under pure tensor
    parallelism — then weights also shard over ``data`` (FSDP)."""
    return cfg.param_count() * 2 / model_axis > budget_bytes


def abstract_batch(cfg: ModelConfig, seq_len: int, batch: int,
                   *, with_labels: bool) -> dict:
    """Meta tensors for one input batch of the config's modality."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    toks = (batch, seq_len, cfg.num_codebooks) if cfg.num_codebooks > 1 else (
        batch, seq_len)
    out: dict[str, Any] = {"tokens": meta(toks, torch.int32)}
    if cfg.modality == "vision_prefix":
        text = seq_len - cfg.vision_tokens
        assert text > 0, "seq shorter than vision prefix"
        out["tokens"] = meta((batch, text), torch.int32)
        out["vision_embeds"] = meta((batch, cfg.vision_tokens, cfg.d_model), torch.float32)
    if with_labels:
        out["labels"] = meta(tuple(out["tokens"].shape), torch.int32)
    return out


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _param_shardings(cfg, mesh, model, *, fsdp: bool) -> dict:
    axes = mesh_axes(mesh)
    pspecs = sh.param_specs(model, cfg, model_axis=axes["model"])
    if fsdp:
        pspecs = sh.apply_fsdp(pspecs, plain_shapes(cfg, model), fsdp_axes=("data",),
                               axis_size=axes["data"])
    return pspecs


def _on_one_rank(mesh, step, device_of):
    """``step`` as the builder returns it for a one-rank mesh: run with its
    tensors on the mesh's device."""
    def run(*args, **kwargs):
        dev, want = device_of(*args), mesh_device(mesh)
        if dev.type != want.type:
            raise ValueError(f"the step's tensors are on {dev}, the mesh on {want}")
        return step(*args, **kwargs)

    run.__doc__ = step.__doc__
    return run


# ---- train ---------------------------------------------------------------------


def make_train_setup(cfg: ModelConfig, mesh, *, multi_pod: bool,
                     batch: int, seq_len: int,
                     opt_cfg: AdamWConfig | None = None,
                     analysis: bool = False,
                     microbatches: int = 1):
    """Returns (train step, (abstract state, abstract batch), (state specs,
    batch specs)).

    The step is `train_loop.make_train_step`'s with remat on:
    ``step(state, batch, events=None) -> (state, metrics)``, the state
    ``{"params": Transformer, "opt": moments}`` updated in place.
    ``microbatches=M`` accumulates the gradients of M sequential
    micro-batches (float32 sums divided by M, the loss and its parts
    averaged), then applies one AdamW update.  ``analysis`` forces M = 1,
    as in the reference, and does nothing else here.
    """
    opt_cfg = opt_cfg or AdamWConfig()
    if analysis:
        microbatches = 1
    microbatches = max(1, microbatches)
    assert batch % microbatches == 0, (batch, microbatches)

    params = tfm.init_params(cfg, device="meta")
    state_shape = {"params": params, "opt": init_opt_state(param_leaves(cfg, params))}
    pspecs = _param_shardings(cfg, mesh, params, fsdp=True)
    # Optimizer moments follow the (fsdp'd) parameter sharding; the step
    # counter is replicated.
    state_specs = {
        "params": pspecs,
        "opt": {"mu": pspecs, "nu": pspecs, "step": ()},
    }
    batch_specs = sh.train_batch_specs(cfg, multi_pod=multi_pod)
    abstract = abstract_batch(cfg, seq_len, batch, with_labels=True)
    # vision_prefix: spec dict must cover exactly the batch keys.
    batch_specs = {k: batch_specs[k] for k in abstract}

    if mesh.size() > 1:
        run = execute.make_sharded_train_step(cfg, opt_cfg, mesh, state_specs, batch_specs,
                                              remat=True, microbatches=microbatches)
    else:
        step = make_train_step(cfg, opt_cfg, remat=True, microbatches=microbatches)
        run = _on_one_rank(mesh, step, lambda state, *_, **__: state["params"].embed.device)
    return run, (state_shape, abstract), (state_specs, batch_specs)


# ---- prefill ---------------------------------------------------------------------


def make_prefill_setup(cfg: ModelConfig, mesh, *, multi_pod: bool,
                       batch: int, seq_len: int, analysis: bool = False):
    """Returns (prefill step, (abstract params, abstract batch, abstract
    caches), (param specs, batch specs, cache specs)).  The step is
    ``step(params, batch, caches) -> (logits, caches)``,
    `transformer.forward_prefill`; the caches are one per layer
    (`transformer.init_serve_cache`), the specs one per pattern slot over
    the stacked caches."""
    axes = mesh_axes(mesh)
    fsdp = needs_fsdp(cfg, model_axis=axes["model"])
    params_shape = tfm.init_params(cfg, device="meta")
    pspecs = _param_shardings(cfg, mesh, params_shape, fsdp=fsdp)
    cache_shape = tfm.init_serve_cache(cfg, batch, seq_len, device="meta")
    cspecs = sh.cache_specs(
        cfg, batch, multi_pod=multi_pod, n_data=axes["data"],
        model_axis=axes["model"], context_parallel=False,
    )
    abstract = abstract_batch(cfg, seq_len, batch, with_labels=False)
    batch_specs = {
        k: v for k, v in sh.train_batch_specs(cfg, multi_pod=multi_pod).items()
        if k in abstract
    }

    def prefill_step(params, batch_, caches):
        return tfm.forward_prefill(params, cfg, batch_, caches)

    if mesh.size() > 1:
        run = execute.make_sharded_prefill(cfg, mesh, pspecs, batch_specs, cspecs)
    else:
        run = _on_one_rank(mesh, prefill_step, lambda params, *_: params.embed.device)
    return run, (params_shape, abstract, cache_shape), (pspecs, batch_specs, cspecs)


# ---- decode ----------------------------------------------------------------------


def make_decode_setup(cfg: ModelConfig, mesh, *, multi_pod: bool,
                      batch: int, cache_len: int, long_context: bool,
                      analysis: bool = False):
    """Returns (decode step, (abstract params, abstract tokens, abstract
    position, abstract caches), (param specs, input specs, cache specs)).
    The step is ``step(params, tokens, cur_pos, caches) -> (logits,
    caches)``, `transformer.forward_decode` (``cur_pos`` a host int)."""
    axes = mesh_axes(mesh)
    fsdp = needs_fsdp(cfg, model_axis=axes["model"])
    total_dp = axes["data"] * axes.get("pod", 1)
    # batch too small to shard -> context-parallel the cache sequence dim.
    context_parallel = batch % total_dp != 0

    params_shape = tfm.init_params(cfg, device="meta")
    pspecs = _param_shardings(cfg, mesh, params_shape, fsdp=fsdp)
    cache_shape = tfm.init_serve_cache(cfg, batch, cache_len, long_context=long_context,
                                       device="meta")
    cspecs = sh.cache_specs(
        cfg, batch, multi_pod=multi_pod, n_data=axes["data"],
        model_axis=axes["model"], context_parallel=context_parallel,
        decode=True,
    )
    tok_shape = (batch, 1, cfg.num_codebooks) if cfg.num_codebooks > 1 else (
        batch, 1)
    abstract_tokens = torch.empty(tok_shape, dtype=torch.int32, device="meta")
    abstract_pos = torch.empty((), dtype=torch.int32, device="meta")
    in_specs = sh.decode_input_specs(
        cfg, batch, multi_pod=multi_pod, n_data=axes["data"]
    )

    def serve_step(params, tokens, cur_pos, caches):
        return tfm.forward_decode(params, cfg, tokens, cur_pos, caches,
                                  long_context=long_context)

    if mesh.size() > 1:
        run = execute.make_sharded_decode(cfg, mesh, pspecs, in_specs, cspecs,
                                          long_context=long_context)
    else:
        run = _on_one_rank(mesh, serve_step, lambda params, *_: params.embed.device)
    return (
        run,
        (params_shape, abstract_tokens, abstract_pos, cache_shape),
        (pspecs, in_specs, cspecs),
    )
