"""Decoder-only model assembled from a ModelConfig: serving and training.

Mirrors `repro/models/transformer.py` for every config: ``"attention"``
blocks (gemma2-2b, internlm2-1.8b, yi-34b, nemotron, llava's backbone,
musicgen's backbone), ``"moe"`` blocks, attention plus routed experts
(qwen3-moe-30b-a3b, grok-1-314b), ``"ssd"`` blocks (mamba2-1.3b) and
``"recurrent"`` blocks beside local attention (recurrentgemma-9b).  The
reference stacks parameters and caches over layer groups and scans them
with ``lax.scan``; PyTorch runs eagerly, so the port keeps one `Block`
module and one cache per layer and loops over them: layer ``i`` is the
reference's group ``i // len(pattern)``, slot ``i % len(pattern)``.

Entry points:
  * ``init_params(cfg, *, seed, device)   -> Transformer``
  * ``forward_train(params, cfg, batch, *, remat) -> (logits, aux)``
  * ``loss_fn(params, cfg, batch, *, remat) -> (total, parts)``
  * ``init_serve_cache(cfg, batch, cache_len, *, device) -> [cache per layer]``
  * ``forward_prefill(params, cfg, batch, caches) -> (logits, caches)``
  * ``forward_decode(params, cfg, tokens, cur_pos, caches) -> (logits, caches)``

Parameters are created frozen (``requires_grad=False``), as serving wants
them; training (`repro_torch.train`) turns ``requires_grad`` on.
Training runs every kind of layer, each of whose kernels has a backward:
flash attention's (`kernels.attention.FlashAttentionFn`), the SSD scan's
(`kernels.ssd.SsdScanFn`), the RG-LRU scan's (`kernels.rglru.RglruScanFn`)
and the grouped GEMM's (`kernels.grouped_gemm.GroupedGemmFn`, the
``"moe"`` layers' experts).  The reference's
``unroll`` and ``act_spec`` are XLA knobs (analysis unrolling, a mesh
sharding constraint) with no counterpart here.  Under a sharded step
(`repro_torch.sharding.parallel.current()`), `embed_inputs` and `unembed`
work on this rank's run of the vocabulary; `repro_torch.sharding.execute`
runs the layer functions below on each rank's shards.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..sharding import parallel
from . import attention as attn_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import MLP, draw_device, init_dense, init_mlp, init_rms_norm, mlp, rms_norm

__all__ = [
    "Block",
    "Transformer",
    "init_params",
    "embed_inputs",
    "unembed",
    "forward_train",
    "loss_fn",
    "init_serve_cache",
    "forward_prefill",
    "forward_decode",
]

#: The attribute of a `Block` that holds each kind's mixer, named as the
#: reference's parameter dict names it.
_MIXER = {"attention": "attn", "moe": "attn", "ssd": "mamba", "recurrent": "rec"}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _frozen(t: torch.Tensor | None) -> nn.Parameter | None:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer of ``kind``: ``"attention"`` holds ``ln1``, ``attn``,
    ``ln2`` and ``mlp``; ``"moe"`` holds ``ln1``, ``attn``, ``ln2`` and
    ``moe``; ``"ssd"`` holds ``ln1`` and ``mamba``; ``"recurrent"`` holds
    ``ln1``, ``rec``, ``ln2`` and ``mlp``."""

    def __init__(self, kind: str, ln1: torch.Tensor, mixer: nn.Module,
                 ln2: torch.Tensor | None = None, mlp_: MLP | None = None,
                 moe: moe_lib.MoE | None = None) -> None:
        super().__init__()
        self.kind = kind
        self.ln1 = _frozen(ln1)
        setattr(self, _MIXER[kind], mixer)
        self.ln2 = _frozen(ln2)
        self.mlp = mlp_
        self.moe = moe


class Transformer(nn.Module):
    """``embed`` (K, V, d), ``final_norm``, optional ``unembed`` and
    ``vision_proj``, and one `Block` per layer in ``blocks``."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: list[Block], unembed: torch.Tensor | None = None,
                 vision_proj: torch.Tensor | None = None) -> None:
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.unembed = _frozen(unembed)
        self.vision_proj = _frozen(vision_proj)
        self.blocks = nn.ModuleList(blocks)


# ---- init --------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Transformer:
    """Random weights with the reference's shapes and scales, drawn from a
    `torch.Generator` seeded with ``seed`` on ``device`` (default: the card).
    ``device="meta"`` gives the shapes and dtypes with no memory and no
    generator (the dry-run's parameters)."""
    dt = torch_dtype(cfg)
    if str(device) == "meta":
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    embed_shape = (cfg.num_codebooks, cfg.vocab_size, cfg.d_model)
    embed = (torch.randn(embed_shape, generator=gen, dtype=torch.float32, device=dev)
             * 0.02).to(dt)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = init_dense(gen, cfg.d_model, cfg.num_codebooks * cfg.vocab_size, dt)
    vision_proj = None
    if cfg.modality == "vision_prefix":
        vision_proj = init_dense(gen, cfg.d_model, cfg.d_model, dt)
    blocks = [_init_block(gen, cfg, cfg.layer_pattern[i % len(cfg.layer_pattern)], dt)
              for i in range(cfg.num_layers)]
    return Transformer(embed, init_rms_norm(cfg.d_model, dt, dev), blocks,
                       unembed=unembed, vision_proj=vision_proj)


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dt: torch.dtype) -> Block:
    d, dev = cfg.d_model, draw_device(gen)
    ln1 = init_rms_norm(d, dt, dev)
    if kind == "ssd":
        return Block(kind, ln1, ssm_lib.init_mamba2(
            gen, d, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv_width, dt))
    if kind == "recurrent":
        mixer = rglru_lib.init_rglru_block(gen, d, cfg.resolved_lru_width,
                                           cfg.rglru_conv_width, dt)
    else:
        mixer = attn_lib.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.resolved_head_dim, cfg.qk_norm, dt)
    if kind == "moe":
        return Block(kind, ln1, mixer, init_rms_norm(d, dt, dev), moe=moe_lib.init_moe(
            gen, d, cfg.d_ff, cfg.num_experts, cfg.gated_mlp, dt))
    return Block(kind, ln1, mixer, init_rms_norm(d, dt, dev),
                 init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dt))


# ---- embeddings / logits ------------------------------------------------------


def embed_inputs(params: Transformer, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B,S) or (B,S,K)} [+ "vision_embeds": (B,Nv,D)]."""
    tokens = batch["tokens"]
    par = parallel.current()
    lookup = _embed_lookup
    if par is not None and params.embed.shape[1] < cfg.vocab_size:
        lookup = functools.partial(_sharded_lookup, par)
    if cfg.num_codebooks > 1:
        # (B,S,K) EnCodec token lattice: sum codebook embeddings.
        if tokens.dim() != 3:
            raise ValueError(f"{cfg.name} takes (B, S, K) tokens, got {tuple(tokens.shape)}")
        x = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=params.embed.dtype,
                        device=tokens.device)
        for k in range(cfg.num_codebooks):
            x = x + lookup(params.embed[k], tokens[..., k])
    else:
        tok = tokens if tokens.dim() == 2 else tokens[..., 0]
        x = lookup(params.embed[0], tok)
    if cfg.modality == "vision_prefix" and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(x.dtype)
        if par is not None and params.vision_proj.shape[1] < cfg.d_model:
            # Column-parallel: each rank's columns, gathered for every rank alike.
            pg = par.group(par.model)
            vis = parallel.gather_alike(parallel.enter(vis, pg) @ params.vision_proj, -1, pg)
        else:
            vis = vis @ params.vision_proj
        x = torch.cat([vis, x], dim=1)
    if cfg.embed_scale_by_sqrt_dim:
        # The reference casts the scale to the activation type first.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def _embed_lookup(table: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return table[tok]


def _sharded_lookup(par, table: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-sharded ``table`` (this rank's run of the vocabulary):
    each token's row from the rank that holds it, zero elsewhere, summed
    over ``model``."""
    rows = table.shape[0]
    local = tok.long() - par.model_rank * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return parallel.leave(x, par.group(par.model))


def _unembed_split(params: Transformer, cfg: ModelConfig) -> bool:
    """Whether a sharded step holds this rank's columns of the unembedding
    (the tied embedding's vocabulary, or the untied matrix's columns)."""
    if parallel.current() is None:
        return False
    if cfg.tie_embeddings:
        return params.embed.shape[1] < cfg.vocab_size
    return params.unembed.shape[1] < cfg.num_codebooks * cfg.vocab_size


def vocab_shard(params: Transformer, cfg: ModelConfig):
    """``(first id, ids)`` of the vocabulary whose logits `unembed` gives
    on this rank: all of it unless a sharded step splits the (one
    codebook's or tied) unembedding over ``model``."""
    if not _unembed_split(params, cfg) or (not cfg.tie_embeddings and cfg.num_codebooks > 1):
        return 0, cfg.vocab_size
    cols = (params.embed if cfg.tie_embeddings else params.unembed).shape[1]
    return parallel.current().model_rank * cols, cols


def unembed(params: Transformer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits for every position: (B,S,V), or (B,S,K,V) with K codebooks.

    Under a sharded step whose (un)embedding is split over ``model``, the
    logits of this rank's run of the vocabulary (`vocab_shard`); with
    several codebooks, whose columns do not split by codebook, every
    rank's columns gathered."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    split = _unembed_split(params, cfg)
    if split:
        pg = parallel.current().group(parallel.current().model)
        x = parallel.enter(x, pg)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,kvd->bskv", x, params.embed)
    else:
        logits = x @ params.unembed
        if split and cfg.num_codebooks > 1:
            logits = parallel.gather_alike(logits, -1, pg)
        logits = logits.reshape(x.shape[0], x.shape[1], cfg.num_codebooks, -1)
    logits = logits.float()
    if cfg.final_logit_softcap is not None:
        # cap * tanh(logits / cap), in place where nothing keeps the logits
        # for a backward: at a 256k vocabulary the logits of a 4 x
        # 2048-token prefill are 8.4 GB.
        cap = cfg.final_logit_softcap
        if logits.requires_grad:
            logits = cap * torch.tanh(logits / cap)
        else:
            logits.div_(cap).tanh_().mul_(cap)
    if cfg.num_codebooks == 1:
        logits = logits[:, :, 0, :]
    return logits


# ---- training -----------------------------------------------------------------

def _moe_ffn(cfg: ModelConfig, layer: Block, h: torch.Tensor, dropless: bool = False,
             global_aux: bool = True):
    """A ``"moe"`` layer's experts on ``h``, as the config routes them:
    (output, router aux loss)."""
    return moe_lib.moe_ffn(
        layer.moe, h, num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
        capacity_factor=cfg.moe_capacity_factor, activation=cfg.mlp_activation,
        dropless=dropless, dispatch_groups=cfg.moe_dispatch_groups, global_aux=global_aux)


def _apply_slot_train(cfg: ModelConfig, kind: str, window: int | None, layer: Block,
                      x: torch.Tensor, positions: torch.Tensor) -> tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """Residual application of an ``"attention"``, ``"moe"``, ``"ssd"`` or
    ``"recurrent"`` block (training / no cache), as the reference's
    `_apply_slot_train`. Returns (x, aux): a ``"moe"`` block's router aux
    loss, zero for the others."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    if kind == "ssd":
        h = ssm_lib.mamba2_train(
            layer.mamba, h, d_inner=cfg.ssm_d_inner, d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)
        return x + h, aux
    if kind == "recurrent":
        h = rglru_lib.rglru_train(layer.rec, h)
        x = x + h
        h = rms_norm(x, layer.ln2, cfg.norm_eps)
        h = mlp(layer.mlp, h, cfg.mlp_activation)
        return x + h, aux
    h = attn_lib.attention_train(
        layer.attn, h, positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=window, logit_softcap=cfg.attn_logit_softcap,
        norm_eps=cfg.norm_eps,
    )
    x = x + h
    h = rms_norm(x, layer.ln2, cfg.norm_eps)
    if kind == "moe":
        h, aux = _moe_ffn(cfg, layer, h)
    else:
        h = mlp(layer.mlp, h, cfg.mlp_activation)
    return x + h, aux


def _apply_group_train(cfg: ModelConfig, layers: list, positions: torch.Tensor,
                       x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer group (the pattern's slots, in order): (x, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for slot, layer in enumerate(layers):
        x, a = _apply_slot_train(cfg, cfg.layer_pattern[slot], cfg.window_for_slot(slot), layer,
                                 x, positions)
        aux = aux + a
    return x, aux


def forward_train(params: Transformer, cfg: ModelConfig, batch: dict, *,
                  remat: bool = False):
    """Returns (logits (B,S,[K,]V) float32, aux losses dict).

    ``batch`` holds tensors on the model's device.  ``remat=True``
    activation-checkpoints each layer group (`torch.utils.checkpoint`,
    non-reentrant), as the reference's ``jax.checkpoint`` does: the
    backward recomputes within a group and keeps the residual stream
    between groups.
    """
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n = len(cfg.layer_pattern)
    for grp in range(cfg.num_groups):
        group = functools.partial(_apply_group_train, cfg,
                                  list(params.blocks[grp * n:(grp + 1) * n]), positions)
        if remat:
            x, a = checkpoint(group, x, use_reentrant=False)
        else:
            x, a = group(x)
        aux = aux + a
    logits = unembed(params, cfg, x)
    return logits, {"router_aux": aux / max(cfg.num_layers, 1)}


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (+ MoE aux). batch needs "tokens" and "labels"."""
    logits, aux = forward_train(params, cfg, batch, remat=remat)
    labels = batch["labels"].long()
    if cfg.num_codebooks > 1 and labels.dim() != 3:
        raise ValueError(f"{cfg.name} takes (B, S, K) labels, got {tuple(labels.shape)}")
    if cfg.modality == "vision_prefix" and "vision_embeds" in batch:
        # Logits cover [vision prefix + text]; score text positions only.
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    total = loss + cfg.router_aux_loss_coef * aux["router_aux"]
    return total, {"ce": loss, **aux}


# ---- serving ------------------------------------------------------------------


def init_serve_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                     long_context: bool = False, device=None) -> list[dict]:
    """One cache per layer: an ``"attention"`` or ``"moe"`` layer's K/V
    ring (windowed layers hold ``min(cache_len, window)`` slots), an
    ``"ssd"`` layer's state and conv tail, a ``"recurrent"`` layer's state
    and conv tail.  ``device="meta"`` gives shapes and dtypes without memory."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    dt = torch_dtype(cfg)
    caches = []
    for i in range(cfg.num_layers):
        slot = i % len(cfg.layer_pattern)
        kind = cfg.layer_pattern[slot]
        if kind == "ssd":
            caches.append(ssm_lib.mamba2_init_cache(batch, cfg.ssm_d_inner, cfg.ssm_state,
                                                    cfg.ssm_head_dim, cfg.ssm_conv_width, dt,
                                                    dev))
        elif kind == "recurrent":
            caches.append(rglru_lib.rglru_init_cache(batch, cfg.resolved_lru_width,
                                                     cfg.rglru_conv_width, dt, dev))
        else:
            window = cfg.window_for_slot(slot, long_context=long_context)
            eff = cache_len if window is None else min(cache_len, window)
            caches.append(attn_lib.init_cache(batch, eff, cfg.num_kv_heads,
                                              cfg.resolved_head_dim, dt, dev))
    return caches


def _apply_layer_serve(cfg: ModelConfig, window: int | None, layer: Block,
                       cache: dict, x: torch.Tensor, positions: torch.Tensor | None,
                       cur_pos: int | None, decode: bool):
    """Returns (x, the layer's cache, updated in place)."""
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    if layer.kind == "ssd":
        kw = dict(d_inner=cfg.ssm_d_inner, d_state=cfg.ssm_state,
                  head_dim=cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
        if decode:
            h, cache = ssm_lib.mamba2_decode(layer.mamba, h, cache, **kw)
        else:
            h, cache = ssm_lib.mamba2_prefill(layer.mamba, h, cache, chunk=cfg.ssm_chunk, **kw)
        return x + h, cache
    if layer.kind == "recurrent":
        step = rglru_lib.rglru_decode if decode else rglru_lib.rglru_prefill
        h, cache = step(layer.rec, h, cache)
    else:
        kw = dict(
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=window, logit_softcap=cfg.attn_logit_softcap,
            norm_eps=cfg.norm_eps,
        )
        if decode:
            h, cache = attn_lib.attention_decode(layer.attn, h, cur_pos, cache, **kw)
        else:
            h, cache = attn_lib.prefill_into_cache(layer.attn, h, positions, cache, **kw)
    x = x + h
    h = rms_norm(x, layer.ln2, cfg.norm_eps)
    if layer.kind == "moe":
        # decode: capacity = T, no drops; serving drops the aux loss
        h, _ = _moe_ffn(cfg, layer, h, dropless=decode, global_aux=False)
    else:
        h = mlp(layer.mlp, h, cfg.mlp_activation)
    return x + h, cache


def _forward_serve(params: Transformer, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor | None, cur_pos: int | None,
                   caches: list, decode: bool, long_context: bool):
    if len(caches) != cfg.num_layers:
        raise ValueError(f"{len(caches)} caches for {cfg.num_layers} layers")
    for i, layer in enumerate(params.blocks):
        window = cfg.window_for_slot(i % len(cfg.layer_pattern), long_context=long_context)
        x, caches[i] = _apply_layer_serve(cfg, window, layer, caches[i], x, positions,
                                          cur_pos, decode)
    return unembed(params, cfg, x), caches


@torch.no_grad()
def forward_prefill(params: Transformer, cfg: ModelConfig, batch: dict, caches: list,
                    *, long_context: bool = False):
    """Logits of every prompt position, and the caches filled (in place)."""
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return _forward_serve(params, cfg, x, positions, None, caches,
                          decode=False, long_context=long_context)


@torch.no_grad()
def forward_decode(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                   cur_pos: int, caches: list, *, long_context: bool = False):
    """tokens: (B,1) or (B,1,K); cur_pos: the host-int position of the token."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    return _forward_serve(params, cfg, x, None, int(cur_pos), caches,
                          decode=True, long_context=long_context)
