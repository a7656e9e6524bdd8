"""Architecture registry: one module per assigned architecture.

A copy of `repro/configs` (plain data).  ``get_config(arch_id)`` returns
the full production config; ``smoke_variant(cfg)`` derives the reduced
CPU-testable variant (<=2 pattern repeats, d_model<=512, <=4 experts) used
by smoke tests.  The port's model runs every config.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import (
    gemma2_2b,
    musicgen_large,
    qwen3_moe_30b_a3b,
    mamba2_1_3b,
    yi_34b,
    internlm2_1_8b,
    nemotron_4_15b,
    llava_next_mistral_7b,
    recurrentgemma_9b,
    grok_1_314b,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma2_2b,
        musicgen_large,
        qwen3_moe_30b_a3b,
        mamba2_1_3b,
        yi_34b,
        internlm2_1_8b,
        nemotron_4_15b,
        llava_next_mistral_7b,
        recurrentgemma_9b,
        grok_1_314b,
    )
}

ARCH_IDS = tuple(sorted(REGISTRY))

#: Default per-analyzed-frame context depth (tokens) when a model serves as
#: a camera-frame analysis program: the prefill each frame's caption/VQA
#: pass runs.  Omitted archs (audio gen, 314B-scale) are not sensible frame
#: analyzers / fit no catalog type.
DEFAULT_TOKENS_PER_FRAME: dict[str, int] = {
    "gemma2-2b": 2048,
    "internlm2-1.8b": 512,
    "mamba2-1.3b": 1024,
    "llava-next-mistral-7b": 2048,
    "recurrentgemma-9b": 1024,
    "nemotron-4-15b": 2048,
}


def default_tokens_per_frame(arch_id: str) -> int:
    try:
        return DEFAULT_TOKENS_PER_FRAME[arch_id]
    except KeyError:
        raise KeyError(
            f"{arch_id!r} has no frame-analysis deployment default; known: "
            f"{tuple(sorted(DEFAULT_TOKENS_PER_FRAME))}"
        ) from None


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}") from None


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 1-2 groups, d_model<=512, <=4 experts.

    It keeps at most 4 query heads and ``min(kv, 4)`` KV heads, so the smoke
    variants of gemma2-2b and internlm2-1.8b have no GQA; tests that want
    it replace ``num_kv_heads``.
    """
    pattern = cfg.layer_pattern
    groups = min(cfg.num_groups, 2 if len(pattern) == 1 else 1)
    d_model = min(cfg.d_model, 256)
    heads = max(1, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=groups * len(pattern),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if cfg.num_heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        lru_width=min(cfg.resolved_lru_width, d_model) if cfg.lru_width else None,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_chunk=16,
        vision_tokens=min(cfg.vision_tokens, 16),
    )
    if cfg.num_experts:
        updates.update(num_experts=min(cfg.num_experts, 4),
                       experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.window_pattern is not None:
        updates["window_pattern"] = tuple(
            (min(w, 16) if w else None) for w in cfg.window_pattern
        )
    if cfg.long_context_window:
        updates["long_context_window"] = 16
    return dataclasses.replace(cfg, **updates)
