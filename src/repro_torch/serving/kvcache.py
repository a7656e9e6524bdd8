"""Cache bookkeeping utilities for the serving engine.

Mirrors `repro/serving/kvcache.py`.  The per-layer cache *contents* live in
`repro_torch.models` (attention ring buffers, of ``"attention"`` and
``"moe"`` layers alike, SSD and RG-LRU states and conv tails, see
``transformer.init_serve_cache``); the port keeps one cache
dict per layer where the reference stacks them over layer groups, and the
byte counts are the same.  This module adds the engine-level view: sizing, byte
accounting, and slot-reset for continuous batching.
"""
from __future__ import annotations

from ..models import transformer as tfm
from ..models.config import ModelConfig

__all__ = ["cache_bytes", "make_cache", "reset_slot", "slot_kv_bytes"]


def make_cache(cfg: ModelConfig, batch: int, cache_len: int,
               *, long_context: bool = False, device=None) -> list[dict]:
    return tfm.init_serve_cache(cfg, batch, cache_len, long_context=long_context,
                                device=device)


def cache_bytes(cache: list[dict]) -> int:
    return int(sum(t.numel() * t.element_size() for layer in cache for t in layer.values()))


def slot_kv_bytes(cfg: ModelConfig, cache_len: int,
                  *, long_context: bool = False) -> int:
    """Per-request cache footprint: one batch row, position buffers included.

    The reference allocates the arrays to count them; the port counts the
    same shapes on the meta device, which allocates nothing.
    """
    return cache_bytes(make_cache(cfg, 1, cache_len, long_context=long_context,
                                  device="meta"))


def reset_slot(cache: list[dict], slot: int) -> list[dict]:
    """Zero one batch row (a finished request's slot) across every layer, in
    place: every batch-indexed leaf (``k``, ``v``, ``ssm``, ``conv``,
    ``h``).  Position buffers are shared across the batch (synchronized
    decode), so ``pos`` is left alone."""
    for layer in cache:
        for key, leaf in layer.items():
            if key != "pos":
                leaf[slot].zero_()
    return cache
