"""Token sampling for the serving engine.

Mirrors `repro/serving/sampling.py`, with a `torch.Generator` in place of a
`jax.random` key: greedy decoding gives the reference's tokens (the first
maximum, as ``jnp.argmax``), sampling at a temperature gives the same
distribution but other draws.
"""
from __future__ import annotations

import torch

__all__ = ["sample"]


def sample(
    generator: torch.Generator | None,
    logits: torch.Tensor,  # (B, V) or (B, K, V)
    *,
    temperature: float = 1.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Returns sampled int64 token ids with the batch shape of ``logits[..., 0]``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)  # the first maximum on ties
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1])
