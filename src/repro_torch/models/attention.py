"""GQA attention: prefill on the flash kernel, cached decode on flash-decode.

Mirrors `repro/models/attention.py`.  Where the reference runs a blocked
online-softmax loop in jnp (`attention_train`) and a full-cache softmax
(`attention_decode`), the port calls the hand-written kernels
`repro_torch.kernels.attention.flash_attention` and
`repro_torch.kernels.decode_attention.decode_attention`, which compute the
same functions with the softmax in float32 (on the CPU, their plain torch
versions).

* Grouped-query attention throughout (num_kv_heads <= num_heads).
* KV caches tag each slot with its absolute position (``pos`` buffer,
  -1 = empty). Keys are stored rope-applied at their absolute position, so
  sliding-window ring buffers need no relative-position rematerialization.
  Masks derive from the position buffer: ``0 <= pos_slot <= cur`` and, for
  windowed layers, ``pos_slot > cur - window``.
* The port updates a cache in place (the reference returns a new one);
  `prefill_into_cache` and `attention_decode` return it all the same.
* A decode step's position ``cur_pos`` is a host integer: the slot it
  writes and the kernel's mask both take it without a device sync.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.attention import flash_attention
from ..kernels.decode_attention import decode_attention
from .layers import apply_rope, init_dense, init_rms_norm, rms_norm, rope

__all__ = [
    "Attention",
    "init_attention",
    "attention_train",
    "init_cache",
    "prefill_into_cache",
    "attention_decode",
]


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and, with qk-norm, ``q_norm``/``k_norm``."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None) -> None:
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("q_norm", q_norm), ("k_norm", k_norm)):
            setattr(self, name, None if t is None else nn.Parameter(t, requires_grad=False))


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qk_norm: bool,
                   dtype=torch.bfloat16) -> Attention:
    wq = init_dense(gen, d_model, num_heads * head_dim, dtype)
    wk = init_dense(gen, d_model, num_kv_heads * head_dim, dtype)
    wv = init_dense(gen, d_model, num_kv_heads * head_dim, dtype)
    wo = init_dense(gen, num_heads * head_dim, d_model, dtype)
    norms = ((init_rms_norm(head_dim, dtype, gen.device),
              init_rms_norm(head_dim, dtype, gen.device)) if qk_norm else (None, None))
    return Attention(wq, wk, wv, wo, *norms)


def _project_qkv(params: Attention, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                 rope_theta: float, norm_eps: float):
    b, s, _ = x.shape
    q = (x @ params.wq).reshape(b, s, num_heads, head_dim)
    k = (x @ params.wk).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ params.wv).reshape(b, s, num_kv_heads, head_dim)
    if params.q_norm is not None:
        q = rms_norm(q, params.q_norm, norm_eps)
        k = rms_norm(k, params.k_norm, norm_eps)
    sin, cos = rope(positions, head_dim, rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    return q, k, v


def _attend_prefill(params: Attention, x: torch.Tensor, positions: torch.Tensor, *,
                    num_heads: int, num_kv_heads: int, head_dim: int,
                    rope_theta: float, window: int | None,
                    logit_softcap: float | None, norm_eps: float):
    """(output before ``wo``, k, v) of causal self-attention over x."""
    b, s, _ = x.shape
    if tuple(positions.shape) != (s,):
        raise ValueError(f"attention expects positions of shape ({s},)")
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, norm_eps)
    out = flash_attention(q, k, v, window=window, logit_softcap=logit_softcap)
    return out.reshape(b, s, num_heads * head_dim), k, v


def attention_train(
    params: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int | None,
    logit_softcap: float | None,
    norm_eps: float,
) -> torch.Tensor:
    """Causal self-attention over a full sequence (training & prefill).

    ``positions`` are ``arange(S)`` plus any offset: the rope angles read
    them, and the causal and window masks, which depend on differences of
    positions only, are the kernel's own over ``0..S-1``.
    """
    out, _, _ = _attend_prefill(
        params, x, positions, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, rope_theta=rope_theta, window=window,
        logit_softcap=logit_softcap, norm_eps=norm_eps,
    )
    return out @ params.wo


# ---- serving: cache init / prefill / decode ---------------------------------


def init_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, cache_len, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        # Absolute position stored in each slot; -1 = empty.
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    }


def prefill_into_cache(
    params: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: dict,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int | None,
    logit_softcap: float | None,
    norm_eps: float,
) -> tuple[torch.Tensor, dict]:
    """Run full-sequence attention AND populate the cache (last `L` slots).

    ``positions`` must be ``arange(S)``, as `forward_prefill` passes them:
    the ring layout below places position ``p`` in slot ``p % L``.
    """
    b, s, _ = x.shape
    out, k, v = _attend_prefill(
        params, x, positions, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, rope_theta=rope_theta, window=window,
        logit_softcap=logit_softcap, norm_eps=norm_eps,
    )
    cache_len = cache["k"].shape[1]
    if cache_len >= s:
        # Left-aligned fill.
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"][:s] = positions.to(torch.int32)
    else:
        # Keep only the trailing window (ring layout via slot = pos % L).
        slots = positions[s - cache_len:] % cache_len
        cache["k"][:, slots] = k[:, s - cache_len:]
        cache["v"][:, slots] = v[:, s - cache_len:]
        cache["pos"][slots] = positions[s - cache_len:].to(torch.int32)
    return out @ params.wo, cache


def attention_decode(
    params: Attention,
    x: torch.Tensor,
    cur_pos: int,
    cache: dict,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int | None,
    logit_softcap: float | None,
    norm_eps: float,
) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d), cur_pos the host-int position of x."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one token, got {s}")
    positions = torch.full((1,), cur_pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, norm_eps)
    cache_len = cache["k"].shape[1]
    slot = cur_pos % cache_len
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = cur_pos
    rep = num_heads // num_kv_heads
    out = decode_attention(
        q.reshape(b, num_kv_heads, rep, head_dim), cache["k"], cache["v"],
        cache["pos"], cur_pos, window=window, logit_softcap=logit_softcap,
    )
    return out.reshape(b, 1, num_heads * head_dim) @ params.wo, cache
