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
from ..sharding import parallel as par_lib
from .layers import apply_rope, draw_device, init_dense, init_rms_norm, rms_norm, rope

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
    norms = ((init_rms_norm(head_dim, dtype, draw_device(gen)),
              init_rms_norm(head_dim, dtype, draw_device(gen))) if qk_norm else (None, None))
    return Attention(wq, wk, wv, wo, *norms)


def _tp(params: Attention, num_heads: int, head_dim: int):
    """The running step's context when this layer's heads are split over
    ``model`` (``wo`` row-sharded), else None."""
    par = par_lib.current()
    return par if par is not None and params.wo.shape[0] < num_heads * head_dim else None


def _heads(par, t: torch.Tensor, n_heads: int, head_dim: int):
    """A projection's columns on this rank as heads: ``(t (B, S, n, hd),
    first head)``.  A rank's columns that are not whole heads are gathered
    over ``model`` into every head."""
    b, s, cols = t.shape
    if par is None or cols == n_heads * head_dim:
        return t.reshape(b, s, n_heads, head_dim), 0
    if cols % head_dim == 0:
        return t.reshape(b, s, cols // head_dim, head_dim), par.model_rank * (cols // head_dim)
    t = par_lib.gather(t, -1, par.group(par.model))
    return t.reshape(b, s, n_heads, head_dim), 0


def _project_qkv(params: Attention, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                 rope_theta: float, norm_eps: float):
    """(q, k, v, q0, k0): the projections of x and the first head of each
    of q and k (0 but under a sharded step, `_tp`, where each holds this
    rank's heads: its own columns' heads, or every head where its columns
    are not whole heads)."""
    par = _tp(params, num_heads, head_dim)
    q_norm, k_norm = params.q_norm, params.k_norm
    if par is not None:
        # Each rank's heads give their own share of x's and the norms' gradients.
        pg = par.group(par.model)
        x = par_lib.enter(x, pg)
        if q_norm is not None:
            q_norm, k_norm = par_lib.enter(q_norm, pg), par_lib.enter(k_norm, pg)
    q, q0 = _heads(par, x @ params.wq, num_heads, head_dim)
    k, k0 = _heads(par, x @ params.wk, num_kv_heads, head_dim)
    v, _ = _heads(par, x @ params.wv, num_kv_heads, head_dim)
    if q_norm is not None:
        q = rms_norm(q, q_norm, norm_eps)
        k = rms_norm(k, k_norm, norm_eps)
    sin, cos = rope(positions, head_dim, rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    return q, k, v, q0, k0


def _kv_for(q0: int, nq: int, k, v, k0: int, rep: int, dim: int):
    """The KV heads (along ``dim``) that q heads ``[q0, q0 + nq)`` read,
    from k/v holding heads ``[k0, ...)``: a slice when each of them serves
    the same number of those q heads in order, else one KV head per q head."""
    lo, hi = q0 // rep, (q0 + nq - 1) // rep + 1
    if lo < k0 or hi > k0 + k.shape[dim]:
        raise ValueError(f"q heads [{q0}, {q0 + nq}) need KV heads [{lo}, {hi}), "
                         f"this rank holds [{k0}, {k0 + k.shape[dim]})")
    if hi - lo == 1 or (q0 == lo * rep and nq == (hi - lo) * rep):
        return (k.narrow(dim, lo - k0, hi - lo).contiguous(),
                v.narrow(dim, lo - k0, hi - lo).contiguous())
    idx = torch.tensor([(q0 + j) // rep - k0 for j in range(nq)], device=k.device)
    return k.index_select(dim, idx).contiguous(), v.index_select(dim, idx).contiguous()


def _row_parallel_out(par, params: Attention, out: torch.Tensor, q0: int, head_dim: int):
    """``out`` (B, S, nq * hd), heads from ``q0``, through this rank's rows of
    ``wo``, summed over ``model``."""
    rows = params.wo.shape[0]
    start = par.model_rank * rows - q0 * head_dim
    return par_lib.row_parallel(out[..., start:start + rows], params.wo, par.group(par.model))


def _attend_prefill(params: Attention, x: torch.Tensor, positions: torch.Tensor, *,
                    num_heads: int, num_kv_heads: int, head_dim: int,
                    rope_theta: float, window: int | None,
                    logit_softcap: float | None, norm_eps: float):
    """(output before ``wo``, k, v) of causal self-attention over x."""
    b, s, _ = x.shape
    if tuple(positions.shape) != (s,):
        raise ValueError(f"attention expects positions of shape ({s},)")
    q, k, v, q0, k0 = _project_qkv(params, x, num_heads, num_kv_heads, head_dim,
                                   positions, rope_theta, norm_eps)
    # This rank's q heads over the KV heads they read (all of them on one
    # device), in the kernel.
    kq, vq = _kv_for(q0, q.shape[2], k, v, k0, num_heads // num_kv_heads, 2)
    out = flash_attention(q.contiguous(), kq, vq, window=window, logit_softcap=logit_softcap)
    return out.reshape(b, s, -1), k, v, q0


def _out_proj(params: Attention, out, q0: int, num_heads: int, head_dim: int):
    par = _tp(params, num_heads, head_dim)
    if par is None:
        return out @ params.wo
    return _row_parallel_out(par, params, out, q0, head_dim)


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
    positions only, are the kernel's own over ``0..S-1``.  Differentiable:
    with grad enabled the kernel runs under `FlashAttentionFn`, and nothing
    here writes in place.  The reference's ``block_kv`` and ``unroll`` are
    XLA-only knobs (its loop's block size, analysis unrolling) and have no
    counterpart: the kernel picks its own tiles.
    """
    out, _, _, q0 = _attend_prefill(
        params, x, positions, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, rope_theta=rope_theta, window=window,
        logit_softcap=logit_softcap, norm_eps=norm_eps,
    )
    return _out_proj(params, out, q0, num_heads, head_dim)


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
    out, k, v, q0 = _attend_prefill(
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
    return _out_proj(params, out, q0, num_heads, head_dim), cache


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
    par = par_lib.current()
    if par is not None and (par.seq_dims or _tp(params, num_heads, head_dim) is not None):
        return _decode_sharded(par, params, x, positions, cur_pos, cache, num_heads=num_heads,
                               num_kv_heads=num_kv_heads, head_dim=head_dim,
                               rope_theta=rope_theta, window=window,
                               logit_softcap=logit_softcap, norm_eps=norm_eps)
    q, k, v, _, _ = _project_qkv(params, x, num_heads, num_kv_heads, head_dim,
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


def merge_by_lse(outs: torch.Tensor, lses: torch.Tensor):
    """Softmax-weighted outputs over disjoint slot sets, merged: ``outs``
    (n, ..., D) and ``lses`` (n, ...) float32 of n parts -> (out in
    ``outs``' type, lse)."""
    m = lses.max(dim=0).values
    w = torch.exp(lses - m)
    den = w.sum(dim=0)
    out = (outs.float() * w[..., None]).sum(dim=0) / den[..., None]
    return out.to(outs.dtype), m + torch.log(den)


def _decode_sharded(par, params: Attention, x, positions, cur_pos: int, cache: dict, *,
                    num_heads, num_kv_heads, head_dim, rope_theta, window, logit_softcap,
                    norm_eps):
    """`attention_decode` in a sharded step.  The cache holds this rank's
    KV heads, and, where ``par.seq_dims`` split its slots (context
    parallelism), this rank's run of slots: the new token's slot is written
    by the rank that holds it, every rank attends over its own slots with
    the kernel, and the parts are merged by their log-sum-exp.  Nothing
    gathers the cache."""
    b = x.shape[0]
    tp = _tp(params, num_heads, head_dim)
    q, k, v, q0, k0 = _project_qkv(params, x, num_heads, num_kv_heads, head_dim,
                                   positions, rope_theta, norm_eps)
    local_len = cache["k"].shape[1]
    shards, mine = 1, 0
    for dim in par.seq_dims:
        shards, mine = shards * par.size(dim), mine * par.size(dim) + par.rank(dim)
    slot = cur_pos % (local_len * shards)
    if slot // local_len == mine:
        cache["k"][:, slot % local_len] = k[:, 0]
        cache["v"][:, slot % local_len] = v[:, 0]
        cache["pos"][slot % local_len] = cur_pos
    nkv = cache["k"].shape[2]
    rep = num_heads // num_kv_heads
    # The q heads of the cache's KV heads [k0, k0 + nkv): with every KV head
    # (their split over model left to the slots), every q head.
    nq = nkv * rep
    if q.shape[2] != nq:
        q = par_lib.gather(q, 2, tp.group(tp.model))
        q0 = 0
    qg = q[:, 0, k0 * rep - q0:k0 * rep - q0 + nq].reshape(b, nkv, rep, head_dim)
    out, lse = decode_attention(qg.contiguous(), cache["k"], cache["v"], cache["pos"], cur_pos,
                                window=window, logit_softcap=logit_softcap, return_lse=True)
    for dim in reversed(par.seq_dims):
        pg = par.group(dim)
        out, lse = merge_by_lse(par_lib.gather(out[None], 0, pg), par_lib.gather(lse[None], 0, pg))
    out = out.reshape(b, 1, nq * head_dim)
    q0 = k0 * rep
    if tp is None:
        return out @ params.wo, cache
    return _row_parallel_out(tp, params, out, q0, head_dim), cache
