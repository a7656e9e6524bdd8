"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch.

Mirrors `repro/models/moe.py`: top-k routing over a float32 softmax,
renormalised; G dispatch groups with per-group capacity (GShard/Switch
semantics: a pair's priority is token-major, then choice order, and
dropped pairs renormalise over the surviving ones); the output a float32
weighted sum over the k choices.

The expert FFN is computed differently.  The reference scatters the
(token, choice) pairs into a ``(G, E, C, D)`` capacity buffer and runs the
experts as batched einsums.  The port sorts the kept pairs by expert and
runs ``gate``, ``up`` and ``down`` through the grouped GEMM
(`repro_torch.kernels.grouped_gemm.grouped_gemm_ragged`, the CUDA kernel
on the card), on the kept rows only; a dropped pair contributes zero, as
the reference's parked slot does.  Row for row this is the buffer's
product, up to the order of float32 sums.  No shape depends on the data,
so nothing waits on the device.

Training takes the gradient through the same path: autograd through the
router, the softmax, the top-k values, the renormalised weights and the
aux loss, the gather of the rows and the `index_copy_` that scatters them
back, and through the grouped GEMM by its `GroupedGemmFn` (the ``dx`` and
``dw`` kernels on the card).  A dropped pair gets no gradient from the
experts, as the reference's parked slot gets none.  The parameters are
created frozen, as serving wants them; training turns ``requires_grad``
on.

``router`` is float32 whatever the model's type (`FLOAT32_PARAMS`), as in
the reference (`repro/models/moe.py:50`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.grouped_gemm import grouped_gemm_ragged
from ..sharding import parallel
from .layers import activation_fn, draw_device, init_dense

__all__ = ["FLOAT32_PARAMS", "MoE", "init_moe", "moe_ffn", "router_aux_loss"]

#: Leaves kept in float32 in a model of any type.
FLOAT32_PARAMS = ("router",)


class MoE(nn.Module):
    """``router`` (d, E) float32, ``up`` and, when gated, ``gate`` (E, d,
    F), ``down`` (E, F, d): the reference's moe dict."""

    def __init__(self, router: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                 gate: torch.Tensor | None = None) -> None:
        super().__init__()
        self.router = nn.Parameter(router, requires_grad=False)
        self.up = nn.Parameter(up, requires_grad=False)
        self.down = nn.Parameter(down, requires_grad=False)
        self.gate = None if gate is None else nn.Parameter(gate, requires_grad=False)


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int, gated: bool,
             dtype=torch.bfloat16) -> MoE:
    """The reference's shapes and scales: each expert stack drawn in float32
    on the generator's device, then cast (one stack at a time, so a bf16
    model never holds float32 copies of all its experts)."""

    def expert_stack(d_in, d_out):
        w = torch.randn((num_experts, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=draw_device(gen))
        return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)

    router = init_dense(gen, d_model, num_experts, torch.float32)
    up = expert_stack(d_model, d_ff)
    down = expert_stack(d_ff, d_model)
    gate = expert_stack(d_model, d_ff) if gated else None
    return MoE(router, up, down, gate)


def _route(router_logits: torch.Tensor, k: int):
    """Top-k routing with renormalised probabilities (qwen3/mixtral style):
    ``(probs, top_p, top_i)``, the choices in descending order."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


def _slots(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Per group, each pair's rank among its expert's pairs in routing
    order (token-major, then choice): a stable argsort of the expert ids.
    flat_e (G, n) int64 -> (G, n) int64."""
    g, n = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    counts = torch.zeros((g, num_experts), dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    seg_start = counts.cumsum(1) - counts
    rank_sorted = (torch.arange(n, device=flat_e.device)[None, :]
                   - seg_start.gather(1, flat_e.gather(1, order)))
    return torch.empty_like(flat_e).scatter_(1, order, rank_sorted)


def _sort_pairs(top_i: torch.Tensor, num_experts: int, capacity: int, groups: int,
                par=None):
    """The (token, choice) pairs of ``top_i`` (T, k) in the order the
    grouped GEMM takes them: ``(keep (T·k,) bool, order (T·k,) int64,
    offsets (E + 1,) int32)``.  A pair is kept when its rank among its
    expert's pairs in its dispatch group is below ``capacity`` (`_keep`;
    ``par``, a sharded step's context, for groups cut from the global
    batch); ``order`` lists the kept pairs sorted by expert (routing order
    within an expert), then the dropped ones, and expert ``e`` owns
    positions ``offsets[e]:offsets[e + 1]`` of it."""
    flat_e = top_i.reshape(-1)  # pair p = token * k + choice
    keep = _keep(top_i, num_experts, capacity, groups, par)
    # The kept pairs sorted by expert, the dropped ones after them (key E).
    key = torch.where(keep, flat_e, num_experts)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(num_experts + 1, dtype=torch.int64, device=top_i.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    offsets = torch.cat([counts.new_zeros(1), counts[:num_experts].cumsum(0)]).to(torch.int32)
    return keep, order, offsets


def _keep(top_i: torch.Tensor, num_experts: int, capacity: int, groups: int, par=None):
    """(T·k,) bool: a pair is kept when its rank among its expert's pairs
    in its dispatch group is below ``capacity``.  Under a sharded step
    whose batch rows are split (``par.batch_shards > 1``), ``top_i`` holds
    this rank's tokens, the ``groups`` cut the global tokens, and a group
    that reaches into earlier ranks' tokens counts their pairs first."""
    flat_e = top_i.reshape(-1)
    if par is None or par.batch_shards == 1:
        return (_slots(flat_e.reshape(groups, -1), num_experts) < capacity).reshape(-1)
    n, r = par.batch_shards, par.batch_rank
    pairs = flat_e.shape[0]
    per_group = pairs * n // groups
    if pairs % per_group == 0:  # this rank's pairs are whole groups of their own
        return (_slots(flat_e.reshape(pairs // per_group, -1), num_experts)
                < capacity).reshape(-1)
    group = (r * pairs + torch.arange(pairs, device=flat_e.device)) // per_group
    key = group * num_experts + flat_e
    rank = _slots(key[None], groups * num_experts)[0]
    counts = torch.zeros(groups * num_experts, dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    every = counts[None]
    for dim in reversed(par.batch_dims):  # inner dims first: rank order is mesh order
        every = parallel.gather(every.reshape(1, -1), 0, par.group(dim)).reshape(
            -1, groups * num_experts)
    before = every[:r].sum(0)
    return rank + before[key] < capacity


def _expert_ffn(params: MoE, xs: torch.Tensor, offsets: torch.Tensor,
                activation: str) -> torch.Tensor:
    """The experts' FFN on rows sorted by expert: three grouped GEMMs."""
    act = activation_fn(activation)
    if params.gate is not None:
        h = act(grouped_gemm_ragged(xs, params.gate, offsets))
        h = h * grouped_gemm_ragged(xs, params.up, offsets)
    else:
        h = act(grouped_gemm_ragged(xs, params.up, offsets))
    return grouped_gemm_ragged(h, params.down, offsets)


def moe_ffn(params: MoE, x: torch.Tensor, *, num_experts: int, experts_per_token: int,
            capacity_factor: float, activation: str, dropless: bool = False,
            dispatch_groups: int = 1, global_aux: bool = True) -> tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """x: (B, S, D) -> (output (B, S, D), router aux loss scalar).

    ``dropless=True`` sets capacity = T (no pair is dropped), as decode
    steps do; ``dispatch_groups=G`` splits the tokens into G independent
    dispatch groups (one group when dropless or when G does not divide T).

    Under a sharded step (`parallel.current()`) whose experts are split
    over ``model`` (``params.tp``), every rank routes its tokens alike and
    runs its own experts (expert-parallel) or its own columns of every
    expert (tensor-parallel) on them; the partial outputs are summed over
    ``model``.  T, the groups and the capacity are the global batch's, as
    on one device, so the same pairs are dropped; with ``global_aux`` the
    aux loss is over the global batch too (the serving path, which drops
    it, passes False).
    """
    par = parallel.current()
    shards = 1 if par is None or dropless else par.batch_shards
    tp = par if par is not None and getattr(params, "tp", False) else None
    b, s, d = x.shape
    t = b * s
    t_all = t * shards
    k = experts_per_token
    g = 1 if dropless else max(1, dispatch_groups)
    if t_all % g:
        g = 1
    tg = t_all // g

    xf = x.reshape(t, d)
    logits = xf.float() @ params.router  # (T, E) float32
    probs, top_p, top_i = _route(logits, k)
    capacity = tg if dropless else int(
        max(1, capacity_factor * k * t_all / (num_experts * g)))

    keep, order, offsets = _sort_pairs(top_i, num_experts, capacity, g,
                                       par if shards > 1 else None)
    xe = xf if tp is None else parallel.enter(xf, tp.group(tp.model))
    if tp is not None and params.up.shape[0] < num_experts:
        # Expert-parallel: this rank's experts' segments; rows outside them come out zero.
        local = params.up.shape[0]
        offsets = offsets[tp.model_rank * local:(tp.model_rank + 1) * local + 1]
    y_sorted = _expert_ffn(params, xe[order // k], offsets, activation)
    # Back to (token, choice) order; the dropped pairs' rows are zero.
    gathered = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted).reshape(t, k, d)

    w = top_p * keep.reshape(t, k).float()
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    if tp is not None:
        w = parallel.enter(w, tp.group(tp.model))
    out = torch.einsum("tkd,tk->td", gathered.float(), w)
    if tp is not None:
        out = parallel.leave(out, tp.group(tp.model))
    if par is not None and global_aux and par.batch_shards > 1:
        aux = _global_aux(par, probs, top_i, num_experts)
    else:
        aux = router_aux_loss(probs, top_i, num_experts)
    return out.reshape(b, s, d).to(x.dtype), aux


def _global_aux(par, probs: torch.Tensor, top_i: torch.Tensor, num_experts: int):
    """`router_aux_loss` over the batch rows of every shard: the counts and
    the mean probabilities summed over the batch dims (the gradient of each
    rank's own probabilities passed through)."""
    counts = torch.zeros(num_experts, dtype=torch.float32, device=probs.device)
    flat = top_i.reshape(-1)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=probs.device))
    psum = probs.sum(dim=0)
    for dim in par.batch_dims:
        counts = parallel.all_reduce(counts, par.group(dim))
        psum = parallel.leave(psum, par.group(dim))
    f = counts / counts.sum().clamp_min(1.0)
    p = psum / (probs.shape[0] * par.batch_shards)
    return num_experts * torch.sum(f * p)


def router_aux_loss(probs: torch.Tensor, top_i: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    counts = torch.zeros(num_experts, dtype=torch.float32, device=probs.device)
    flat = top_i.reshape(-1)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=probs.device))
    f = counts / counts.sum().clamp_min(1.0)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)
