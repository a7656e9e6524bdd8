"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

Mirrors `repro/models/rglru.py`.  The recurrent unit is a diagonal gated
linear recurrence:

    r_t = sigmoid(W_r x_t + b_r)          (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence on the hand-written kernel
`repro_torch.kernels.rglru.rglru_scan` (on the CPU, its plain torch loop),
where the reference uses an ``associative_scan``; training
(`rglru_train`) runs it through `rglru_scan_train`, whose backward is the
hand-written kernel of ``csrc/rglru_bwd.cu`` on the card; decode is the
O(1) step in plain torch.  The block wraps the unit in the Griffin
layout: dual input projections, a short causal conv on the recurrent
branch, GeLU (the tanh form, as ``jax.nn.gelu``) gating on the linear
branch, and an output projection.  The gates run in float32; ``b_r``,
``b_i`` and ``lam`` are float32 whatever the model's type
(`FLOAT32_PARAMS`): in bf16 ``lam``'s 0.999 would round to 1.0, clip at
1e-6 and change the decay entirely.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru import rglru_scan, rglru_scan_train
from .layers import activation_fn, init_dense

__all__ = [
    "FLOAT32_PARAMS",
    "RGLRU",
    "init_rglru_block",
    "rglru_train",
    "rglru_init_cache",
    "rglru_prefill",
    "rglru_decode",
]

_C = 8.0

#: Gate projections are block-diagonal with _NB blocks (Griffin §2.4).
_NB = 16

#: Leaves kept in float32 in a model of any type (`repro/models/rglru.py:59-63`).
FLOAT32_PARAMS = ("b_r", "b_i", "lam")

_gelu = activation_fn("gelu")


class RGLRU(nn.Module):
    """The reference's ``rec`` dict: ``in_x``, ``in_gate``, ``conv_w``,
    ``conv_b``, ``w_r``, ``b_r``, ``w_i``, ``b_i``, ``lam``, ``out``."""

    NAMES = ("in_x", "in_gate", "conv_w", "conv_b", "w_r", "b_r", "w_i", "b_i", "lam", "out")

    def __init__(self, **tensors: torch.Tensor) -> None:
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"RGLRU takes {self.NAMES}, got {tuple(tensors)}")
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(tensors[name], requires_grad=False))


def init_rglru_block(gen: torch.Generator, d_model: int, width: int, conv_width: int,
                     dtype=torch.bfloat16) -> RGLRU:
    if width % _NB:
        raise ValueError(f"lru width {width} is not a multiple of {_NB}")
    blk = width // _NB
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                * scale).to(dtype)

    return RGLRU(
        in_x=init_dense(gen, d_model, width, dtype),
        in_gate=init_dense(gen, d_model, width, dtype),
        conv_w=normal((conv_width, width), 0.1),
        conv_b=torch.zeros((width,), dtype=dtype, device=dev),
        w_r=normal((_NB, blk, blk), 1.0 / math.sqrt(blk)),
        b_r=torch.zeros((width,), dtype=torch.float32, device=dev),
        w_i=normal((_NB, blk, blk), 1.0 / math.sqrt(blk)),
        b_i=torch.zeros((width,), dtype=torch.float32, device=dev),
        # Lambda parameterized so a^c stays in (0.9, 0.999) at r=1 (paper init).
        lam=torch.linspace(0.9, 0.999, width, dtype=torch.float32, device=dev),
        out=init_dense(gen, width, d_model, dtype),
    )


def _block_matmul(x, w):
    """x: (..., W) x block-diagonal w (_NB, W/_NB, W/_NB) -> (..., W)."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (_NB, shape[-1] // _NB))
    return torch.einsum("...ni,nij->...nj", xb, w).reshape(shape)


def _softplus_inv(y):
    # lam stores the target decay directly; map to softplus pre-activation.
    return torch.log(torch.expm1(torch.clamp(-torch.log(y) / _C, min=1e-6)))


def _gates(params: RGLRU, x):
    """x: (..., width) -> (a, b) recurrence coefficients, float32."""
    xf = x.float()
    r = torch.sigmoid(_block_matmul(xf, params.w_r.float()) + params.b_r)
    i = torch.sigmoid(_block_matmul(xf, params.w_i.float()) + params.b_i)
    log_lam = F.softplus(_softplus_inv(params.lam))
    a = torch.exp(-_C * log_lam * r)
    b = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (i * xf)
    return a, b


def _conv(params: RGLRU, x, tail):
    """Depthwise causal conv along time, no activation; returns (out, new tail)."""
    width = params.conv_w.shape[0]
    s = x.shape[1]
    padded = torch.cat([tail, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + padded[:, i:i + s].float() * params.conv_w[i].float()
    out = (out + params.conv_b.float()).to(x.dtype)
    return out, padded[:, padded.shape[1] - (width - 1):]


def _branches(params: RGLRU, x, tail):
    """(a, b) of the recurrent branch, its new conv tail, and the GeLU gate."""
    gate = _gelu((x @ params.in_gate).float())
    xb, new_tail = _conv(params, x @ params.in_x, tail)
    a, b = _gates(params, xb)
    return a, b, new_tail, gate


def rglru_train(params: RGLRU, x):
    """The block on x (B,S,d) from a zero state and conv tail,
    differentiable in x and the parameters (reference: `rglru_train`): the
    gates and the conv stay plain torch ops under autograd, as the
    reference computes them outside any Pallas kernel."""
    width = params.conv_w.shape[0]
    tail = torch.zeros((x.shape[0], width - 1, params.in_x.shape[1]), dtype=x.dtype,
                       device=x.device)
    a, b, _, gate = _branches(params, x, tail)
    h = rglru_scan_train(a, b)  # (B,S,W) float32
    return (h * gate).to(x.dtype) @ params.out


def rglru_init_cache(batch: int, width: int, conv_width: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype, device=device),
    }


def rglru_prefill(params: RGLRU, x, cache: dict):
    """x (B,S,d) from the state in ``cache``; returns (out, cache) with the
    cache's entries replaced by the last position's state and the conv tail."""
    a, b, new_tail, gate = _branches(params, x, cache["conv"])
    h = rglru_scan(a, b, cache["h"])  # (B,S,W) float32
    cache["h"], cache["conv"] = h[:, -1].clone(), new_tail
    return (h * gate).to(x.dtype) @ params.out, cache


def rglru_decode(params: RGLRU, x, cache: dict):
    """x: (B,1,d)."""
    a, b, new_tail, gate = _branches(params, x, cache["conv"])
    h = a[:, 0] * cache["h"] + b[:, 0]
    cache["h"], cache["conv"] = h, new_tail
    return (h[:, None, :] * gate).to(x.dtype) @ params.out, cache
