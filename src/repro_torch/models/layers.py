"""Shared neural-net layers: norms, rope, MLPs, embeddings (plain torch).

Mirrors `repro/models/layers.py`.  Weights are stored as the reference
stores them, ``(d_in, d_out)``, so ``x @ w`` is the same product.  Random
initialisation draws from a `torch.Generator` instead of a `jax.random`
key: the shapes and scales are the reference's, the numbers are not (the
parity tests carry the reference's weights across with
`repro_torch.interop.params_from_plain`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import parallel

__all__ = [
    "rms_norm",
    "init_rms_norm",
    "rope",
    "apply_rope",
    "MLP",
    "mlp",
    "init_mlp",
    "init_dense",
    "draw_device",
    "softcap",
    "activation_fn",
]


def draw_device(gen: torch.Generator | None) -> torch.device:
    """The device the init functions draw on: ``gen``'s, or the meta device
    when there is no generator (a meta init: shapes and dtypes, no draws)."""
    return torch.device("meta") if gen is None else gen.device


def init_dense(gen: torch.Generator | None, d_in: int, d_out: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """``N(0, 1/d_in)`` weights of shape (d_in, d_out), drawn in float32 on
    the generator's device and cast to ``dtype`` (on meta, without a
    generator: see `draw_device`)."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=draw_device(gen))
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def init_rms_norm(d: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf.
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":  # nemotron-4: squared ReLU
        return _relu2
    raise ValueError(f"unknown activation {name}")


# ---- rotary position embeddings ---------------------------------------------


def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for given integer positions, shape (..., head_dim/2)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim/2)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]  # broadcast over heads axis
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---- MLP ---------------------------------------------------------------------


class MLP(nn.Module):
    """``up``, ``down`` and, when gated, ``gate``: the reference's mlp dict."""

    def __init__(self, up: torch.Tensor, down: torch.Tensor,
                 gate: torch.Tensor | None = None) -> None:
        super().__init__()
        self.up = nn.Parameter(up, requires_grad=False)
        self.down = nn.Parameter(down, requires_grad=False)
        self.gate = None if gate is None else nn.Parameter(gate, requires_grad=False)


def init_mlp(gen: torch.Generator, d: int, ff: int, gated: bool,
             dtype=torch.bfloat16) -> MLP:
    up = init_dense(gen, d, ff, dtype)
    down = init_dense(gen, ff, d, dtype)
    gate = init_dense(gen, d, ff, dtype) if gated else None
    return MLP(up, down, gate)


def mlp(params: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Under a sharded step whose ``down`` is row-sharded (``params.tp``),
    this rank's columns of ``up``/``gate`` and rows of ``down``, the
    partial sums added over ``model``."""
    par = parallel.current() if getattr(params, "tp", False) else None
    if par is not None:
        x = parallel.enter(x, par.group(par.model))
    act = activation_fn(activation)
    up = x @ params.up
    if params.gate is not None:
        up = act(x @ params.gate) * up
    else:
        up = act(up)
    if par is not None:
        return parallel.row_parallel(up, params.down, par.group(par.model))
    return up @ params.down
