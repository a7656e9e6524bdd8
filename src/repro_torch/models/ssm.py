"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Mirrors `repro/models/ssm.py`.  Prefill runs the SSD chunked scan on the
hand-written kernel `repro_torch.kernels.ssd.ssd_scan` (on the CPU, its
plain torch version); the reference runs the same algorithm as XLA-level
einsums (`ssd_chunked`, kept here as the CPU-side function with the
reference's chunk rule).  Training (`mamba2_train`) runs the scan through
`ssd_scan_train`, at the reference's chunk rule, whose backward is the
hand-written kernel of ``csrc/ssd_bwd.cu`` on the card.  Decode is the
O(1) recurrent update on the (H, P, N) state, in plain torch as in the
reference: no TPU kernel computes it.

Layout conventions: x (B,S,H,P) with H = d_inner/head_dim heads of size P;
B/C (B,S,N) shared across heads (ngroups=1); A scalar per head (negative,
parameterized as -exp(A_log)); dt per (B,S,H) via softplus.  ``A_log``,
``D`` and ``dt_bias`` are float32 whatever the model's type, as in the
reference (`FLOAT32_PARAMS`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd import ssd_scan, ssd_scan_plain, ssd_scan_train
from .layers import init_dense, init_rms_norm, rms_norm

__all__ = [
    "FLOAT32_PARAMS",
    "Mamba2",
    "init_mamba2",
    "mamba2_train",
    "mamba2_init_cache",
    "mamba2_prefill",
    "mamba2_decode",
    "reference_chunk",
    "ssd_chunked",
    "ssd_decode_step",
]

#: Leaves kept in float32 in a model of any type (`repro/models/ssm.py:151-153`).
FLOAT32_PARAMS = ("A_log", "D", "dt_bias")


# ---- core SSD math -----------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """The reference's `ssd_chunked`: (y (B,S,H,P), final state (B,H,P,N)).

    Its chunk rule is `reference_chunk`'s; the arithmetic is
    `ssd_scan_plain`'s, in float32.
    """
    return ssd_scan_plain(x, dt, A, Bm, Cm, h0, chunk=reference_chunk(x.shape[1], chunk))


def reference_chunk(s: int, chunk: int) -> int:
    """The reference's chunk for S positions: ``min(chunk, S)``, and one
    chunk of S when S is not a multiple of that."""
    q = min(chunk, s)
    return s if s % q else q


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One recurrent step. h (B,H,P,N) float32, x (B,H,P), dt (B,H), A (H,),
    Bm and Cm (B,N).  Returns (y (B,H,P), new state)."""
    decay = torch.exp(dt * A[None, :])  # (B,H)
    dbx = torch.einsum("bh,bhp,bn->bhpn", dt, x.float(), Bm.float())
    h_new = h * decay[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float())
    return y.to(x.dtype), h_new


# ---- full Mamba-2 block (proj + conv + SSD + gate) ---------------------------


class Mamba2(nn.Module):
    """The reference's ``mamba`` dict: ``in_z``, ``in_x``, ``in_bc``,
    ``in_dt``, ``conv_x_w``/``conv_x_b``, ``conv_bc_w``/``conv_bc_b``,
    ``A_log``, ``D``, ``dt_bias``, ``norm``, ``out_proj``."""

    NAMES = ("in_z", "in_x", "in_bc", "in_dt", "conv_x_w", "conv_x_b", "conv_bc_w",
             "conv_bc_b", "A_log", "D", "dt_bias", "norm", "out_proj")

    def __init__(self, **tensors: torch.Tensor) -> None:
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"Mamba2 takes {self.NAMES}, got {tuple(tensors)}")
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(tensors[name], requires_grad=False))


def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
                head_dim: int, conv_width: int, dtype=torch.bfloat16) -> Mamba2:
    nheads = d_inner // head_dim
    dev = gen.device

    def conv_w(channels):
        return (torch.randn((conv_width, channels), generator=gen, dtype=torch.float32,
                            device=dev) * 0.1).to(dtype)

    # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 init),
    # from the reference's own numpy draw.
    dt_init = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1), nheads))
    return Mamba2(
        in_z=init_dense(gen, d_model, d_inner, dtype),
        in_x=init_dense(gen, d_model, d_inner, dtype),
        in_bc=init_dense(gen, d_model, 2 * d_state, dtype),
        in_dt=init_dense(gen, d_model, nheads, dtype),
        conv_x_w=conv_w(d_inner),
        conv_x_b=torch.zeros((d_inner,), dtype=dtype, device=dev),
        conv_bc_w=conv_w(2 * d_state),
        conv_bc_b=torch.zeros((2 * d_state,), dtype=dtype, device=dev),
        A_log=torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32, device=dev)),
        D=torch.ones((nheads,), dtype=torch.float32, device=dev),
        dt_bias=torch.from_numpy(np.log(np.expm1(dt_init)).astype(np.float32)).to(dev),
        norm=init_rms_norm(d_inner, dtype, dev),
        out_proj=init_dense(gen, d_inner, d_model, dtype),
    )


def _causal_conv(xbc, w, b, tail):
    """Depthwise causal conv along time, then silu. xbc (B,S,C), tail
    (B, w-1, C); returns (out, new tail)."""
    width = w.shape[0]
    s = xbc.shape[1]
    padded = torch.cat([tail, xbc], dim=1)  # (B, S+w-1, C)
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + padded[:, i:i + s].float() * w[i].float()
    out = F.silu(out + b.float()).to(xbc.dtype)
    return out, padded[:, padded.shape[1] - (width - 1):]


def _ssd_io(params: Mamba2, x, d_inner, d_state, conv_tail):
    """conv_tail: the (B, w-1, d_inner + 2*d_state) combined tail.  Bm and
    Cm are column slices of the conv output, not copies."""
    z = x @ params.in_z
    xs = x @ params.in_x
    bc = x @ params.in_bc
    dt = x @ params.in_dt
    tail_x, tail_bc = conv_tail[..., :d_inner], conv_tail[..., d_inner:]
    xs, new_tail_x = _causal_conv(xs, params.conv_x_w, params.conv_x_b, tail_x)
    bc, new_tail_bc = _causal_conv(bc, params.conv_bc_w, params.conv_bc_b, tail_bc)
    Bm, Cm = bc[..., :d_state], bc[..., d_state:]
    dt = F.softplus(dt.float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    new_tail = torch.cat([new_tail_x, new_tail_bc], dim=-1)
    return z, xs, Bm, Cm, dt, A, new_tail


def _gate_and_project(params: Mamba2, y, xh, z, x_dtype, norm_eps):
    """(y + D x) gated by silu(z), normed, projected; y and xh share a
    shape whose last two dims are (H, P)."""
    y = y.float() + params.D[:, None] * xh.float()
    y = y.reshape(z.shape).to(x_dtype)
    y = y * F.silu(z.float()).to(x_dtype)
    return rms_norm(y, params.norm, norm_eps) @ params.out_proj


def mamba2_train(params: Mamba2, x, *, d_inner: int, d_state: int, head_dim: int,
                 chunk: int, norm_eps: float):
    """The block on x (B,S,d_model) from a zero state and conv tail,
    differentiable in x and the parameters (reference: `mamba2_train`).  The
    scan takes the reference's chunk rule (`reference_chunk`)."""
    b, s, _ = x.shape
    width = params.conv_x_w.shape[0]
    tail = torch.zeros((b, width - 1, d_inner + 2 * d_state), dtype=x.dtype, device=x.device)
    z, xs, Bm, Cm, dt, A, _ = _ssd_io(params, x, d_inner, d_state, tail)
    xh = xs.reshape(b, s, d_inner // head_dim, head_dim)
    y = ssd_scan_train(xh, dt, A, Bm, Cm, chunk=reference_chunk(s, chunk))
    return _gate_and_project(params, y, xh, z, x.dtype, norm_eps)


def mamba2_init_cache(batch: int, d_inner: int, d_state: int, head_dim: int,
                      conv_width: int, dtype=torch.bfloat16, device=None) -> dict:
    nheads = d_inner // head_dim
    return {
        "ssm": torch.zeros((batch, nheads, head_dim, d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_inner + 2 * d_state), dtype=dtype,
                            device=device),
    }


def mamba2_prefill(params: Mamba2, x, cache: dict, *, d_inner: int, d_state: int,
                   head_dim: int, chunk: int, norm_eps: float):
    """x (B,S,d_model) from the state in ``cache``; returns (out, cache)
    with the cache's entries replaced by the new state and conv tail."""
    b, s, _ = x.shape
    z, xs, Bm, Cm, dt, A, new_tail = _ssd_io(params, x, d_inner, d_state, cache["conv"])
    xh = xs.reshape(b, s, d_inner // head_dim, head_dim)
    y, h = ssd_scan(xh, dt, A, Bm, Cm, cache["ssm"], chunk=chunk)
    cache["ssm"], cache["conv"] = h, new_tail
    return _gate_and_project(params, y, xh, z, x.dtype, norm_eps), cache


def mamba2_decode(params: Mamba2, x, cache: dict, *, d_inner: int, d_state: int,
                  head_dim: int, norm_eps: float):
    """x: (B, 1, d_model)."""
    b = x.shape[0]
    z, xs, Bm, Cm, dt, A, new_tail = _ssd_io(params, x, d_inner, d_state, cache["conv"])
    xh = xs.reshape(b, d_inner // head_dim, head_dim)
    y, h = ssd_decode_step(cache["ssm"], xh, dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    cache["ssm"], cache["conv"] = h, new_tail
    return _gate_and_project(params, y, xh, z, x.dtype, norm_eps), cache
