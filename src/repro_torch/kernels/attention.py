"""Causal flash attention (GQA, sliding window, logit softcap) — the prefill kernel.

Replaces the TPU kernel `repro/kernels/attention.py:flash_attention`
(body `_kernel`): for every query position ``i`` of ``0..S-1`` and query
head ``h``, attend over keys ``j`` of KV head ``h // (H / KV)`` with
``j <= i`` (and ``j > i - window`` when a window is given)::

    s = (q_i · k_j) / sqrt(D);  s = cap·tanh(s / cap);  masked s = -2e38
    o_i = softmax_j(s) @ v

with the softmax and both products in float32 whatever the input type, and
the output in q's type.  The mask constant is -2e38, not -inf, and the
normaliser is ``max(l, 1e-37)``, both as in the TPU kernel.

Implementations:

* `flash_attention_plain` — plain torch: full score matrix, masks,
  softmax (the function of `repro/kernels/ref.py:attention_ref`, in
  float32 inside);
* two CUDA kernels in ``csrc/flash_attention.cu``, picked by dtype alone
  (`_variant`):

  - ``"wgmma"`` (bf16, every served prefill): one CTA per (batch, head,
    128-query block), two warpgroups on the tensor cores (wgmma) fed by
    TMA, P V with p split into two bf16 halves so that the product keeps
    a float32 p's accuracy;
  - ``"simt"`` (float32): one CTA per (batch, head, 32-query block),
    float32 FMAs (TF32 would break the float32 limit).

`flash_attention` dispatches by device: CPU tensors go to the plain
version, CUDA tensors launch the kernel (or raise; nothing falls back to
another kernel).
"""
from __future__ import annotations

import ctypes

import torch

from ..device import KernelError

__all__ = ["LAUNCHES", "LAUNCHES_BY_VARIANT", "flash_attention", "flash_attention_plain"]

#: Number of CUDA kernel launches made by `flash_attention` in this process.
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"wgmma": 0, "simt": 0}

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)  # the head_dims the CUDA kernel is built for
_DTYPES = (torch.bfloat16, torch.float32)


def _variant(dtype: torch.dtype) -> str:
    """The kernel for inputs of ``dtype``: ``"wgmma"`` for bf16 (TMA takes
    every head_dim the kernels are built for, since a row of H * D bf16 is
    a multiple of 16 bytes), ``"simt"`` for float32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def flash_attention_plain(q, k, v, *, window=None, logit_softcap=None):
    """Plain torch causal attention at positions ``0..S-1``; any device."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qr = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qr, k.float()) * (d ** -0.5)
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _check_inputs(q, k, v, window, logit_softcap) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q must be (B, S, H, D), k/v (B, S, KV, D)")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if s < 1 or kv < 1 or h % kv:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, s, kv, d):
            raise ValueError(
                f"flash_attention: {name} must be {(b, s, kv, d)}, got {tuple(t.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {logit_softcap}")


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def _kernel_fn(dtype: torch.dtype):
    """The C function that launches ``_variant(dtype)``'s kernel."""
    from ._build import load_library

    lib = load_library("flash_attention")
    fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 else lib.flash_attention_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, window=None, logit_softcap=None):
    """Causal attention ``(B, S, H, D)`` from q ``(B, S, H, D)`` and k/v
    ``(B, S, KV, D)``, dispatched by device.

    CPU tensors run `flash_attention_plain`; CUDA tensors launch the kernel
    `_variant` picks on the current stream, and anything it does not take
    raises: another dtype or device, mismatched shapes, a non-contiguous or
    unaligned tensor, a head_dim other than 64, 128 or 256.
    """
    _check_inputs(q, k, v, window, logit_softcap)
    return _dispatch(q, k, v, window, logit_softcap)


def _dispatch(q, k, v, window, logit_softcap):
    """`flash_attention` after its checks: the plain version or the kernel
    of q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, logit_softcap=logit_softcap)
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS} on CUDA")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    variant = _variant(q.dtype)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], d, d ** -0.5,
            0.0 if logit_softcap is None else float(logit_softcap),
            0 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"flash_attention {variant} kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return out
