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

The gradient.  When grad is enabled and q, k or v requires it,
`flash_attention` runs through `FlashAttentionFn`: its forward is the same
dispatch, asking the kernel (or the plain version) for each row's
logsumexp too (``lse``, natural log, float32 (B, H, S)), and its backward
is `flash_attention_backward`: on CUDA tensors the three passes of
``csrc/flash_attention_bwd.cu`` (D = rowsum(dO o), then dk/dv and dq), in
the variant `_variant` picks (``"wgmma"`` for bf16: tensor cores fed by
TMA, p and dS split into bf16 hi + lo; ``"simt"`` for float32), on the
CPU `flash_attention_backward_plain`, the explicit formulas (p
recomputed from ``lse``, dS = p (dP - D), times 1 - tanh^2 under a
softcap).  Under `torch.no_grad` — every serving call — nothing changes:
the kernel launches as before and writes no ``lse``.  The backward kernel
has no Pallas counterpart: the reference trains through ``jax.grad`` of
`repro/models/attention.py:attention_train`, whose function this is.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import KernelError

__all__ = ["BWD_LAUNCHES", "BWD_LAUNCHES_BY_VARIANT", "BWD_PASSES", "FlashAttentionFn",
           "LAUNCHES", "LAUNCHES_BY_VARIANT", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_plain", "flash_attention_plain"]

#: Number of CUDA kernel launches made by `flash_attention` in this process.
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"wgmma": 0, "simt": 0}
#: Number of backward calls that launched the backward kernel's passes.
BWD_LAUNCHES = 0
#: The same backward calls by variant (`_variant`).
BWD_LAUNCHES_BY_VARIANT = {"wgmma": 0, "simt": 0}
#: The backward's launches by pass.
BWD_PASSES = {"dot": 0, "dkdv": 0, "dq": 0}
#: (query rows, key rows) of the backward kernel's tiles by variant,
#: head_dim and pass, the tiles `_bwd_ranges` writes each pass's block
#: ranges for; a launch naming other tiles than the variant's ``Tiles<D>``
#: in ``csrc/flash_attention_bwd.cu`` is refused.  The ``wgmma`` passes
#: differ below D = 256: each of its two warpgroups owns 64 rows of what it
#: sums, keys in dkdv and queries in dq.
BWD_TILES = {
    "wgmma": {64: {"dkdv": (64, 128), "dq": (128, 64)},
              128: {"dkdv": (64, 128), "dq": (128, 64)},
              256: {"dkdv": (64, 64), "dq": (64, 64)}},
    "simt": {d: {"dkdv": (t, t), "dq": (t, t)} for d, t in ((64, 64), (128, 64), (256, 32))},
}
#: The backward kernel against `flash_attention_backward_plain` on the
#: same inputs, by dtype: (atol as a share of the largest |grad| of dq, dk
#: and dv, rtol).  float32 2e-5 (the two sum in other orders); bf16 one
#: bf16 ulp (both round one float32 result) plus 1e-4.
BWD_TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)  # the head_dims the CUDA kernel is built for
_DTYPES = (torch.bfloat16, torch.float32)


def _variant(dtype: torch.dtype) -> str:
    """The kernel, forward and backward, for inputs of ``dtype``: ``"wgmma"``
    for bf16 (TMA takes every head_dim the kernels are built for, since a
    row of H * D bf16 is a multiple of 16 bytes), ``"simt"`` for float32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _scores(q, k, window, logit_softcap):
    """float32 masked scores (B, KV, R, S, S) and, under a softcap, the
    tanh they were capped with (else None)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qr = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qr, k.float()) * (d ** -0.5)
    th = None
    if logit_softcap is not None:
        th = torch.tanh(scores / logit_softcap)
        scores = logit_softcap * th
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    return torch.where(mask, scores, NEG_INF), th


def flash_attention_plain(q, k, v, *, window=None, logit_softcap=None, return_lse=False):
    """Plain torch causal attention at positions ``0..S-1``; any device.
    With ``return_lse``, also each row's float32 logsumexp (B, H, S)."""
    b, s, h, d = q.shape
    scores, _ = _scores(q, k, window, logit_softcap)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p, v.float()).reshape(b, s, h, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def flash_attention_backward_plain(q, k, v, o, lse, do, *, window=None, logit_softcap=None):
    """(dq, dk, dv) of `flash_attention_plain` from the explicit formulas,
    in float32, each cast to its input's type; any device.

    p is recomputed from ``lse`` (masked entries give exactly 0), D =
    rowsum(dO o), dS = p (dP - D), times 1 - tanh^2 under a softcap; dk and
    dv sum over the query heads of each KV group.
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = d ** -0.5
    scores, th = _scores(q, k, window, logit_softcap)
    p = torch.exp(scores - lse.float().reshape(b, kv, rep, s)[..., None])
    dor = do.float().reshape(b, s, kv, rep, d)
    dp = torch.einsum("bsgrd,btgd->bgrst", dor, v.float())
    delta = (do.float() * o.float()).sum(-1).reshape(b, s, kv, rep).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    dv = torch.einsum("bgrst,bsgrd->btgd", p, dor)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, q.float().reshape(b, s, kv, rep, d)) * scale
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, k.float()).reshape(b, s, h, d) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _visible_query_blocks(kb, s, bq, bk, window):
    """``(first, end)``: the query blocks of ``bq`` rows that see any key of
    key block ``kb`` (keys ``kb*bk .. kb*bk + bk - 1``) under the causal
    mask and the window."""
    k0 = kb * bk
    i_last = s - 1
    if window is not None:
        i_last = min(i_last, min(k0 + bk, s) - 1 + window - 1)
    return k0 // bq, i_last // bq + 1


def _visible_key_blocks(qb, s, bq, bk, window):
    """``(first, end)``: the key blocks of ``bk`` keys that query block
    ``qb`` sees."""
    i0 = qb * bq
    j_first = 0 if window is None else max(0, i0 - window + 1)
    return j_first // bk, (min(i0 + bq, s) - 1) // bk + 1


def _bwd_ranges(s, bq, bk, window):
    """The block ranges the backward kernel walks at sequence ``s`` with
    tiles of ``bq`` query rows and ``bk`` keys, as int32 pairs
    ``(q_ranges, k_ranges)``: ``q_ranges[kb]`` the query blocks
    ``[first, end)`` that see key block ``kb``, ``k_ranges[qb]`` the key
    blocks query block ``qb`` sees."""
    q_ranges = [_visible_query_blocks(kb, s, bq, bk, window) for kb in range(-(-s // bk))]
    k_ranges = [_visible_key_blocks(qb, s, bq, bk, window) for qb in range(-(-s // bq))]
    return np.asarray(q_ranges, np.int32), np.asarray(k_ranges, np.int32)


@functools.lru_cache(maxsize=64)
def _bwd_ranges_on(device, s, bq, bk, window):
    """`_bwd_ranges` copied to ``device`` once per (s, tiles, window)."""
    return tuple(torch.from_numpy(r).to(device) for r in _bwd_ranges(s, bq, bk, window))


def _check_inputs(q, k, v, window, logit_softcap) -> None:
    if q.device.type not in ("cpu", "cuda", "meta"):
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


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
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
    unaligned tensor, a head_dim other than 64, 128 or 256.  When grad is
    enabled and an input requires it, the call goes through
    `FlashAttentionFn`, whose backward is `flash_attention_backward`.
    """
    _check_inputs(q, k, v, window, logit_softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, window, logit_softcap)
    return _dispatch(q, k, v, window, logit_softcap)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps q, k, v, the
    output and each row's logsumexp; the backward is
    `flash_attention_backward` (the kernel on CUDA tensors, the plain
    formulas on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, window, logit_softcap):
        out, lse = _dispatch(q, k, v, window, logit_softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.logit_softcap = window, logit_softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, window=ctx.window,
                                              logit_softcap=ctx.logit_softcap)
        return dq, dk, dv, None, None


def _dispatch(q, k, v, window, logit_softcap, with_lse=False):
    """`flash_attention` after its checks: the plain version or the kernel
    of q's dtype; with ``with_lse``, ``(out, lse)``, lse each row's float32
    logsumexp (B, H, S)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, logit_softcap=logit_softcap,
                                     return_lse=with_lse)
    b, s, h, d = q.shape
    if q.device.type == "meta":  # shapes only: the dry-run's abstract step
        lse = torch.empty((b, h, s), dtype=torch.float32, device="meta")
        return (torch.empty_like(q), lse) if with_lse else torch.empty_like(q)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS} on CUDA")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    variant = _variant(q.dtype)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, s, h, k.shape[2], d, d ** -0.5,
            0.0 if logit_softcap is None else float(logit_softcap),
            0 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"flash_attention {variant} kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return (out, lse) if with_lse else out


# ---- the backward ------------------------------------------------------------


def _check_backward(q, k, v, o, lse, do, window, logit_softcap) -> None:
    _check_inputs(q, k, v, window, logit_softcap)
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"flash_attention_backward: {name} must be like q "
                             f"({tuple(q.shape)} {q.dtype} on {q.device}), got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    b, s, h, _ = q.shape
    if lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention_backward: lse must be float32 {(b, h, s)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def flash_attention_backward(q, k, v, o, lse, do, *, window=None, logit_softcap=None):
    """``(dq, dk, dv)`` of `flash_attention` at q, k, v, whose output was
    ``o`` with row logsumexp ``lse`` (float32 (B, H, S)), for the output
    gradient ``do``; dispatched by device like `flash_attention`.

    CPU tensors run `flash_attention_backward_plain`; CUDA tensors launch
    the backward kernel's three passes on the current stream (``do`` is
    made contiguous first), and anything they do not take raises.
    """
    _check_backward(q, k, v, o, lse, do, window, logit_softcap)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, window=window,
                                              logit_softcap=logit_softcap)
    if q.device.type == "meta":  # shapes only: the dry-run's abstract step
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _dispatch_bwd(q, k, v, o, lse, do.contiguous(), window, logit_softcap)


_BWD_ARGTYPES = {
    "dot": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "dkdv": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "dq": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _bwd_fns(dtype: torch.dtype) -> dict:
    """The backward kernel's three C functions for inputs of ``dtype`` (the
    ``_bf16`` ones launch the ``wgmma`` variant, the ``_f32`` ones ``simt``)."""
    from ._build import load_library

    lib = load_library("flash_attention_bwd")
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    fns = {}
    for name, argtypes in _BWD_ARGTYPES.items():
        fn = getattr(lib, f"flash_bwd_{name}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _dispatch_bwd(q, k, v, o, lse, do, window, logit_softcap, events=None):
    """The backward kernel's passes after `flash_attention_backward`'s
    checks: D = rowsum(dO o), then dk/dv, then dq, the last two over the
    block ranges `_bwd_ranges` writes for each pass's tiles.  ``events[i]``, a CUDA
    event or None, is recorded after pass ``i`` (for timing the passes
    apart)."""
    global BWD_LAUNCHES
    b, s, h, d = q.shape
    kv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_backward: head_dim {d} not in {HEAD_DIMS} on CUDA")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention_backward: {name} must be contiguous and 16-byte aligned")
    variant = _variant(q.dtype)
    fns = _bwd_fns(q.dtype)
    scale = d ** -0.5
    cap = 0.0 if logit_softcap is None else float(logit_softcap)
    win = 0 if window is None else int(window)
    tiles = BWD_TILES[variant][d]
    with torch.cuda.device(q.device):
        q_ranges = _bwd_ranges_on(q.device, s, *tiles["dkdv"], window)[0]
        k_ranges = _bwd_ranges_on(q.device, s, *tiles["dq"], window)[1]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        passes = (
            ("dot", lambda: fns["dot"](o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                                       b, s, h, d, stream)),
            ("dkdv", lambda: fns["dkdv"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), q_ranges.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h,
                kv, d, *tiles["dkdv"], scale, cap, win, stream)),
            ("dq", lambda: fns["dq"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), k_ranges.data_ptr(), dq.data_ptr(), b, s, h, kv, d,
                *tiles["dq"], scale, cap, win, stream)),
        )
        for i, (name, launch) in enumerate(passes):
            rc = launch()
            if rc != 0:
                raise KernelError(f"flash_attention_backward {name} pass ({variant}) launch "
                                  f"failed: CUDA error {rc}")
            BWD_PASSES[name] += 1
            if events is not None and i < len(events) and events[i] is not None:
                events[i].record()
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_VARIANT[variant] += 1
    return dq, dk, dv
