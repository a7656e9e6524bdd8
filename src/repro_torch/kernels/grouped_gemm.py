"""Grouped (ragged expert) GEMM — the expert products of the ``"moe"`` block.

Replaces the TPU kernel `repro/kernels/grouped_gemm.py:grouped_gemm`
(body `_kernel`): ``out[r] = x[r] @ w[expert(r)]`` for rows sorted by
expert, with float32 accumulation and the output rounded once to x's type
(bfloat16 or float32).

The TPU kernel takes every expert's segment padded to ``block_t`` rows and
a ``block_expert`` map.  The CUDA kernels take the ragged layout instead:
x ``(N, K)`` sorted by expert, w ``(E, K, F)`` and int32 ``offsets``
``(E + 1,)`` on the device, expert ``e`` owning rows
``offsets[e]:offsets[e + 1]``.  Rows outside every segment come out zero.

On the card the wrapper picks one of two kernels in
``csrc/grouped_gemm.cu`` by dtype and alignment (`_variant`), before the
launch and without reading the offsets:

* ``"wgmma"`` — bf16 with K and F multiples of 8 (TMA's 16-byte strides):
  128 x 256 tiles on the tensor cores (wgmma), fed by TMA (the prefill and
  decode products);
* ``"simt"`` — the rest (float32, bf16 K or F that TMA does not take):
  128 x 128 tiles of float32 FMAs.

A build or launch that fails raises; nothing falls back to another kernel.

The backward (``csrc/grouped_gemm_bwd.cu``), for ``dy`` ``(N, F)``: ``dx[r]
= dy[r] @ w[e(r)]ᵀ`` ``(N, K)``, zero on the rows outside every segment,
and ``dw[e] = x[seg_e]ᵀ @ dy[seg_e]`` ``(E, K, F)``, zero for an expert
with no rows; both in x's type, float32 sums rounded once.  Two kernels,
``"dx"`` and ``"dw"``, each one launch a call, no float atomics: a
repeat is bit for bit.  Each comes in two designs, picked like the
forward's variants (`_bwd_variant`): ``"wgmma"`` for bf16 that TMA can
address (tensor cores fed by TMA rings; ``dw`` persistent, its tiles
stored by TMA) and ``"simt"`` (float32 FMAs) for the rest.

Functions:

* `grouped_gemm_plain` — plain torch: one float32 matmul per non-empty
  segment, cast once (never a per-row gather of ``w``);
* `grouped_gemm_ragged` — dispatch by device: CPU tensors run the plain
  version, CUDA tensors launch a kernel (or raise).  The MoE block calls
  this; with grad enabled and x or w requiring it, the call goes through
  `GroupedGemmFn`, whose backward is `grouped_gemm_backward`;
* `grouped_gemm_backward_plain` — plain torch: one float32 matmul per
  non-empty segment for each of dx and dw, cast once;
* `grouped_gemm_backward` — dispatch by device: the plain version on CPU
  tensors, the ``dx`` and ``dw`` kernels on CUDA tensors (or raise);
* `grouped_gemm` — the reference's contract ``(x, w, block_expert, *,
  block_t, block_f)``, a thin adapter that turns the blocks of each expert
  into one segment of offsets (gathering the blocks into expert order
  first, and scattering the output back, when ``block_expert`` is not
  nondecreasing): every row is computed;
* `pad_and_sort_tokens` — the reference's helper, plain torch, with the
  same outputs ``(xs, block_expert, inv)``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import KernelError

__all__ = ["BWD_LAUNCHES", "BWD_LAUNCHES_BY_DESIGN", "BWD_LAUNCHES_BY_VARIANT", "GroupedGemmFn",
           "LAUNCHES", "LAUNCHES_BY_VARIANT", "grouped_gemm", "grouped_gemm_backward",
           "grouped_gemm_backward_plain", "grouped_gemm_plain", "grouped_gemm_ragged",
           "pad_and_sort_tokens"]

#: Number of CUDA kernel launches made by `grouped_gemm_ragged` (and so by
#: `grouped_gemm`) in this process.
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"wgmma": 0, "simt": 0}
#: Number of backward kernel launches made by `grouped_gemm_backward` (and
#: so by `GroupedGemmFn`'s backward): each of ``dx`` and ``dw`` counts one.
BWD_LAUNCHES = 0
#: The same launches by kernel.
BWD_LAUNCHES_BY_VARIANT = {"dx": 0, "dw": 0}
#: The same launches by design (`_bwd_variant`).
BWD_LAUNCHES_BY_DESIGN = {"wgmma": 0, "simt": 0}

_DTYPES = (torch.bfloat16, torch.float32)
#: The variants' codes in the C interface.
_VARIANT_CODES = {"simt": 0, "wgmma": 1}


def _variant(k: int, f: int, dtype: torch.dtype, *, aligned: bool = True) -> str:
    """The kernel for x ``(N, k)`` and w ``(E, k, f)`` of ``dtype``:
    ``"wgmma"`` for bf16 whose rows TMA can address (k and f multiples of
    8, x and w starting on 16-byte boundaries: ``aligned``), else
    ``"simt"``.  Prefill and decode take the same kernel: at qwen3-moe-30b-a3b's
    decode shape a weight-streaming kernel was no faster than ``wgmma`` on
    an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).  The offsets are never
    read."""
    if aligned and dtype == torch.bfloat16 and k % 8 == 0 and f % 8 == 0:
        return "wgmma"
    return "simt"


def _bwd_variant(k: int, f: int, dtype: torch.dtype, *, aligned: bool = True) -> str:
    """The backward's design for x ``(N, k)``, w ``(E, k, f)`` and dy ``(N,
    f)`` of ``dtype``: its TMA maps take what the forward's do, so
    ``"wgmma"`` for bf16 whose rows TMA can address (k and f multiples of
    8, x, w and dy starting on 16-byte boundaries: ``aligned``), else
    ``"simt"`` (float32, whose 2e-5 limit TF32 would break, and bf16 shapes
    such as K 100 or F 77).  The offsets are never read."""
    return _variant(k, f, dtype, aligned=aligned)


def _bounds(offsets, n: int) -> list[int]:
    """The offsets on the host, checked: ``0 <= offsets[0] <= ... <=
    offsets[E] <= n``, else `ValueError`."""
    bounds = offsets.tolist()
    if bounds[0] < 0 or bounds[-1] > n or any(a > b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"grouped_gemm: offsets must be nondecreasing in [0, {n}]")
    return bounds


def grouped_gemm_plain(x, w, offsets):
    """Plain torch ragged grouped GEMM; any device.  Reads ``offsets`` on
    the host and raises unless ``0 <= offsets[0] <= ... <= offsets[E] <= N``."""
    bounds = _bounds(offsets, x.shape[0])
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if hi > lo:
            out[lo:hi] = (x[lo:hi].float() @ w[e].float()).to(x.dtype)
    return out


def grouped_gemm_backward_plain(x, w, offsets, dy, *, need_dx: bool = True,
                                need_dw: bool = True):
    """Plain torch backward of `grouped_gemm_plain`; any device.  ``(dx,
    dw)`` in x's type (None where not ``need_*``): per non-empty segment one
    float32 matmul for each, cast once; the rows outside every segment get
    zero ``dx``, an empty expert zero ``dw``."""
    bounds = _bounds(offsets, x.shape[0])
    dx = torch.zeros_like(x) if need_dx else None
    dw = torch.zeros_like(w) if need_dw else None
    for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if hi > lo:
            g = dy[lo:hi].float()
            if need_dx:
                dx[lo:hi] = (g @ w[e].float().T).to(x.dtype)
            if need_dw:
                dw[e] = (x[lo:hi].float().T @ g).to(w.dtype)
    return dx, dw


def _check_inputs(x, w, offsets) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"grouped_gemm: x must be bfloat16 or float32, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"grouped_gemm: w is {w.dtype}, x is {x.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"grouped_gemm: offsets must be int32, got {offsets.dtype}")
    for name, t in (("w", w), ("offsets", offsets)):
        if t.device != x.device:
            raise ValueError(f"grouped_gemm: {name} is on {t.device}, x on {x.device}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] or min(w.shape) < 1:
        raise ValueError(f"grouped_gemm: x must be (N, K) and w (E, K, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tuple(offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"grouped_gemm: offsets must be ({w.shape[0] + 1},), "
                         f"got {tuple(offsets.shape)}")


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel_fn(variant: str, dtype: torch.dtype):
    """The C function that launches ``variant`` for ``dtype`` (it takes the
    variant's code among its arguments)."""
    from ._build import load_library

    lib = load_library("grouped_gemm")
    fn = lib.grouped_gemm_bf16 if dtype == torch.bfloat16 else lib.grouped_gemm_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def grouped_gemm_ragged(x, w, offsets):
    """``(N, F)`` in x's type from x ``(N, K)`` sorted by expert, w
    ``(E, K, F)`` and int32 offsets ``(E + 1,)``, dispatched by device.

    CPU tensors run `grouped_gemm_plain`; CUDA tensors launch the kernel
    `_variant` picks on the current stream, and anything it does not take
    raises: another dtype or device, mismatched shapes, a non-contiguous
    tensor.  The kernels do not read the offsets on the host: they clamp
    each segment into ``[0, N]``.  When grad is enabled and x or w requires
    it, the call goes through `GroupedGemmFn`, whose backward is
    `grouped_gemm_backward`.
    """
    _check_inputs(x, w, offsets)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedGemmFn.apply(x, w, offsets)
    return _dispatch(x, w, offsets)


class GroupedGemmFn(torch.autograd.Function):
    """The grouped GEMM with its gradient: the forward keeps x, w and the
    offsets; the backward is `grouped_gemm_backward` (the ``dx`` and ``dw``
    kernels on CUDA tensors, the plain version on the CPU), each of dx and
    dw computed only where its input needs it."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return _dispatch(x, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dx, dw = grouped_gemm_backward(x, w, offsets, dy.contiguous(),
                                       need_dx=ctx.needs_input_grad[0],
                                       need_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def grouped_gemm_backward(x, w, offsets, dy, *, need_dx: bool = True, need_dw: bool = True):
    """``(dx, dw)`` of the grouped GEMM for ``dy`` ``(N, F)`` in x's type,
    dispatched by device (None where not ``need_*``).

    CPU tensors run `grouped_gemm_backward_plain`; CUDA tensors launch the
    ``dx`` and ``dw`` kernels of the design `_bwd_variant` picks on the
    current stream, one launch each, and anything they do not take raises,
    as the forward's wrapper does.
    """
    _check_inputs(x, w, offsets)
    if dy.dtype != x.dtype:
        raise TypeError(f"grouped_gemm backward: dy is {dy.dtype}, x is {x.dtype}")
    if dy.device != x.device:
        raise ValueError(f"grouped_gemm backward: dy is on {dy.device}, x on {x.device}")
    if tuple(dy.shape) != (x.shape[0], w.shape[2]):
        raise ValueError(f"grouped_gemm backward: dy must be {(x.shape[0], w.shape[2])}, "
                         f"got {tuple(dy.shape)}")
    return _dispatch_bwd(x, w, offsets, dy, need_dx, need_dw)


def _dispatch(x, w, offsets, variant: str | None = None):
    """`grouped_gemm_ragged` after its checks: the plain version or a kernel.
    ``variant`` forces a kernel (for tests and measurements); a kernel that
    does not take the shapes then raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, offsets)
    for name, t in (("x", x), ("w", w), ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"grouped_gemm: {name} must be contiguous on CUDA")
    n, k = x.shape
    e, _, f = w.shape
    if variant is None:
        variant = _variant(k, f, x.dtype,
                           aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    fn = _kernel_fn(variant, x.dtype)
    with torch.cuda.device(x.device):
        # Every kernel writes every row, the zero rows outside the segments too.
        out = torch.empty((n, f), dtype=x.dtype, device=x.device)
        rc = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, k, f, e,
                _VARIANT_CODES[variant], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"grouped_gemm {variant} kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return out


def _bwd_kernel_fn(kernel: str, dtype: torch.dtype):
    """The C function that launches backward ``kernel`` ("dx" or "dw") for
    ``dtype`` (it takes the design's code among its arguments)."""
    from ._build import load_library

    lib = load_library("grouped_gemm_bwd")
    fn = getattr(lib, f"grouped_gemm_{kernel}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _dispatch_bwd(x, w, offsets, dy, need_dx: bool = True, need_dw: bool = True,
                  variant: str | None = None):
    """`grouped_gemm_backward` after its checks: the plain version or the
    kernels.  ``variant`` forces a design (for tests and measurements); one
    that does not take the shapes raises before any launch.  Each launch
    records its counts after it succeeds."""
    global BWD_LAUNCHES
    if x.device.type == "cpu":
        return grouped_gemm_backward_plain(x, w, offsets, dy, need_dx=need_dx, need_dw=need_dw)
    for name, t in (("x", x), ("w", w), ("offsets", offsets), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"grouped_gemm backward: {name} must be contiguous on CUDA")
    n, k = x.shape
    e, _, f = w.shape
    takes = _bwd_variant(k, f, x.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, w, dy)))
    if variant is None:
        variant = takes
    elif variant not in _VARIANT_CODES or (variant == "wgmma" and takes != "wgmma"):
        raise ValueError(f"grouped_gemm backward: the {variant!r} design does not take "
                         f"{x.dtype} at K {k}, F {f}")
    dx = dw = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # Each kernel writes every element of its output: dx's rows outside
        # the segments and an empty expert's dw as zeros.
        if need_dx:
            dx = torch.empty_like(x)
        if need_dw:
            dw = torch.empty_like(w)
        for kernel, out, args in (("dx", dx, (dy, w)), ("dw", dw, (x, dy))):
            if out is None or (kernel == "dx" and n == 0):
                continue
            rc = _bwd_kernel_fn(kernel, x.dtype)(args[0].data_ptr(), args[1].data_ptr(),
                                                 offsets.data_ptr(), out.data_ptr(), n, k, f,
                                                 e, _VARIANT_CODES[variant], stream)
            if rc != 0:
                raise KernelError(f"grouped_gemm backward {kernel} [{variant}] kernel launch "
                                  f"failed: CUDA error {rc}")
            BWD_LAUNCHES += 1
            BWD_LAUNCHES_BY_VARIANT[kernel] += 1
            BWD_LAUNCHES_BY_DESIGN[variant] += 1
    return dx, dw


def grouped_gemm(x, w, block_expert, *, block_t: int = 128, block_f: int = 128):
    """The reference's contract: x ``(T, D)`` in ``block_t``-row blocks,
    block ``i`` multiplied by ``w[block_expert[i]]``; ``(T, F)`` in x's type.

    The reference's shape assertions raise `ValueError` here, and so does
    an expert outside ``[0, E)``.  ``block_expert`` may come in any order:
    the blocks are ordered stably by expert, gathered into that order, run
    as one ragged product and scattered back to their places.  A
    nondecreasing map, as `pad_and_sort_tokens` makes it, skips the gather
    and the scatter.  ``block_f`` is checked and otherwise unused (the
    kernel picks its own tiles).
    """
    t, d = x.shape
    e, _, f = w.shape
    block_t, block_f = min(block_t, t), min(block_f, f)
    if t % block_t or f % block_f:
        raise ValueError(f"grouped_gemm: T={t}, F={f} not multiples of blocks "
                         f"{block_t}, {block_f}")
    n_blocks = t // block_t
    if tuple(block_expert.shape) != (n_blocks,):
        raise ValueError(f"grouped_gemm: block_expert must be ({n_blocks},), "
                         f"got {tuple(block_expert.shape)}")
    be = block_expert.to(device=x.device, dtype=torch.int64)
    if int(be.min()) < 0 or int(be.max()) >= e:
        raise ValueError(f"grouped_gemm: block_expert must be in [0, {e})")
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).index_add_(
        0, be, torch.full_like(be, block_t))
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    if not bool((be[1:] < be[:-1]).any()):
        return grouped_gemm_ragged(x, w, offsets)
    order = torch.argsort(be, stable=True)
    xs = x.reshape(n_blocks, block_t, d)[order].reshape(t, d)
    out_sorted = grouped_gemm_ragged(xs, w, offsets)
    out = torch.empty_like(out_sorted)
    out.view(n_blocks, block_t, f)[order] = out_sorted.view(n_blocks, block_t, f)
    return out


def pad_and_sort_tokens(x, expert_ids, num_experts: int, *, block_t: int = 128):
    """Sort tokens by expert and pad each segment to a ``block_t`` multiple.

    Returns ``(sorted_padded_x, block_expert, inv)`` as the reference does:
    ``out_sorted[inv]`` restores token order, padded rows map nowhere, and
    the padded length is the static bound ``T + E*(block_t-1)``, rounded up
    to a block.
    """
    t, d = x.shape
    dev = x.device
    expert_ids = expert_ids.to(torch.int64)
    order = torch.argsort(expert_ids, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int64, device=dev).index_add_(
        0, expert_ids, torch.ones_like(expert_ids))
    padded_counts = (counts + block_t - 1) // block_t * block_t
    padded_ends = padded_counts.cumsum(0)
    sorted_experts = expert_ids[order]
    # Destination row of each sorted token: segment start + rank in segment.
    rank = torch.arange(t, device=dev) - (counts.cumsum(0) - counts)[sorted_experts]
    dest = (padded_ends - padded_counts)[sorted_experts] + rank
    total = (t + num_experts * (block_t - 1) + block_t - 1) // block_t * block_t
    xs = torch.zeros((total, d), dtype=x.dtype, device=dev)
    xs[dest] = x[order]
    inv = torch.zeros(t, dtype=torch.int32, device=dev)
    inv[order] = dest.to(torch.int32)
    block_starts = torch.arange(total // block_t, device=dev) * block_t
    block_expert = torch.searchsorted(padded_ends, block_starts, right=True).clamp(
        0, num_experts - 1).to(torch.int32)
    return xs, block_expert, inv
