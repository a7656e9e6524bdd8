"""Best-fit placement scores — the controller's greedy-repair candidate matrix.

Replaces the reference's jax-traced broadcast in
`repro/core/binpack/heuristics.py` ``placement_scores`` (its XLA branch).
For every (item ``i``, choice ``c``, open bin ``p``): ``+inf`` unless
``req[i, c] <= resid[p] + 1e-9`` in every dimension and ``mask[i, c]``, else
the residual slack ``max_d (resid[p, d] - req[i, c, d]) / max(resid[p, d],
1e-300)``, in float64 — the arithmetic of the numpy scorer
(`core.binpack.heuristics.placement_scores_np`).

Two implementations, bit-identical with it:

* `placement_scores_plain` — plain torch; runs on any device;
* the CUDA kernel in ``csrc/placement.cu``: one thread an output.

`placement_scores` dispatches by the device of its tensors: CPU tensors go
to the plain version, CUDA tensors launch the kernel (or raise).  Which
candidate matrices go to the card at all is the caller's size rule
(`core.binpack.heuristics.placement_scores`).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

__all__ = ["LAUNCHES", "placement_scores", "placement_scores_plain"]

#: Number of CUDA kernel launches made by `placement_scores` in this process.
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

_FIT_EPS = 1e-9  # heuristics._FIT_EPS


def placement_scores_plain(req, mask, resid):
    """Plain torch scores ``(k, C, P)`` float64 from ``req (k, C, dim)``
    float64 (+inf padded), ``mask (k, C)`` bool and ``resid (P, dim)``
    float64, on whatever device they are on."""
    r = req[:, :, None, :]
    rb = resid[None, None, :, :]
    fit = (r <= rb + _FIT_EPS).all(dim=-1) & mask[:, :, None]
    slack = ((rb - r) / rb.clamp_min(1e-300)).amax(dim=-1)
    return torch.where(fit, slack, torch.tensor(float("inf"), dtype=req.dtype,
                                                device=req.device))


def _check_inputs(req, mask, resid) -> None:
    dev = req.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"placement_scores: unsupported device {dev}")
    for name, t, dtype in (("req", req, torch.float64), ("mask", mask, torch.bool),
                           ("resid", resid, torch.float64)):
        if t.dtype != dtype:
            raise TypeError(f"placement_scores: {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"placement_scores: {name} is on {t.device}, req on {dev}")
    if req.dim() != 3 or min(req.shape) < 1:
        raise ValueError(f"placement_scores: req must be a non-empty (k, C, dim), "
                         f"got {tuple(req.shape)}")
    k, c, dim = req.shape
    if tuple(mask.shape) != (k, c):
        raise ValueError(f"placement_scores: mask must be {(k, c)}, got {tuple(mask.shape)}")
    if resid.dim() != 2 or resid.shape[0] < 1 or resid.shape[1] != dim:
        raise ValueError(f"placement_scores: resid must be a non-empty (P, {dim}), "
                         f"got {tuple(resid.shape)}")


@functools.cache
def _kernel_fn():
    from ._build import load_library

    fn = load_library("placement").placement_scores_f64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def placement_scores(req, mask, resid):
    """``(k, C, P)`` float64 scores, dispatched by device.

    CPU tensors run `placement_scores_plain`; CUDA tensors launch the CUDA
    kernel (built on first use) on the current stream, and anything the
    kernel does not take raises: another dtype, device or shape, a
    non-contiguous tensor.
    """
    _check_inputs(req, mask, resid)
    return _dispatch(req, mask, resid)


def _dispatch(req, mask, resid):
    """`placement_scores` after its checks: the plain version or the kernel."""
    global LAUNCHES
    dev = req.device
    if dev.type == "cpu":
        return placement_scores_plain(req, mask, resid)
    for name, t in (("req", req), ("mask", mask), ("resid", resid)):
        if not t.is_contiguous():
            raise ValueError(f"placement_scores: {name} must be contiguous on CUDA")
    k, c, dim = req.shape
    p_n = resid.shape[0]
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        out = torch.empty((k, c, p_n), dtype=torch.float64, device=dev)
        rc = fn(req.data_ptr(), mask.data_ptr(), resid.data_ptr(), k, c, p_n, dim,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"placement_scores kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out
