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
* the CUDA kernel in ``csrc/placement.cu``: a 2-D grid of (i, c) rows by
  blocks of 32 bins, a thread an output, every load issued before the
  first compare (in 16-byte words where dim is 4), 32-bit indices; an
  empty kernel of the same launch shape (`empty_launch`) is its floor.

`placement_scores` dispatches by the device of its tensors: CPU tensors go
to the plain version, CUDA tensors launch the kernel (or raise).
`placement_scores_host` is the controller's call: host arrays in, a host
array out, with every error of its device section on the card raised as
`KernelError`.  Which candidate matrices go to the card at all is the
caller's size rule (`core.binpack.heuristics.placement_scores`).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..device import KernelError, on_card

__all__ = ["LAUNCHES", "empty_launch", "placement_scores", "placement_scores_host",
           "placement_scores_plain"]

#: Number of CUDA kernel launches made by `placement_scores` in this process.
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

_FIT_EPS = 1e-9  # heuristics._FIT_EPS

#: Bins the kernel's grid can hold: 65,535 blocks of 32 (kBins in
#: csrc/placement.cu).
MAX_BINS = 65535 * 32


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
def _library():
    from ._build import load_library

    lib = load_library("placement")
    lib.placement_scores_f64.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 2
    lib.placement_empty_f64.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.placement_scores_f64, lib.placement_empty_f64):
        fn.restype = ctypes.c_int
    return lib


def _check_card_shape(req, mask, resid) -> None:
    """What only the kernel refuses: non-contiguous tensors, more than
    `MAX_BINS` bins, an output or an input past 32-bit indices."""
    for name, t in (("req", req), ("mask", mask), ("resid", resid)):
        if not t.is_contiguous():
            raise KernelError(f"placement_scores: {name} must be contiguous on CUDA")
    k, c, dim = req.shape
    p_n = resid.shape[0]
    if p_n > MAX_BINS or max(k * c * p_n, k * c * dim, p_n * dim) >= 2**31:
        raise KernelError(f"placement_scores: {(k, c, p_n, dim)} is past the kernel's 32-bit "
                          f"indices or {MAX_BINS} bins")


def placement_scores(req, mask, resid):
    """``(k, C, P)`` float64 scores, dispatched by device.

    CPU tensors run `placement_scores_plain`; CUDA tensors launch the CUDA
    kernel (built on first use) on the current stream, and anything the
    kernel does not take raises: another dtype, device or shape, a
    non-contiguous tensor.
    """
    _check_inputs(req, mask, resid)
    return _dispatch(req, mask, resid)


def placement_scores_host(req, mask, resid, *, device) -> np.ndarray:
    """`placement_scores` on host arrays, run on ``device``: a writable
    ``(k, C, P)`` numpy array.  On the card every error of the device
    section (copies in, launch, copy back) is a `KernelError`
    (`device.on_card`)."""
    with on_card(device, "placement_scores"):
        args = [torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)
                for a, dtype in ((req, np.float64), (mask, bool), (resid, np.float64))]
        return placement_scores(*args).cpu().numpy()


def _dispatch(req, mask, resid):
    """`placement_scores` after its checks: the plain version or the kernel."""
    global LAUNCHES
    dev = req.device
    if dev.type == "cpu":
        return placement_scores_plain(req, mask, resid)
    _check_card_shape(req, mask, resid)
    k, c, dim = req.shape
    p_n = resid.shape[0]
    fn = _library().placement_scores_f64
    with torch.cuda.device(dev):
        out = torch.empty((k, c, p_n), dtype=torch.float64, device=dev)
        rc = fn(req.data_ptr(), mask.data_ptr(), resid.data_ptr(), k, c, p_n, dim,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"placement_scores kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out


def empty_launch(req, mask, resid) -> None:
    """Launches a kernel that does nothing on the launch shape the scores of
    these CUDA tensors take, for measurements: the call's floor.  Not
    counted in `LAUNCHES`."""
    _check_inputs(req, mask, resid)
    if req.device.type != "cuda":
        raise ValueError(f"empty_launch: CUDA tensors only, got {req.device}")
    _check_card_shape(req, mask, resid)
    k, c, dim = req.shape
    with torch.cuda.device(req.device):
        rc = _library().placement_empty_f64(k, c, resid.shape[0], dim,
                                            torch.cuda.current_stream(req.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"placement_scores empty launch failed: CUDA error {rc}")
