"""RG-LRU linear recurrence — the prefill kernel of the ``"recurrent"`` block.

Replaces the TPU kernel `repro/kernels/rglru.py:rglru_scan_kernel` (body
`_kernel`): per batch row and width lane, ``h_t = a_t · h_{t−1} + b_t``
over positions ``0..S−1``, from an optional ``h0`` (zeros otherwise), in
float32.  The Griffin block passes float32 gates, so float32 is the one
type both implementations take.

Two implementations:

* `rglru_scan_plain` — plain torch, the sequential loop of
  `repro/kernels/ref.py:rglru_ref`;
* the CUDA kernels in ``csrc/rglru.cu``: time is cut into up to 16
  chunks (`chunks`); a summary pass composes each chunk's map
  ``h -> A h + Bs`` into a float32 scratch, then a scan pass folds h0
  through the earlier chunks' maps and walks each chunk's steps, one
  thread per (b, chunk, lane).

`rglru_scan` dispatches by device: CPU tensors go to the plain version,
CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["LAUNCHES", "chunks", "rglru_scan", "rglru_scan_plain"]

#: Number of CUDA kernel launches made by `rglru_scan` in this process
#: (one per call: the summary pass and the scan pass count as one).
LAUNCHES = 0

#: Time steps per chunk aimed at, and the most chunks a call uses.
_CHUNK_STEPS = 64
_MAX_CHUNKS = 16


def rglru_scan_plain(a, b, h0=None):
    """Plain torch recurrence, one step at a time; any device."""
    bsz, s, w = a.shape
    h = torch.empty_like(a)
    cur = torch.zeros((bsz, w), dtype=a.dtype, device=a.device) if h0 is None else h0
    for t in range(s):
        cur = torch.addcmul(b[:, t], a[:, t], cur)
        h[:, t] = cur
    return h


def _check_inputs(a, b, h0) -> None:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} must be float32, got {t.dtype}")
    if a.dim() != 3 or min(a.shape) < 1:
        raise ValueError(f"rglru_scan: a must be a non-empty (B, S, W), got {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"rglru_scan: b must be {tuple(a.shape)}, got {tuple(b.shape)}")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: h0 must be {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")


def chunks(s: int) -> tuple[int, int]:
    """``(n_chunks, steps per chunk)`` that cover ``s`` steps: about
    `_CHUNK_STEPS` a chunk, at most `_MAX_CHUNKS` chunks, none empty."""
    n = min(_MAX_CHUNKS, -(-s // _CHUNK_STEPS))
    per = -(-s // n)
    return -(-s // per), per


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel_fn():
    from ._build import load_library

    fn = load_library("rglru").rglru_scan_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a, b, h0=None):
    """``h (B, S, W)`` float32 from float32 a, b ``(B, S, W)`` and an
    optional float32 h0 ``(B, W)``, dispatched by device.  Any S and W.

    CPU tensors run `rglru_scan_plain`; CUDA tensors launch the CUDA kernel
    on the current stream, and anything it does not take raises: another
    dtype or device, mismatched shapes, a non-contiguous tensor.
    """
    _check_inputs(a, b, h0)
    return _dispatch(a, b, h0)


def _dispatch(a, b, h0):
    """`rglru_scan` after its checks: the plain version or the kernel."""
    global LAUNCHES
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous on CUDA")
    bsz, s, w = a.shape
    n_chunks, per = chunks(s)
    fn = _kernel_fn()
    with torch.cuda.device(a.device):
        h = torch.empty_like(a)
        # Per (b, chunk, lane): the chunk's product of a and its recurrence from zero.
        scratch = torch.empty((2, bsz, n_chunks, w), dtype=torch.float32, device=a.device)
        rc = fn(a.data_ptr(), b.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(), h.data_ptr(),
                bsz, s, w, per, n_chunks, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return h
