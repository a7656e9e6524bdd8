"""RG-LRU linear recurrence — the prefill kernel of the ``"recurrent"`` block.

Replaces the TPU kernel `repro/kernels/rglru.py:rglru_scan_kernel` (body
`_kernel`): per batch row and width lane, ``h_t = a_t · h_{t−1} + b_t``
over positions ``0..S−1``, from an optional ``h0`` (zeros otherwise), in
float32.  The Griffin block passes float32 gates, so float32 is the one
type both implementations take.

Two implementations:

* `rglru_scan_plain` — plain torch, the sequential loop of
  `repro/kernels/ref.py:rglru_ref`;
* the CUDA kernel in ``csrc/rglru.cu``: a streaming walk in the TPU
  kernel's order, one CTA per (batch row, block of `_lanes` lanes) walking
  all S steps with the state in registers, so ``a`` and ``b`` are read once
  and ``h`` written once; a ring of (32 steps x lanes) boxes in shared
  memory keeps the loads in flight.  Two variants, picked by shape before
  the launch (`_variant`): ``"tma"`` (W a multiple of 4 and 16-byte-aligned
  ``a`` and ``b``: one TMA copy a box) and ``"cp_async"`` (any W: each
  thread copies its own lane with 4-byte ``cp.async``).

`rglru_scan` dispatches by device: CPU tensors go to the plain version,
CUDA tensors launch the kernel (or raise; nothing falls back to another
variant).

The gradient.  Training calls `rglru_scan_train(a, b)` (from a zero
state): when grad is enabled and a or b requires it, the call goes through
`RglruScanFn`, which keeps a and the output h, and whose backward is
`rglru_scan_backward`: the reverse recurrence ``g_t = dh_t + a_{t+1}
g_{t+1}``, ``db_t = g_t``, ``da_t = g_t h_{t-1}`` (``h_{-1} = 0``), on
CUDA tensors the kernel in ``csrc/rglru_bwd.cu``, on the CPU
`rglru_scan_backward_plain`.  No Pallas kernel computes it: the reference
trains through ``jax.grad`` of ``associative_scan``
(`repro/models/rglru.py:rglru_scan`).  The backward has two variants,
picked by shape before the launch (`_bwd_variant`): ``"split"`` cuts the
time axis into `_split`'s SEG segments, one CTA each in a thread-block
cluster of SEG: each walks its segment from a zero carry to ``(G, A)``
with ``g_{t0} = G + A g_{t1}``, the cluster folds the later segments'
pairs into each one's true carry through distributed shared memory, and
each walks its segment again from shared memory (TMA boxes in and out; W
a multiple of 4, 16-byte-aligned rows, a segment of at most
`SPLIT_MAX_STEPS`); the card holds `split_clusters` clusters at once, and
each walks (batch row, lane block) items, loading the next item's boxes
under its second walk;
``"walk"`` (any shape) is the forward's ``cp_async`` walk reversed, one CTA
walking all S steps of its lanes.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import KernelError, sm_count

__all__ = ["BWD_LAUNCHES", "BWD_LAUNCHES_BY_VARIANT", "BWD_TOLERANCE", "LAUNCHES",
           "LAUNCHES_BY_VARIANT", "RglruScanFn", "SPLIT_LANES", "SPLIT_MAX_STEPS", "boxes",
           "rglru_scan", "rglru_scan_backward", "rglru_scan_backward_plain",
           "rglru_scan_plain", "rglru_scan_train", "segment_steps", "split_clusters"]

#: Number of CUDA kernel launches made by `rglru_scan` in this process.
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"tma": 0, "cp_async": 0}

#: Number of CUDA kernel launches made by `rglru_scan_backward`.
BWD_LAUNCHES = 0
#: The same launches by variant (`_bwd_variant`).
BWD_LAUNCHES_BY_VARIANT = {"split": 0, "walk": 0}
#: The backward kernel against `rglru_scan_backward_plain` on the same
#: inputs: (atol as a share of each gradient's largest magnitude, rtol).
#: Both walk the same float32 steps; the kernel fuses each multiply-add, so
#: the two drift apart by a few ulps over a long recurrence, as the
#: forward's limit (2e-5) allows.
BWD_TOLERANCE = (2e-5, 2e-5)

#: Time steps a box of the kernel's ring (kSteps in csrc/rglru.cu), and a
#: TMA box of the backward's split (kBoxSteps in csrc/rglru_bwd.cu).
BOX_STEPS = 32
#: The split's lanes a CTA (kSplitLanes in csrc/rglru_bwd.cu: one warp).
SPLIT_LANES = 32
#: Steps a segment of the split may have at most: its three planes of
#: (steps x `SPLIT_LANES`) floats in 216 KB of shared memory (kPlaneFloats
#: in csrc/rglru_bwd.cu).
SPLIT_MAX_STEPS = 576
#: The split's largest cluster: the portable size.
SPLIT_MAX_SEG = 8
#: The shortest segment a split makes: below it S is walked whole.
SPLIT_MIN_STEPS = 64
_VARIANT_CODES = {"tma": 0, "cp_async": 1}


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


def boxes(s: int) -> tuple[int, int]:
    """``(boxes, steps in the last)``: the kernel's ring walks ``s`` steps in
    boxes of `BOX_STEPS`, the last one partial."""
    n = -(-s // BOX_STEPS)
    return n, s - (n - 1) * BOX_STEPS


def _variant(w: int, aligned: bool = True) -> str:
    """The kernel for a width of ``w`` lanes: ``"tma"`` where the rows of
    ``a`` and ``b`` are 16-byte aligned (``w`` a multiple of 4 and
    ``aligned``, their base addresses on 16 bytes), else ``"cp_async"``."""
    return "tma" if w % 4 == 0 and aligned else "cp_async"


def _lanes(bsz: int, w: int, n_sms: int) -> int:
    """Lanes a CTA: 128 (one CTA an SM with its 128 KB ring), unless that
    leaves more than half of the ``n_sms`` SMs without a CTA; then 64.  At
    recurrentgemma-9b's served 4 x 4096 lanes, 128 CTAs of 128 lanes ran
    1-2% faster than 256 of 64 on an H100 (``chip_smoke.py`` phase 8,
    ``scripts/torch_rglru_ring.py``)."""
    return 128 if 2 * bsz * -(-w // 128) >= n_sms else 64


def segment_steps(s: int, seg: int) -> int:
    """Steps of each of ``seg`` segments over ``s`` steps: ``ceil(s / seg)``
    rounded up to whole boxes of `BOX_STEPS` (the last segments may hold
    fewer, or none)."""
    return -(-(-(-s // seg)) // BOX_STEPS) * BOX_STEPS


def _split(bsz: int, s: int, w: int, n_sms: int) -> tuple[int, int]:
    """``(SEG, LANES)`` of the backward's split: `SPLIT_LANES` lanes a CTA,
    and the segments doubled from 1 while the (lane block, segment) pairs
    number under four an SM (or a segment would not fit in shared memory)
    and halving the segments leaves at least `SPLIT_MIN_STEPS` steps each,
    up to `SPLIT_MAX_SEG`.  SEG 1 where no split fits or none is needed:
    the walk takes the call.  At recurrentgemma-9b's training call (1, 4096,
    4096) on 132 SMs: 8 segments of 512 steps over 128 lane blocks."""
    blocks = bsz * -(-w // SPLIT_LANES)

    def fits(seg):
        return segment_steps(s, seg) <= SPLIT_MAX_STEPS

    seg = 1
    while (seg < SPLIT_MAX_SEG and (blocks * seg < 4 * n_sms or not fits(seg))
           and -(-s // (2 * seg)) >= SPLIT_MIN_STEPS):
        seg *= 2
    return (seg if fits(seg) else 1), SPLIT_LANES


def _bwd_variant(w: int, seg: int, aligned: bool = True) -> str:
    """The backward for a width of ``w`` lanes cut into ``seg`` segments:
    ``"split"`` where there are segments and TMA can read the rows (``w`` a
    multiple of 4 and ``aligned``, a, h and dh on 16 bytes), else
    ``"walk"``."""
    return "split" if seg > 1 and w % 4 == 0 and aligned else "walk"


_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _kernel_fn(variant: str):
    """The C function that launches ``variant`` (it takes the variant's code
    among its arguments)."""
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
    variant = _variant(w, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    lanes = _lanes(bsz, w, sm_count(index))
    fn = _kernel_fn(variant)
    with torch.cuda.device(a.device):
        h = torch.empty_like(a)
        rc = fn(_VARIANT_CODES[variant], lanes, a.data_ptr(), b.data_ptr(),
                0 if h0 is None else h0.data_ptr(), h.data_ptr(), bsz, s, w,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"rglru_scan kernel launch failed ({variant}): CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return h


# ---- the backward ------------------------------------------------------------


def rglru_scan_backward_plain(a, h, dh):
    """``(da, db)`` of `rglru_scan_plain` from a zero state, at ``a`` whose
    output was ``h``, for the output gradient ``dh``: the reverse loop
    ``g_t = dh_t + a_{t+1} g_{t+1}``, ``db_t = g_t``, ``da_t = g_t h_{t-1}``
    with ``h_{-1} = 0``; any device."""
    s = a.shape[1]
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = torch.zeros_like(a[:, 0])
    for t in reversed(range(s)):
        g = dh[:, t] if t == s - 1 else torch.addcmul(dh[:, t], a[:, t + 1], g)
        db[:, t] = g
        if t > 0:
            da[:, t] = g * h[:, t - 1]
        else:
            da[:, t] = 0.0
    return da, db


def rglru_scan_backward(a, h, dh):
    """``(da, db)`` of `rglru_scan` from a zero state, dispatched by device:
    CPU tensors run `rglru_scan_backward_plain`; CUDA tensors launch the
    backward kernel on the current stream (``dh`` made contiguous first),
    and anything it does not take raises."""
    _check_inputs(a, h, None)
    if dh.shape != a.shape or dh.dtype != a.dtype or dh.device != a.device:
        raise ValueError(f"rglru_scan_backward: dh must be like a ({tuple(a.shape)} {a.dtype} "
                         f"on {a.device}), got {tuple(dh.shape)} {dh.dtype} on {dh.device}")
    if a.device.type == "cpu":
        return rglru_scan_backward_plain(a, h, dh)
    return _dispatch_bwd(a, h, dh.contiguous())


_BWD_ARGTYPES = {
    "walk": [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "split": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_BWD_FUNCTIONS = {"walk": "rglru_bwd_f32", "split": "rglru_bwd_split_f32"}


def _bwd_fn(variant: str):
    """The C function that launches the backward's ``variant``."""
    from ._build import load_library

    fn = getattr(load_library("rglru_bwd"), _BWD_FUNCTIONS[variant])
    fn.argtypes = _BWD_ARGTYPES[variant]
    fn.restype = ctypes.c_int
    return fn


def split_clusters(seg: int, steps: int) -> int:
    """Clusters of the split (``seg`` CTAs, segments of ``steps`` steps) the
    current card holds at once: the split's grid, each cluster walking
    items (batch row, lane block) until none is left (0 where none fits)."""
    from ._build import load_library

    fn = load_library("rglru_bwd").rglru_bwd_split_clusters
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(seg, steps)


def _dispatch_bwd(a, h, dh):
    """`rglru_scan_backward` on CUDA tensors after its checks."""
    global BWD_LAUNCHES
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan_backward: {name} must be contiguous on CUDA")
    bsz, s, w = a.shape
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    n_sms = sm_count(index)
    seg, split_lanes = _split(bsz, s, w, n_sms)
    variant = _bwd_variant(w, seg, all(t.data_ptr() % 16 == 0 for t in (a, h, dh)))
    shape = ((seg, segment_steps(s, seg)) if variant == "split" else (_lanes(bsz, w, n_sms),))
    fn = _bwd_fn(variant)
    with torch.cuda.device(a.device):
        da, db = torch.empty_like(a), torch.empty_like(a)
        rc = fn(*shape, a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
                bsz, s, w, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"rglru_scan_backward kernel launch failed ({variant} {shape}): "
                          f"CUDA error {rc}")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_VARIANT[variant] += 1
    return da, db


class RglruScanFn(torch.autograd.Function):
    """The RG-LRU scan from a zero state with its gradient: the forward
    keeps a and its output h; the backward is `rglru_scan_backward` (the
    kernel on CUDA tensors, the plain loop on the CPU)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _dispatch(a, b, None)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_backward(a, h, dh)


def rglru_scan_train(a, b):
    """``h (B, S, W)`` of `rglru_scan` from a zero state, differentiable in a
    and b: when grad is enabled and either requires it, the call goes
    through `RglruScanFn`."""
    _check_inputs(a, b, None)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RglruScanFn.apply(a, b)
    return _dispatch(a, b, None)
