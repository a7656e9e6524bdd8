"""Mamba-2 SSD chunked scan — the prefill kernel of the ``"ssd"`` block.

Replaces the TPU kernel `repro/kernels/ssd.py:ssd_scan` (body `_kernel`).
Per batch row ``b`` and head ``h``, the selective state-space recurrence
over positions ``t`` with a float32 (P, N) state::

    h_t = exp(dt_t · A) · h_{t-1} + dt_t · x_t ⊗ B_t;   y_t = h_t · C_t

computed chunk by chunk as block products (SSD's duality): inside a chunk
``y_i = Σ_{j≤i} (C_i·B_j) e^{cum_i − cum_j} dt_j x_j + e^{cum_i} C_i·h_in``
with ``cum`` the inclusive sum of ``dt·A``, and the state leaving the chunk
``e^{total} h_in + Σ_j e^{total − cum_j} dt_j x_j B_jᵀ``.  B and C are
shared by all heads (ngroups = 1).  The result does not depend on the
chunk length beyond float rounding.

Two implementations:

* `ssd_scan_plain` — plain torch: the chunked algorithm of
  `repro/models/ssm.py:ssd_chunked`, all in float32 where the reference
  rounds its block products to the input type.  It cuts S as the kernel
  does, into chunks of ``min(chunk, S)`` with the last one partial, where
  the reference falls back to one chunk of S when S is not a multiple
  (`ssm.py:48-49`): float32 error grows with the chunk's length, because
  ``e^{cum_i − cum_j}`` is taken from two long sums, so one chunk of 1000
  positions lands some 7x further from the float64 recurrence than chunks
  of 125 (`tests/test_torch_ssd.py`);
* the CUDA kernels in ``csrc/ssd.cu``, one CTA per (b, h) walking its
  chunks of ``chunk`` positions in order, the last one partial, in two
  variants picked by dtype alone (`_variant`):

  - ``"mma"`` (bf16, mamba2-1.3b's served prefill): a first pass computes
    C·Bᵀ once per (batch row, chunk) for all heads into a float32 scratch;
    the per-head pass runs the three block products on the tensor cores
    (mma.sync, bf16 operands, float32 accumulators) with the float32
    operand of each (the weights, the entering state, the scaled x) split
    into bf16 hi + lo, the chunk's tiles arriving by a two-stage cp.async
    ring and the state kept in registers;
  - ``"simt"`` (float32): float32 FMAs, the state in shared memory.

`ssd_scan` dispatches by device: CPU tensors go to the plain version,
CUDA tensors launch the kernels (or raise; nothing falls back to another
kernel).
"""
from __future__ import annotations

import ctypes

import torch

from ..device import KernelError

__all__ = ["LAUNCHES", "LAUNCHES_BY_VARIANT", "ssd_scan", "ssd_scan_plain"]

#: Number of CUDA kernel launches made by `ssd_scan` in this process (one
#: per call: the ``mma`` variant's C·Bᵀ pass and per-head pass count as one).
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"mma": 0, "simt": 0}

#: The (head_dim P, state N, chunk) values the CUDA kernel is built for.
HEAD_DIMS = (32, 64)
STATES = (32, 64, 128)
CHUNKS = (32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def _variant(dtype: torch.dtype) -> str:
    """The kernel for inputs of ``dtype``: ``"mma"`` (tensor cores) for
    bf16, ``"simt"`` for float32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def ssd_scan_plain(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
    """Plain torch SSD scan in float32, chunks of ``min(chunk, S)``
    positions with the last one partial, as the kernel takes them; any
    device.  Returns (y in x's type, final state (B, H, P, N) float32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = -s % q  # rows past S get dt = 0: they decay nothing and add nothing
    nc = (s + pad) // q

    def rows(t, *shape):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape(b, nc, q, *shape)

    xc, dtc, bc, cc = rows(x, h, p), rows(dt, h), rows(Bm, n), rows(Cm, n)
    cum = torch.cumsum(dtc * A.float(), dim=2)  # (B,nc,Q,H) inclusive log-decay
    total = cum[:, :, -1, :]  # (B,nc,H)
    # Intra-chunk: y_i += sum_{j<=i} C_i.B_j e^{cum_i - cum_j} dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H) i - j
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    w = cb[..., None] * torch.where(causal[:, :, None], torch.exp(seg), 0.0)
    dx = dtc[..., None] * xc  # (B,nc,Q,H,P)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, dx)
    # Chunk states, then the inter-chunk recurrence over the nc chunks.
    sdx = dx * torch.exp(total[:, :, None, :] - cum)[..., None]
    chunk_states = torch.einsum("bcjn,bcjhp->bchpn", bc, sdx)  # (B,nc,H,P,N)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + chunk_states[:, c]
    h_prev = torch.stack(entering, dim=1)  # (B,nc,H,P,N) state entering each chunk
    # Inter-chunk: y_i += e^{cum_i} C_i . h_prev
    y = y + torch.einsum("bcin,bchpn->bcihp", cc, h_prev) * torch.exp(cum)[..., None]
    return y.reshape(b, s + pad, h, p)[:, :s].to(x.dtype), state


def _check_inputs(x, dt, A, Bm, Cm, h0, chunk) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("h0", h0)):
        if t is not None and t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if min(b, s, h, p) < 1:
        raise ValueError(f"ssd_scan: empty x {tuple(x.shape)}")
    n = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (b, s, h), "A": (h,), "Bm": (b, s, n), "Cm": (b, s, n), "h0": (b, h, p, n)}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("h0", h0)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} must be {want[name]}, got {tuple(t.shape)}")
    if n < 1:
        raise ValueError("ssd_scan: empty state")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")


_ARGTYPES = {
    torch.float32: [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 2,
    torch.bfloat16: [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 2,
}


def _kernel_fn(dtype: torch.dtype):
    """The C function that launches ``_variant(dtype)``'s kernels."""
    from ._build import load_library

    lib = load_library("ssd")
    fn = lib.ssd_scan_bf16 if dtype == torch.bfloat16 else lib.ssd_scan_f32
    fn.argtypes = _ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
    """``(y (B, S, H, P) in x's type, h (B, H, P, N) float32)`` from x
    ``(B, S, H, P)``, dt ``(B, S, H)`` float32, A ``(H,)`` float32, Bm and
    Cm ``(B, S, N)`` in x's type and an optional float32 h0 ``(B, H, P,
    N)``, dispatched by device.  Any S >= 1.

    CPU tensors run `ssd_scan_plain`.  CUDA tensors launch the kernels
    `_variant` picks on the current stream, and anything they do not take
    raises: another dtype or device, mismatched shapes, P not in
    `HEAD_DIMS`, N not in `STATES`, chunk not in `CHUNKS`, a
    non-contiguous x, dt, A or h0.  Bm
    and Cm may be views with any batch and position strides (the model
    passes column slices of one (B, S, 2N) tensor); their last dimension
    must have stride 1.
    """
    _check_inputs(x, dt, A, Bm, Cm, h0, chunk)
    return _dispatch(x, dt, A, Bm, Cm, h0, chunk)


def _dispatch(x, dt, A, Bm, Cm, h0, chunk, *, mid_event=None):
    """`ssd_scan` after its checks: the plain version or the kernels.
    ``mid_event`` (a `torch.cuda.Event`) is recorded right before the
    per-head pass (after the ``mma`` variant's C·Bᵀ pass), for
    measurements."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, h0, chunk=chunk)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if p not in HEAD_DIMS or n not in STATES or chunk not in CHUNKS:
        raise ValueError(f"ssd_scan: (P, N, chunk) = {(p, n, chunk)} not built on CUDA "
                         f"(P in {HEAD_DIMS}, N in {STATES}, chunk in {CHUNKS})")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous on CUDA")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.stride(2) != 1:
            raise ValueError(f"ssd_scan: {name} must have stride 1 along N on CUDA")
    variant = _variant(x.dtype)
    fn = _kernel_fn(x.dtype)
    strides = (Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    with torch.cuda.device(x.device):
        if mid_event is not None and not mid_event.cuda_event:
            mid_event.record()  # creates the event, which the launch records again
        mid = None if mid_event is None else mid_event.cuda_event
        stream = torch.cuda.current_stream(x.device).cuda_stream
        y = torch.empty_like(x)
        h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        pointers = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr())
        if variant == "mma":
            # The causal 16 x 16 blocks of C·Bᵀ of every (batch row, chunk),
            # float32: the per-head pass's scratch.
            n_chunks, blocks = -(-s // chunk), (chunk // 16) * (chunk // 16 + 1) // 2
            cb = torch.empty((b * n_chunks * blocks * 256,), dtype=torch.float32,
                             device=x.device)
            aligned = all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)) and all(
                st % 8 == 0 for st in strides)
            rc = fn(*pointers, cb.data_ptr(), *strides, b, s, h, p, n, chunk, int(aligned),
                    mid, stream)
        else:
            rc = fn(*pointers, *strides, b, s, h, p, n, chunk, mid, stream)
    if rc != 0:
        raise KernelError(f"ssd_scan {variant} kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return y, h_out
