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

The gradient.  Training calls `ssd_scan_train` (no entering state, the
final one dropped): when grad is enabled and an input requires it, the
call goes through `SsdScanFn`, whose backward is `ssd_scan_backward`: on
CUDA tensors the kernels of ``csrc/ssd_bwd.cu``: in the ``mma`` variant
the chunk-parallel split of `BWD_PASSES` (a walk over the chunks for the
states entering them and the gradients leaving them; every chunk-local
gradient in parallel over (batch row, chunk, row slice) on wgmma, with dB
and dC summed over the heads on chip; the per-head finish of d(dt) and
dA), in the ``simt`` variant one CTA per (batch row, head) and a sum of
its per-head partials; on the CPU `ssd_scan_backward_plain`, the
explicit formulas.
`ssd_scan_backward_phases` chains plain twins of the four phases.  No
Pallas kernel computes it: the reference trains through ``jax.grad`` of
`repro/models/ssm.py:ssd_chunked`.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import KernelError

__all__ = ["BWD_LAUNCHES", "BWD_LAUNCHES_BY_VARIANT", "BWD_TOLERANCE", "LAUNCHES",
           "LAUNCHES_BY_VARIANT", "SsdScanFn", "ssd_scan", "ssd_scan_backward",
           "ssd_scan_backward_plain", "ssd_scan_plain", "ssd_scan_train"]

#: Number of CUDA kernel launches made by `ssd_scan` in this process (one
#: per call: the ``mma`` variant's C·Bᵀ pass and per-head pass count as one).
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"mma": 0, "simt": 0}

#: Number of backward calls that launched the backward kernels (the launches
#: of `BWD_PASSES` count as one).
BWD_LAUNCHES = 0
#: The same backward calls by variant (`_variant`).
BWD_LAUNCHES_BY_VARIANT = {"mma": 0, "simt": 0}
#: The backward kernel against `ssd_scan_backward_plain` on the same inputs,
#: by dtype: (atol as a share of each gradient's largest magnitude, rtol).
#: float32 1e-4: the two sum in other orders, and d(dt) is a difference of
#: sums (Z's row and column sums) that cancel to a small part of each.
#: bf16: dx, dB and dC come out in bf16, where kernel and plain round two
#: float32 values to outputs one bf16 ulp apart (rtol 2^-7); the kernel's
#: float32 operands pass through bf16 hi + lo (some 16 bits), 1e-3.
BWD_TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2.0 ** -7)}

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
    # Masked before the exponential: above the diagonal cum_i - cum_j > 0
    # can overflow, and autograd through a where of an infinity gives NaN.
    w = cb[..., None] * torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
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


# ---- the backward ------------------------------------------------------------


def ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, *, chunk=128):
    """``(dx, d(dt), dA, dBm, dCm)`` of `ssd_scan_plain` without an entering
    state, at x, dt, A, Bm, Cm, for the output gradient ``dy`` (the final
    state's gradient is zero), from the explicit formulas in float32, each
    cast to its input's type; any device.

    Chunks as the kernel takes them.  Per chunk, with ``dec_ij = e^{cum_i -
    cum_j}`` (i >= j), ``s_j = dt_j e^{total - cum_j}``, ``h_in`` the state
    entering the chunk and ``G`` the gradient of the state leaving it:
    ``dx_j = Σ_i W_ij dy_i + s_j G B_j`` with ``W = (C Bᵀ) o dec o dt_j``;
    ``dB_j = Σ_i M_ij C_i + s_j x_jᵀ G`` and ``dC_i = Σ_j M_ij B_j +
    e^{cum_i} dy_iᵀ h_in``, summed over the heads, with ``M = (dy xᵀ) o dec
    o dt_j``; the log-decays' gradient ``dcum`` from ``Z = M o C Bᵀ`` (row
    sums minus column sums), the entering and leaving states' terms, then
    ``d(dt) = A·da + Σ_i (Z / dt_j) + e^{total - cum} r`` and ``dA = Σ dt·da``
    with ``da`` the suffix sums of ``dcum`` in the chunk.  Chunk to chunk,
    backwards: ``G_{c-1} = e^{total_c} G_c + Σ_i e^{cum_i} dy_i C_iᵀ``.
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = -s % q
    nc = (s + pad) // q

    def rows(t, *shape):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape(b, nc, q, *shape)

    xc, dtc, bc, cc, dyc = rows(x, h, p), rows(dt, h), rows(Bm, n), rows(Cm, n), rows(dy, h, p)
    af = A.float()
    cum = torch.cumsum(dtc * af, dim=2)  # (B,nc,Q,H)
    total = cum[:, :, -1, :]
    etot = torch.exp(total[:, :, None, :] - cum)  # e^{total - cum_j}
    sv = dtc * etot
    ecum = torch.exp(cum)
    # The states entering and leaving each chunk, and their gradients.
    chunk_states = torch.einsum("bcjn,bcjhp->bchpn", bc, xc * sv[..., None])
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + chunk_states[:, c]
    h_in = torch.stack(entering, dim=1)  # (B,nc,H,P,N)
    h_out = torch.stack(entering[1:] + [state], dim=1)
    g_in = torch.einsum("bcihp,bcin->bchpn", dyc * ecum[..., None], cc)
    grad = torch.zeros_like(state)
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = grad
        grad = grad * torch.exp(total[:, c])[:, :, None, None] + g_in[:, c]
    g = torch.stack(leaving, dim=1)  # (B,nc,H,P,N): dL/d(state leaving chunk c)
    # Inside the chunks.
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q_i,Q_j,H)
    dec = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None]
    dw = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    dtj = dtc[:, :, None, :, :]
    m = dw * dec * dtj
    w = cb * dec * dtj
    zp = dw * cb * dec  # Z / dt_j
    xg = torch.einsum("bcjhp,bchpn->bcjhn", xc, g)
    r = torch.einsum("bcjhn,bcjn->bcjh", xg, bc)
    dx = (torch.einsum("bcijh,bcihp->bcjhp", w, dyc)
          + sv[..., None] * torch.einsum("bcjn,bchpn->bcjhp", bc, g))
    dbm = (torch.einsum("bcijh,bcin->bcjn", m, cc)
           + torch.einsum("bcjh,bcjhn->bcjn", sv, xg))
    dc_inter = torch.einsum("bcihp,bchpn->bcihn", dyc, h_in) * ecum[..., None]
    dcm = torch.einsum("bcijh,bcjn->bcin", m, bc) + dc_inter.sum(3)
    u = torch.einsum("bcihn,bcin->bcih", dc_inter, cc)
    dtotal = torch.einsum("bchpn,bchpn->bch", g, h_out)
    dcum = (zp * dtj).sum(3) - (zp * dtj).sum(2) + u - sv * r
    dcum[:, :, -1] += dtotal
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = af * da + zp.sum(2) + etot * r
    da_h = (dtc * da).sum((0, 1, 2))

    def unpad(t, *shape):
        return t.reshape(b, s + pad, *shape)[:, :s]

    return (unpad(dx, h, p).to(x.dtype), unpad(ddt, h).to(dt.dtype), da_h.to(A.dtype),
            unpad(dbm, n).to(Bm.dtype), unpad(dcm, n).to(Cm.dtype))


# ---- the backward's phases, as the CUDA kernels split it ----------------------
#
# Plain twins of the four launches of ``csrc/ssd_bwd.cu``, in float32 (float64
# for float64 inputs), each passing to the next what the kernel passes through
# device memory.  `ssd_scan_backward_phases` chains them.


def _chunk_rows(t, q, nc, wt):
    """``t`` (B, S, ...) zero-padded to ``nc * q`` positions, as (B, nc, q, ...)
    in ``wt``."""
    b, s = t.shape[:2]
    t = t.to(wt)
    if nc * q > s:
        t = torch.cat([t, t.new_zeros((b, nc * q - s) + t.shape[2:])], dim=1)
    return t.reshape(b, nc, q, *t.shape[2:])


def _work_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _chunk_decays(dt, A, q, nc, wt):
    """Per chunk: dt (B, nc, q, H), cum (inclusive sum of dt A), e^{cum},
    s = dt e^{total - cum}, e^{total - cum} and e^{total} (B, nc, H)."""
    dtc = _chunk_rows(dt, q, nc, wt)
    cum = torch.cumsum(dtc * A.to(wt), dim=2)
    total = cum[:, :, -1, :]
    etot = torch.exp(total[:, :, None, :] - cum)
    return dtc, cum, torch.exp(cum), dtc * etot, etot, torch.exp(total)


def bwd_chunk_states_plain(x, dt, A, Bm, Cm, dy, *, chunk=128):
    """Phase 1, parallel over (batch row, head, chunk): the chunk's own
    state ``S_c = Σ_j s_j x_j ⊗ B_j`` (what it adds to the state leaving
    it), the chunk's own share of the state gradient ``T_c = Σ_i e^{cum_i}
    dy_i ⊗ C_i`` (what it adds to the gradient of the state entering it),
    both (B, H, nc, P, N), and ``e^{total_c}`` (B, H, nc)."""
    b, s, h, p = x.shape
    q = min(chunk, s)
    nc = -(-s // q)
    wt = _work_dtype(x)
    _, _, ecum, sv, _, edecay = _chunk_decays(dt, A, q, nc, wt)
    xc, dyc = _chunk_rows(x, q, nc, wt), _chunk_rows(dy, q, nc, wt)
    bc, cc = _chunk_rows(Bm, q, nc, wt), _chunk_rows(Cm, q, nc, wt)
    S = torch.einsum("bcjhp,bcjn->bhcpn", xc * sv[..., None], bc)
    T = torch.einsum("bcihp,bcin->bhcpn", dyc * ecum[..., None], cc)
    return S, T, edecay.permute(0, 2, 1)


def bwd_state_pass_plain(S, T, edecay):
    """Phase 2, elementwise over (batch row, head, P, N): the walk over the
    chunks, forward ``h_in_{c+1} = e^{total_c} h_in_c + S_c`` from a zero
    state and backward ``G_{c-1} = e^{total_c} G_c + T_c`` from a zero
    gradient.  Returns (h_in, G) like S: the state entering each chunk and
    the gradient of the state leaving it (the kernel overwrites S and T)."""
    nc = S.shape[2]
    h_in, g = torch.empty_like(S), torch.empty_like(T)
    run = torch.zeros_like(S[:, :, 0])
    for c in range(nc):
        h_in[:, :, c] = run
        run = run * edecay[:, :, c, None, None] + S[:, :, c]
    run = torch.zeros_like(T[:, :, 0])
    for c in reversed(range(nc)):
        g[:, :, c] = run
        run = run * edecay[:, :, c, None, None] + T[:, :, c]
    return h_in, g


def bwd_chunk_grads_plain(x, dt, A, Bm, Cm, dy, h_in, G, *, chunk=128):
    """Phase 3, parallel over (batch row, chunk, row slice) with the heads
    summed in order: from the states entering each chunk and the gradients
    leaving it, ``dx`` (B, S, H, P), ``dBm`` and ``dCm`` (B, S, N) summed
    over the heads, in the working type; per position and head (B, S, H)
    the parts of the log-decays' gradient that need no other chunk's rows:
    ``dcum_part = rowz - dt colz + u - s r``, ``ddt_part = colz + e^{total -
    cum} r`` and ``sr = s r``; and ``dot = <G_c, h_in_c>`` (B, H, nc).
    With ``Z = (dy xᵀ) o (C Bᵀ) o dec`` (over i >= j), ``colz_j = Σ_i Z_ij``,
    ``rowz_i = Σ_j Z_ij dt_j``, ``r_j = x_j · (G B_j)`` and ``u_i =
    e^{cum_i} dy_i · (h_in C_i)``."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    wt = _work_dtype(x)
    dtc, cum, ecum, sv, etot, _ = _chunk_decays(dt, A, q, nc, wt)
    xc, dyc = _chunk_rows(x, q, nc, wt), _chunk_rows(dy, q, nc, wt)
    bc, cc = _chunk_rows(Bm, q, nc, wt), _chunk_rows(Cm, q, nc, wt)
    hin, g = h_in.permute(0, 2, 1, 3, 4), G.permute(0, 2, 1, 3, 4)  # (B, nc, H, P, N)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q_i, Q_j, H)
    dec = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None]
    dw = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    dtj = dtc[:, :, None, :, :]
    m = dw * dec * dtj
    zp = dw * cb * dec
    gb = torch.einsum("bchpn,bcjn->bcjhp", g, bc)  # G B_j
    xg = torch.einsum("bcjhp,bchpn->bcjhn", xc, g)  # x_j^T G
    r = (xc * gb).sum(-1)
    hc = torch.einsum("bchpn,bcin->bcihp", hin, cc)  # h_in C_i
    u = ecum * (dyc * hc).sum(-1)
    dx = torch.einsum("bcijh,bcihp->bcjhp", cb * dec * dtj, dyc) + sv[..., None] * gb
    dbm = (torch.einsum("bcijh,bcin->bcjn", m, cc) + torch.einsum("bcjh,bcjhn->bcjn", sv, xg))
    dcm = (torch.einsum("bcijh,bcjn->bcin", m, bc)
           + torch.einsum("bcih,bcihp,bchpn->bcin", ecum, dyc, hin))
    colz, rowz = zp.sum(2), (zp * dtj).sum(3)
    dcum_part = rowz - dtc * colz + u - sv * r
    ddt_part = colz + etot * r
    dot = torch.einsum("bchpn,bchpn->bhc", g, hin)

    def unpad(t):
        return t.reshape(b, nc * q, *t.shape[3:])[:, :s]

    return (unpad(dx), unpad(dbm), unpad(dcm), unpad(dcum_part), unpad(ddt_part),
            unpad(sv * r), dot)


def bwd_finish_plain(dt, A, dcum_part, ddt_part, sr, dot, edecay, *, chunk=128):
    """Phase 4, per head over the batch and the chunks in order: the state
    leaving chunk c is ``e^{total_c} h_in_c + S_c``, so its weight in the
    loss has gradient ``dtotal_c = e^{total_c} dot_c + Σ_k sr_k`` over the
    chunk's rows; ``da_t = Σ_{k >= t} dcum_part_k + dtotal_c`` inside the
    chunk, ``d(dt) = A da + ddt_part`` and ``dA = Σ dt da``."""
    b, s, h = dt.shape
    q = min(chunk, s)
    nc = -(-s // q)
    wt = dcum_part.dtype
    dtc = _chunk_rows(dt, q, nc, wt)
    dtotal = edecay.permute(0, 2, 1) * dot.permute(0, 2, 1) + _chunk_rows(sr, q, nc, wt).sum(2)
    part = _chunk_rows(dcum_part, q, nc, wt)
    da = torch.flip(torch.cumsum(torch.flip(part, [2]), dim=2), [2]) + dtotal[:, :, None, :]
    ddt = A.to(wt) * da + _chunk_rows(ddt_part, q, nc, wt)
    return ddt.reshape(b, nc * q, h)[:, :s], (dtc * da).sum((0, 1, 2))


def ssd_scan_backward_phases(x, dt, A, Bm, Cm, dy, *, chunk=128):
    """`ssd_scan_backward_plain`'s ``(dx, d(dt), dA, dBm, dCm)`` through
    the four phases the CUDA backward launches, each cast to its input's
    type; any device."""
    S, T, edecay = bwd_chunk_states_plain(x, dt, A, Bm, Cm, dy, chunk=chunk)
    h_in, G = bwd_state_pass_plain(S, T, edecay)
    dx, dbm, dcm, dcum_part, ddt_part, sr, dot = bwd_chunk_grads_plain(
        x, dt, A, Bm, Cm, dy, h_in, G, chunk=chunk)
    ddt, da = bwd_finish_plain(dt, A, dcum_part, ddt_part, sr, dot, edecay, chunk=chunk)
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(A.dtype), dbm.to(Bm.dtype),
            dcm.to(Cm.dtype))


def ssd_scan_backward(x, dt, A, Bm, Cm, dy, *, chunk=128):
    """``(dx, d(dt), dA, dBm, dCm)`` of `ssd_scan` without an entering
    state, for the output gradient ``dy`` (like x), dispatched by device.

    CPU tensors run `ssd_scan_backward_plain`; CUDA tensors launch the
    backward kernels on the current stream (``dy`` made contiguous first),
    and anything they do not take raises, as `ssd_scan` does.
    """
    _check_inputs(x, dt, A, Bm, Cm, None, chunk)
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"ssd_scan_backward: dy must be like x ({tuple(x.shape)} {x.dtype} "
                         f"on {x.device}), got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if x.device.type == "cpu":
        return ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, chunk=chunk)
    return _dispatch_bwd(x, dt, A, Bm, Cm, dy.contiguous(), chunk)


_BWD_ARGTYPES = {
    torch.float32: [ctypes.c_void_p] * 15 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 2,
    torch.bfloat16: [ctypes.c_void_p] * 16 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 2,
}

#: The backward's launches in call order, by variant: ``_dispatch_bwd``'s
#: ``events`` are recorded after each but the last.
BWD_PASSES = {"mma": ("walk", "grads", "finish"), "simt": ("per_head", "head_sum")}


def _bwd_fn(dtype: torch.dtype):
    """The C function that launches ``_variant(dtype)``'s backward kernels."""
    from ._build import load_library

    lib = load_library("ssd_bwd")
    fn = lib.ssd_bwd_bf16 if dtype == torch.bfloat16 else lib.ssd_bwd_f32
    fn.argtypes = _BWD_ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


def _dispatch_bwd(x, dt, A, Bm, Cm, dy, chunk, *, events=None):
    """`ssd_scan_backward` on CUDA tensors after its checks.  ``events`` (up
    to two `torch.cuda.Event`, or None) are recorded after the launches of
    `BWD_PASSES` in order, for measurements; the call counts as one launch."""
    global BWD_LAUNCHES
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if p not in HEAD_DIMS or n not in STATES or chunk not in CHUNKS:
        raise ValueError(f"ssd_scan_backward: (P, N, chunk) = {(p, n, chunk)} not built on "
                         f"CUDA (P in {HEAD_DIMS}, N in {STATES}, chunk in {CHUNKS})")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_backward: {name} must be contiguous on CUDA")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.stride(2) != 1:
            raise ValueError(f"ssd_scan_backward: {name} must have stride 1 along N on CUDA")
    variant = _variant(x.dtype)
    fn = _bwd_fn(x.dtype)
    strides = (Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    n_chunks = -(-s // chunk)
    with torch.cuda.device(x.device):
        marks = (ctypes.c_void_p * 2)()
        for i, ev in enumerate(events or ()):
            if ev is not None:
                if not ev.cuda_event:
                    ev.record()  # creates the event, which the launch records again
                marks[i] = ev.cuda_event
        stream = torch.cuda.current_stream(x.device).cuda_stream
        f32 = dict(dtype=torch.float32, device=x.device)
        dx, ddt = torch.empty_like(x), torch.empty((b, s, h), **f32)
        dbm, dcm = (torch.empty((b, s, n), dtype=x.dtype, device=x.device) for _ in range(2))
        da = torch.empty((h,), **f32)
        # Scratch: the states entering the chunks (mma: bf16 hi and lo
        # halves from its walk, and the gradients leaving them likewise).
        hst = torch.empty((b, h, n_chunks, p, n), **f32)
        outputs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, dy, dx, ddt, dbm, dcm, da, hst)]
        if variant == "mma":
            # e^{total} and <G, h_in> per chunk (by row slice), and per
            # position and head the parts of d(cum), d(dt) and s r.
            gst = torch.empty_like(hst)
            edec = torch.empty((b, h, n_chunks), **f32)
            dot = torch.empty((b, h, n_chunks, 2), **f32)
            rows = torch.empty((3, b, h, s), **f32)
            aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, Bm, Cm)) and all(
                st % 8 == 0 for st in strides)
            rc = fn(*outputs, gst.data_ptr(), edec.data_ptr(), rows.data_ptr(), dot.data_ptr(),
                    *strides, b, s, h, p, n, chunk, int(aligned), marks, stream)
        else:
            # The heads' partials of dB, dC and dA, which the last launch sums.
            dbp, dcp = (torch.empty((b, h, s, n), **f32) for _ in range(2))
            dap = torch.empty((b, h), **f32)
            rc = fn(*outputs, dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), *strides, b, s, h,
                    p, n, chunk, marks, stream)
    if rc != 0:
        raise KernelError(f"ssd_scan_backward {variant} kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_VARIANT[variant] += 1
    return dx, ddt, da, dbm, dcm


class SsdScanFn(torch.autograd.Function):
    """The SSD scan from a zero state with its gradient: the forward keeps
    its inputs (Bm and Cm as the views they are); the backward is
    `ssd_scan_backward` (the kernels on CUDA tensors, the plain formulas on
    the CPU)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, _ = _dispatch(x, dt, A, Bm, Cm, None, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        return (*ssd_scan_backward(x, dt, A, Bm, Cm, dy, chunk=ctx.chunk), None)


def ssd_scan_train(x, dt, A, Bm, Cm, *, chunk=128):
    """``y (B, S, H, P)`` of `ssd_scan` from a zero state, differentiable in
    x, dt, A, Bm and Cm: when grad is enabled and one of them requires it,
    the call goes through `SsdScanFn`.  Takes what `ssd_scan` takes."""
    _check_inputs(x, dt, A, Bm, Cm, None, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SsdScanFn.apply(x, dt, A, Bm, Cm, chunk)
    return _dispatch(x, dt, A, Bm, Cm, None, chunk)[0]
