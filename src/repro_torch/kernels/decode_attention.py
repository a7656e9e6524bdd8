"""Flash-decode: one query token per sequence against a (ring) KV cache.

Replaces the TPU kernel `repro/kernels/decode_attention.py:decode_attention`
(body `_kernel`).  For each batch row ``b``, KV head ``g`` and the ``R``
query heads that share it, attend over the cache's ``L`` slots, where a
slot is valid when its absolute position ``pos`` satisfies
``0 <= pos <= cur_pos`` (and ``pos > cur_pos - window`` when a window is
given), so sliding-window ring buffers decode with the same kernel::

    s = (q · k_l) / sqrt(D);  s = cap·tanh(s / cap);  invalid s = -2e38
    o = softmax_l(s) @ v

Softmax and products run in float32; the output has q's type.

Implementations:

* `decode_attention_plain` — plain torch (the function of
  `repro/kernels/ref.py:decode_attention_ref`, in float32 inside);
* the CUDA kernels in ``csrc/decode_attention.cu``: the cache's slots are
  split over CTAs (one CTA per (b, g, split), so that about one CTA per
  SM fills the card even at B·KV = 4), whose running (max, sum,
  accumulator) are merged by log-sum-exp.  Two variants, picked by dtype
  alone (`_variant`):

  - ``"mma"`` (bf16, every served decode step): four warps on the tensor
    cores (mma.sync m16n8k16, the R query heads of a KV group padded to
    16 rows), K and V tiles through a three-stage cp.async ring, P·V with
    p split into two bf16 halves so that the product keeps a float32 p's
    accuracy; the splits of a (b, g), a power of two up to 16
    (`mma_splits`), are one thread-block cluster and merge in the same
    kernel through distributed shared memory;
  - ``"simt"`` (float32): float32 FMAs, one tile at a time (TF32 would
    break the float32 limit); each split writes its partial to a float32
    scratch, and a combine kernel, one thread per output element, merges
    them (`splits`).

``cur_pos`` is a host integer, passed to the kernel as an argument: the
TPU kernel's scalar prefetch becomes a launch argument, and nothing waits
on the device to read it.  `decode_attention` dispatches by device: CPU
tensors go to the plain version, CUDA tensors launch the kernels (or
raise; nothing falls back to another kernel).
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from ..device import KernelError, sm_count

__all__ = ["LAUNCHES", "LAUNCHES_BY_VARIANT", "decode_attention", "decode_attention_plain",
           "mma_splits", "splits"]

#: Number of CUDA kernel launches made by `decode_attention` in this process
#: (one per call: the ``simt`` split and combine passes count as one).
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"mma": 0, "simt": 0}

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)  # the head_dims the CUDA kernel is built for
MAX_ROWS_X_DIM = 8192  # R * D: the kernel keeps q and its accumulator in shared memory
_DTYPES = (torch.bfloat16, torch.float32)
#: The ``simt`` kernel's slots per split are a multiple of this (its slot
#: tile); the ``mma`` kernel takes any split and masks a split's last tile.
_SPLIT_UNIT = 32
#: The ``mma`` kernel's largest cluster: splits of one (b, g).
MAX_MMA_SPLITS = 16


def _variant(dtype: torch.dtype) -> str:
    """The split pass for inputs of ``dtype``: ``"mma"`` (tensor cores) for
    bf16, ``"simt"`` for float32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def decode_attention_plain(q, k, v, pos, cur_pos, *, window=None, logit_softcap=None):
    """Plain torch one-token attention over the cache; any device."""
    d = q.shape[-1]
    scores = torch.einsum("bgrd,blgd->bgrl", q.float(), k.float()) * (d ** -0.5)
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    mask = (pos >= 0) & (pos <= cur_pos)
    if window is not None:
        mask &= pos > cur_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrl,blgd->bgrd", p, v.float()).to(q.dtype)


def splits(b: int, kv: int, cache_len: int, target_ctas: int) -> tuple[int, int]:
    """``(n_splits, slots per split)`` for a (b, kv, cache_len) call that
    aims at ``target_ctas`` CTAs in all: as many splits of each (b, g) as
    that allows, each a multiple of 32 slots and none empty."""
    units = -(-cache_len // _SPLIT_UNIT)
    n = min(units, max(1, -(-target_ctas // (b * kv))))
    per = -(-units // n)
    return -(-units // per), per * _SPLIT_UNIT


def mma_splits(b: int, kv: int, cache_len: int, target_ctas: int,
               max_splits: int = MAX_MMA_SPLITS) -> tuple[int, int]:
    """``(n_splits, slots per split)`` for the ``mma`` kernel, whose splits
    of a (b, g) form one thread-block cluster: the largest power of two up
    to ``max_splits`` that keeps ``b * kv * n`` at most ``target_ctas`` (or
    one split) and leaves every split 32 slots or more; then the slots cut
    as evenly as that allows, so no split is empty."""
    cap = min(max_splits, max(1, -(-target_ctas // (b * kv))), max(1, cache_len // 32))
    n = 1 << (cap.bit_length() - 1)
    return n, -(-cache_len // n)


def _check_inputs(q, k, v, pos, cur_pos, window, logit_softcap) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention: q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("k", k), ("v", v), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on {q.device}")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, got {pos.dtype}")
    if isinstance(cur_pos, bool) or not isinstance(cur_pos, numbers.Integral):
        raise TypeError(f"decode_attention: cur_pos must be a host int, got {type(cur_pos)}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("decode_attention: q must be (B, KV, R, D), k/v (B, L, KV, D)")
    b, kv, r, d = q.shape
    cache_len = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, cache_len, kv, d):
            raise ValueError(
                f"decode_attention: {name} must be {(b, cache_len, kv, d)}, "
                f"got {tuple(t.shape)}")
    if cache_len < 1 or r < 1:
        raise ValueError("decode_attention: empty cache or no query heads")
    if tuple(pos.shape) != (cache_len,):
        raise ValueError(f"decode_attention: pos must be ({cache_len},), got {tuple(pos.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window must be >= 1, got {window}")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"decode_attention: softcap must be > 0, got {logit_softcap}")


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


def _target_ctas(device_index: int, variant: str) -> int:
    """CTAs to aim for on a card: one per SM for ``mma``, two for ``simt``.

    ``scripts/torch_decode_splits.py`` timed ``mma`` at a quarter, a half,
    one and two CTAs per SM: one is best at gemma2-2b's step by 22% or
    more and ties at recurrentgemma-9b's, but is 4-6% behind a half at
    qwen3-moe-30b-a3b's and internlm2-1.8b's (more splits spend more in
    the merge and pack their clusters worse).  One target serves all."""
    return sm_count(device_index) * (1 if variant == "mma" else 2)


@functools.cache
def _max_mma_splits(d: int, r: int) -> int:
    """The ``mma`` kernel's largest cluster at head_dim ``d`` and ``r``
    query heads: ``Layout::max_splits`` of the instantiation it launches,
    read from the library so that the rule lives in
    ``csrc/decode_attention.cu`` alone."""
    from ._build import load_library

    fn = load_library("decode_attention").decode_mma_max_splits
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(r, d)


def _kernel_fn(dtype: torch.dtype):
    """The C function that launches ``_variant(dtype)``'s split pass and the
    combine pass."""
    from ._build import load_library

    lib = load_library("decode_attention")
    fn = lib.decode_attention_bf16 if dtype == torch.bfloat16 else lib.decode_attention_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, pos, cur_pos, *, window=None, logit_softcap=None):
    """``(B, KV, R, D)`` attention of q ``(B, KV, R, D)`` over k/v
    ``(B, L, KV, D)`` with slot positions ``pos (L,)`` int32, at the host
    integer ``cur_pos``, dispatched by device.

    CPU tensors run `decode_attention_plain`; CUDA tensors launch the split
    pass `_variant` picks and the combine pass on the current stream, and
    anything they do not take raises:
    another dtype or device, mismatched shapes, a non-contiguous tensor, a
    head_dim other than 64, 128 or 256, ``R * D`` above 8192.
    """
    _check_inputs(q, k, v, pos, cur_pos, window, logit_softcap)
    return _dispatch(q, k, v, pos, int(cur_pos), window, logit_softcap)


def _dispatch(q, k, v, pos, cur_pos, window, logit_softcap, *, mid_event=None):
    """`decode_attention` after its checks: the plain version or the kernels.
    ``mid_event`` (a `torch.cuda.Event`), for measurements, is recorded
    between the ``simt`` variant's split pass and combine pass (the ``mma``
    kernel merges in the same launch and ignores it)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, cur_pos, window=window,
                                      logit_softcap=logit_softcap)
    b, kv, r, d = q.shape
    cache_len = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS} on CUDA")
    if r * d > MAX_ROWS_X_DIM:
        raise ValueError(f"decode_attention: R * D = {r * d} exceeds {MAX_ROWS_X_DIM}")
    if not -2**31 <= cur_pos < 2**31:
        raise ValueError(f"decode_attention: cur_pos {cur_pos} does not fit int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")
    variant = _variant(q.dtype)
    target = _target_ctas(q.device.index, variant)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        if variant == "mma":
            n_split, chunk = mma_splits(b, kv, cache_len, target, _max_mma_splits(d, r))
            scratch, mid = None, None
        else:
            n_split, chunk = splits(b, kv, cache_len, target)
            # Per (b, g, split): R maxima, R sums and the (R, D) accumulator.
            scratch = torch.empty((b * kv * n_split * r * (d + 2),), dtype=torch.float32,
                                  device=q.device)
            if mid_event is not None and not mid_event.cuda_event:
                mid_event.record()  # creates the event, which the launch records again
            mid = None if mid_event is None else mid_event.cuda_event
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, cache_len, kv, r, d, cur_pos, n_split, chunk, d ** -0.5,
            0.0 if logit_softcap is None else float(logit_softcap),
            0 if window is None else int(window), mid,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"decode_attention {variant} kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return out
