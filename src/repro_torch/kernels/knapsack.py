"""Batched bounded multi-dimensional knapsack DP — the colgen pricing kernel.

Column generation for MC-VBP (`repro_torch.core.binpack.colgen`) prices
columns by solving, per bin kind, a bounded multi-dimensional knapsack:
maximize the dual-weighted count of stream classes packed under the kind's
capacity vector.  The pricing problems for all bin kinds *and* all open
branch nodes are independent and share one shape, so they batch into a
single dispatch.

Formulation (all arrays pre-discretized to integer grid units by the
caller; see `colgen._discretize`):

* a batch entry ``b`` has a capacity ``cap_levels[b] ∈ Z^D`` on a shared
  grid of ``S = prod(cap_levels.max(0) + 1)`` states,
* pricing entries ``e`` (one per (class, choice)) carry a value
  ``values[b, e] >= 0``, an integer weight vector ``weights[b, e] ∈ Z^D``
  and a copy bound ``bounds[b, e]``,
* the DP maximizes ``Σ_e n_e · values[b, e]`` s.t. ``Σ_e n_e ·
  weights[b, e] <= cap_levels[b]`` and ``0 <= n_e <= bounds[b, e]``.

Bounded counts are binary-split into 0/1 pseudo-steps (1, 2, 4, …,
remainder), and each step is one simultaneous relax over the flattened
state grid::

    cand = val[s - w] + v;  take = fits & (cand > val);  val' = max

computed from the *previous* step's array, so a pseudo-step is used at
most once.  The take bits are recorded per step, packed 32 states to an
int32 word in a (T, B, ceil(S / 32)) layout (`pack_take`, `unpack_take`),
and walked back from each knapsack's capacity state into the steps taken,
whose entries and multiplicities give the per-entry counts (the pattern).

Two implementations of the DP share this exact op sequence and are
bit-identical in ``best`` and the take bits (adds and compares only):

* `knapsack_dp_plain` — plain torch, a Python loop over steps vectorized
  over the batch with `torch.gather`; runs on any device,
* the CUDA kernel in ``csrc/knapsack.cu``, which replaces the TPU kernel
  `repro/kernels/knapsack.py:_pallas_body/_pallas_call`.  Each state's
  coordinates are packed once into a 64-bit word with a guard bit a
  dimension (`_packing`), so a step's fit test is one subtraction.  Two
  variants, picked by shape before the launch (`_variant`):

  - ``"cluster"``: the CTAs of a thread-block cluster (up to 16, `_layout`)
    share a knapsack, each holding a power-of-two slice of its state row in
    shared memory; the shifted reads cross slices through distributed
    shared memory, and one cluster barrier ends a step;
  - ``"global"``: rows larger than 16 slices; one CTA a knapsack, the row
    in global ping-pong buffers.

  Both pack the take bits with a warp ballot and walk the backtrack on the
  card, one thread a knapsack, into a (B, T) mask of the steps taken.

`knapsack_dp` dispatches by the device of its tensors: CPU tensors go to
the plain version, CUDA tensors launch the kernel (or raise).
`price_knapsacks` is the numpy-facing entry point colgen calls: on the
card it copies back only ``best`` and the mask of steps taken; on the CPU
the host backtrack (`_backtrack`) walks the plain version's bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from ..device import KernelError, on_card, resolve_device, sm_count

__all__ = [
    "LAUNCHES",
    "LAUNCHES_BY_VARIANT",
    "PricingResult",
    "PricingSteps",
    "build_pricing_steps",
    "grid_strides",
    "knapsack_dp",
    "knapsack_dp_plain",
    "pack_take",
    "price_knapsacks",
    "pricing_steps",
    "taken_steps_plain",
    "unpack_take",
]

#: Number of CUDA kernel launches made by `knapsack_dp` in this process (one
#: per call: the step-table pass and the DP count as one).
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"cluster": 0, "global": 0}
_LAUNCHES_LOCK = threading.Lock()  # allocate_sweep(parallel=True) prices from threads

_MAX_DIMS = 32  # kMaxDims in csrc/knapsack.cu
#: The kernel indexes states with 32-bit ints: its grids are smaller.
_MAX_STATES = 1 << 31
#: States a CTA of the ``cluster`` variant holds, and the largest cluster
#: (`knapsack_max_slice` and `knapsack_max_cluster` in csrc/knapsack.cu).
_MAX_SLICE = 8192
_MAX_CLUSTER = 16
_DTYPES = (torch.float64, torch.float32)


@dataclasses.dataclass(frozen=True)
class PricingResult:
    """Batched pricing output: per-problem optimum and the argmax pattern."""

    best: np.ndarray  # (B,) best dual value per knapsack
    counts: np.ndarray  # (B, E) int64 copies of each entry in the argmax
    states: int  # grid states per knapsack (DP work metric)
    steps: int  # pseudo-item steps after binary splitting


def grid_strides(levels: Sequence[int]) -> np.ndarray:
    """C-order strides of a grid with ``levels[d]`` levels per dimension."""
    levels = np.asarray(levels, dtype=np.int64)
    strides = np.ones_like(levels)
    for d in range(levels.size - 2, -1, -1):
        strides[d] = strides[d + 1] * levels[d + 1]
    return strides


def build_pricing_steps(
    values: np.ndarray, weights: np.ndarray, bounds: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Binary-split bounded entries into padded 0/1 pseudo-steps.

    Inputs: ``values (B, E) >= 0``, ``weights (B, E, D)`` int,
    ``bounds (B, E)`` int.  Returns ``(step_values, step_weights,
    step_entry, step_mult)`` with a shared step axis T; padding steps have
    value -1 / weight 0 / entry -1 so the DP provably never takes them.
    """
    values = np.asarray(values)
    weights = np.asarray(weights, dtype=np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    b_n, e_n = values.shape
    dim = weights.shape[2]
    chunk_lists: list[list[tuple[int, int]]] = []  # per batch: (entry, mult)
    for b in range(b_n):
        chunks: list[tuple[int, int]] = []
        for e in range(e_n):
            rem = int(bounds[b, e])
            k = 1
            while rem > 0:
                take = min(k, rem)
                chunks.append((e, take))
                rem -= take
                k *= 2
        chunk_lists.append(chunks)
    t_n = max((len(c) for c in chunk_lists), default=0)
    step_values = np.full((b_n, t_n), -1.0, dtype=values.dtype)
    step_weights = np.zeros((b_n, t_n, dim), dtype=np.int64)
    step_entry = np.full((b_n, t_n), -1, dtype=np.int64)
    step_mult = np.zeros((b_n, t_n), dtype=np.int64)
    for b, chunks in enumerate(chunk_lists):
        for t, (e, mult) in enumerate(chunks):
            step_values[b, t] = values[b, e] * mult
            step_weights[b, t] = weights[b, e] * mult
            step_entry[b, t] = e
            step_mult[b, t] = mult
    return step_values, step_weights, step_entry, step_mult


# --------------------------------------------------------------------------
# packed take bits
# --------------------------------------------------------------------------

def _bit_weights(device) -> torch.Tensor:
    """int64 weights of bits 0..31 of an int32 word (bit 31 is -2^31)."""
    w = torch.tensor([1 << i for i in range(31)] + [-(1 << 31)], dtype=torch.int64)
    return w.to(device)


def pack_take(take: torch.Tensor) -> torch.Tensor:
    """Take bits ``(..., S)`` bool into int32 words ``(..., ceil(S / 32))``:
    bit ``i`` of word ``k`` is state ``32 k + i``."""
    s_n = take.shape[-1]
    words = -(-s_n // 32)
    pad = words * 32 - s_n
    if pad:
        take = torch.cat([take, take.new_zeros(take.shape[:-1] + (pad,))], dim=-1)
    bits = take.reshape(take.shape[:-1] + (words, 32)).to(torch.int64)
    return (bits * _bit_weights(take.device)).sum(dim=-1).to(torch.int32)


def unpack_take(packed: torch.Tensor, s_n: int) -> torch.Tensor:
    """The inverse of `pack_take`: int32 words ``(..., W)`` into bool ``(..., s_n)``."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :s_n].bool()


def taken_steps_plain(take, shifts, final_idx) -> np.ndarray:
    """The backtrack over packed take bits: ``(B, T)`` bool, the steps taken
    on the walk from each knapsack's capacity state (what the kernel's
    backtrack writes)."""
    take = np.asarray(take.cpu() if isinstance(take, torch.Tensor) else take)
    shifts = np.asarray(shifts, dtype=np.int64)
    t_n, b_n, _ = take.shape
    s = np.asarray(final_idx, dtype=np.int64).copy()
    rows = np.arange(b_n)
    taken = np.zeros((b_n, t_n), dtype=bool)
    for t in range(t_n - 1, -1, -1):
        bit = ((take[t, rows, s >> 5].astype(np.int64) >> (s & 31)) & 1).astype(bool)
        taken[:, t] = bit
        s = s - np.where(bit, shifts[:, t], 0)
    return taken


# --------------------------------------------------------------------------
# the DP: plain torch version and the CUDA kernel's wrapper
# --------------------------------------------------------------------------

def knapsack_dp_plain(
    step_values: torch.Tensor,  # (B, T) float64 | float32
    step_weights: torch.Tensor,  # (B, T, D) int64, >= 0
    final_idx: torch.Tensor,  # (B,) int64: each knapsack's capacity state
    levels: Sequence[int],  # (D,) grid levels per dimension
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch DP on whatever device the tensors are on.

    Returns ``(best (B,), take (T, B, ceil(S / 32)) int32)``, take packed
    as `pack_take` packs it.
    """
    dev = step_values.device
    b_n, t_n = step_values.shape
    levels_t = torch.as_tensor(list(levels), dtype=torch.int64, device=dev)
    strides_t = torch.as_tensor(grid_strides(levels), device=dev)
    s_n = int(np.prod(np.asarray(levels, dtype=np.int64)))
    idx = torch.arange(s_n, dtype=torch.int64, device=dev)
    coord = (idx[:, None] // strides_t[None, :]) % levels_t[None, :]  # (S, D)
    shifts = (step_weights * strides_t).sum(dim=-1)  # (B, T) flat-grid shift
    val = torch.zeros((b_n, s_n), dtype=step_values.dtype, device=dev)
    take = torch.empty((t_n, b_n, -(-s_n // 32)), dtype=torch.int32, device=dev)
    for t in range(t_n):
        pred = (idx[None, :] - shifts[:, t, None]).clamp_min(0)
        gathered = torch.gather(val, 1, pred)
        fits = (coord[None, :, :] >= step_weights[:, t, None, :]).all(dim=-1)
        cand = gathered + step_values[:, t, None]
        tk = fits & (cand > val)
        take[t] = pack_take(tk)
        val = torch.where(tk, cand, val)
    best = torch.gather(val, 1, final_idx[:, None])[:, 0]
    return best, take


def _check_inputs(step_values, step_weights, final_idx, levels) -> None:
    if step_values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knapsack_dp: unsupported device {step_values.device}")
    if step_values.dtype not in _DTYPES:
        raise TypeError(f"step_values must be float64 or float32, got {step_values.dtype}")
    for name, t in (("step_weights", step_weights), ("final_idx", final_idx)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
        if t.device != step_values.device:
            raise ValueError(
                f"{name} is on {t.device}, step_values on {step_values.device}"
            )
    if step_values.dim() != 2:
        raise ValueError(f"step_values must be (B, T), got {tuple(step_values.shape)}")
    b_n, t_n = step_values.shape
    d_n = len(levels)
    if b_n < 1:
        raise ValueError("empty batch")
    if not 1 <= d_n <= _MAX_DIMS:
        raise ValueError(f"grid must have 1..{_MAX_DIMS} dimensions, got {d_n}")
    if any(int(lv) < 1 for lv in levels):
        raise ValueError(f"grid levels must be >= 1, got {tuple(levels)}")
    if tuple(step_weights.shape) != (b_n, t_n, d_n):
        raise ValueError(
            f"step_weights must be {(b_n, t_n, d_n)}, got {tuple(step_weights.shape)}"
        )
    if tuple(final_idx.shape) != (b_n,):
        raise ValueError(f"final_idx must be ({b_n},), got {tuple(final_idx.shape)}")


def _packing(levels: Sequence[int]) -> tuple[tuple[int, ...], int]:
    """The kernel's packed coordinates: per dimension, the bit offset of its
    field, and the guard bits.  A dimension of ``L >= 2`` levels has a field
    of ``g = (L - 1).bit_length()`` bits with a guard bit above it; one of
    one level has none (its coordinate and a live step's weight are 0).
    A state packs as ``guards + Σ coord_d << offset_d``, a step's weights
    as ``Σ w_d << offset_d`` (each ``w_d < L_d``), and the step fits the
    state iff every guard survives the subtraction.  The fields take at
    most ``2 log2(S)`` bits."""
    offsets, guards, bit = [], 0, 0
    for level in levels:
        level = int(level)
        offsets.append(bit if level >= 2 else 0)
        if level >= 2:
            g = (level - 1).bit_length()
            guards |= 1 << (bit + g)
            bit += g + 1
    if bit > 64:
        raise KernelError(f"grid {tuple(levels)} needs {bit} bits of packed coordinates")
    return tuple(offsets), guards


def _variant(s_n: int) -> str:
    """The kernel for knapsacks of ``s_n`` states: ``"cluster"`` where the
    row fits in the shared memory of `_MAX_CLUSTER` CTAs, ``"global"`` for
    larger rows."""
    return "cluster" if s_n <= _MAX_CLUSTER * _MAX_SLICE else "global"


def _cluster_size(b_n: int, s_n: int, n_sms: int) -> int:
    """CTAs a knapsack for the ``cluster`` variant: the largest power of two
    up to `_MAX_CLUSTER` that keeps all ``b_n`` clusters in one wave on
    ``n_sms`` SMs, raised to the least whose slices hold the row."""
    c = 1
    while 2 * c <= _MAX_CLUSTER and b_n * 2 * c <= n_sms:
        c *= 2
    while c * _MAX_SLICE < s_n:
        c *= 2
    return c


def _layout(s_n: int, c: int) -> tuple[int, int]:
    """``(CTAs, log2 slice)`` for ``s_n`` states over at most ``c`` CTAs:
    slices of a power of two states, at least 32, and no CTA without
    states."""
    per = -(-s_n // c)
    log2 = max(5, (per - 1).bit_length())
    return -(-s_n // (1 << log2)), log2


_INTS = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [_INTS] * 3 + [
    ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
] + [ctypes.c_void_p] * 7
_VARIANT_CODES = {"cluster": 0, "global": 1}


def _kernel_fn(dtype: torch.dtype):
    from ._build import load_library

    lib = load_library("knapsack")
    fn = lib.knapsack_dp_f64 if dtype == torch.float64 else lib.knapsack_dp_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def knapsack_dp(
    step_values: torch.Tensor,
    step_weights: torch.Tensor,
    final_idx: torch.Tensor,
    levels: Sequence[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pricing DP, dispatched by device:
    ``(best (B,), take (T, B, ceil(S / 32)) int32)``.

    CPU tensors run `knapsack_dp_plain`; CUDA tensors launch the CUDA kernel
    (built on first use) on the current stream, and anything the kernel
    does not take raises: another dtype, device or shape, a negative
    weight or a ``final_idx`` outside the grid (``ValueError`` or
    ``TypeError``, as on the CPU); a non-contiguous tensor or a grid of
    2^31 states or more, which only the kernel refuses (`KernelError`).
    """
    _check_inputs(step_values, step_weights, final_idx, levels)
    # The kernel's reads stay inside the state row only for these values.
    # On the card this costs a device-to-host sync; `price_knapsacks`
    # checks the same on its host arrays instead (`pricing_steps`).
    s_n = int(np.prod(np.asarray(levels, dtype=np.int64)))
    if bool(
        (step_weights < 0).any() | (final_idx < 0).any() | (final_idx >= s_n).any()
    ):
        raise ValueError("step_weights must be >= 0 and final_idx inside the grid")
    best, take, _taken = _dispatch(step_values, step_weights, final_idx, levels)
    return best, take


def _refusals(step_values, step_weights, final_idx, s_n: int) -> None:
    """What the kernel refuses and the plain DP takes, raised as
    `KernelError` (so that no pricing catch-all takes it for a blow-up): a
    non-contiguous tensor, a grid of `_MAX_STATES` states or more.  A grid
    whose coordinates do not pack into 64 bits is refused by `_packing`."""
    for name, t in (("step_values", step_values), ("step_weights", step_weights),
                    ("final_idx", final_idx)):
        if not t.is_contiguous():
            raise KernelError(f"knapsack_dp: {name} must be contiguous")
    if s_n >= _MAX_STATES:
        raise KernelError(f"knapsack_dp: the kernel takes grids of fewer than "
                          f"{_MAX_STATES} states, got {s_n}")


def _dispatch(step_values, step_weights, final_idx, levels):
    """`knapsack_dp` after its checks: ``(best, take, taken)``.  On the CPU
    the plain version, with ``taken`` None; on the card the kernel, with
    ``taken`` the (B, T) bool mask of its backtrack, and ``best`` and
    ``taken`` views of one byte buffer (one copy to the host)."""
    global LAUNCHES
    dev = step_values.device
    s_n = int(np.prod(np.asarray(levels, dtype=np.int64)))
    if dev.type == "cpu":
        best, take = knapsack_dp_plain(step_values, step_weights, final_idx, levels)
        return best, take, None
    _refusals(step_values, step_weights, final_idx, s_n)
    b_n, t_n = step_values.shape
    d_n = len(levels)
    variant = _variant(s_n)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_ctas, log2 = (_layout(s_n, _cluster_size(b_n, s_n, sm_count(index)))
                    if variant == "cluster" else (1, 0))
    offsets, guards = _packing(levels)
    ints = ctypes.c_int * d_n
    fn = _kernel_fn(step_values.dtype)
    with torch.cuda.device(dev):
        steps = torch.empty((b_n, t_n, 2), dtype=torch.int64, device=dev)
        if variant == "global":
            coords = torch.empty((s_n,), dtype=torch.int64, device=dev)
            scratch = torch.empty((b_n, 2, s_n), dtype=step_values.dtype, device=dev)
        take = torch.empty((t_n, b_n, -(-s_n // 32)), dtype=torch.int32, device=dev)
        out = torch.empty((b_n * 8 + b_n * t_n,), dtype=torch.uint8, device=dev)
        best = out[: b_n * step_values.element_size()].view(step_values.dtype)
        taken = out[b_n * 8:].view(torch.bool).view(b_n, t_n)
        rc = fn(
            _VARIANT_CODES[variant], n_ctas, log2,
            step_values.data_ptr(), step_weights.data_ptr(), final_idx.data_ptr(),
            ints(*(int(v) for v in levels)), ints(*(int(v) for v in grid_strides(levels))),
            ints(*offsets), guards, d_n, b_n, t_n, s_n,
            steps.data_ptr(),
            coords.data_ptr() if variant == "global" else None,
            scratch.data_ptr() if variant == "global" else None,
            take.data_ptr(), taken.data_ptr(), best.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"knapsack_dp kernel launch failed ({variant}): CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant] += 1
    return best, take, taken


def _fetch(best: torch.Tensor, taken: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """``best`` and the mask of steps taken on the host, in one copy of the
    byte buffer both are views of (`_dispatch`)."""
    b_n, t_n = taken.shape
    raw = torch.empty(0, dtype=torch.uint8, device=best.device).set_(
        best.untyped_storage(), 0, (b_n * 8 + b_n * t_n,)).cpu()
    best_h = raw[: b_n * best.element_size()].view(best.dtype).numpy()
    return best_h, raw[b_n * 8:].view(torch.bool).view(b_n, t_n).numpy()


# --------------------------------------------------------------------------
# host side: binary split, transfer, backtrack
# --------------------------------------------------------------------------

def _backtrack(take, shifts, step_entry, step_mult, final_idx, e_n):
    """Walk the recorded take bits into per-entry counts (B, E)."""
    t_n, b_n, _ = take.shape
    counts = np.zeros((b_n, e_n), dtype=np.int64)
    for b in range(b_n):
        s = int(final_idx[b])
        for t in range(t_n - 1, -1, -1):
            if take[t, b, s]:
                e = int(step_entry[b, t])
                if e >= 0:
                    counts[b, e] += int(step_mult[b, t])
                s -= int(shifts[b, t])
    return counts


@dataclasses.dataclass(frozen=True)
class PricingSteps:
    """The DP's inputs for one batch, on the host."""

    step_values: np.ndarray  # (B, T) values of the 0/1 pseudo-steps
    step_weights: np.ndarray  # (B, T, D) int64 grid weights
    step_entry: np.ndarray  # (B, T) entry index per step (-1 = padding)
    step_mult: np.ndarray  # (B, T) copies per step
    shifts: np.ndarray  # (B, T) int64 flat-grid shift per step (backtrack)
    final_idx: np.ndarray  # (B,) int64 flat capacity state per knapsack
    levels: tuple[int, ...]  # (D,) shared grid levels per dimension

    @property
    def states(self) -> int:
        return int(np.prod(np.asarray(self.levels, dtype=np.int64)))

    def to(self, device) -> tuple:
        """``knapsack_dp``'s arguments on ``device``."""

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return (
            put(self.step_values), put(self.step_weights), put(self.final_idx),
            self.levels,
        )

    def counts(self, take: np.ndarray, e_n: int) -> np.ndarray:
        """Backtrack take bits (T, B, S) into per-entry counts (B, E)."""
        return _backtrack(
            take, self.shifts, self.step_entry, self.step_mult,
            self.final_idx, e_n,
        )

    def counts_from_taken(self, taken: np.ndarray, e_n: int) -> np.ndarray:
        """Per-entry counts (B, E) from the (B, T) mask of steps taken."""
        counts = np.zeros((self.step_entry.shape[0], e_n), dtype=np.int64)
        b_idx, t_idx = np.nonzero(taken)
        entry = self.step_entry[b_idx, t_idx]
        keep = entry >= 0  # padding steps are never taken; kept out all the same
        np.add.at(counts, (b_idx[keep], entry[keep]), self.step_mult[b_idx, t_idx][keep])
        return counts


def pricing_steps(
    values: np.ndarray,
    weights: np.ndarray,
    bounds: np.ndarray,
    cap_levels: np.ndarray,
) -> PricingSteps:
    """Binary-split a pricing batch onto its shared grid (host side)."""
    values = np.asarray(values)
    weights = np.asarray(weights, dtype=np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    cap_levels = np.asarray(cap_levels, dtype=np.int64)
    # Entries that cannot fit even once are dropped via a zero bound.
    fits_once = (weights <= cap_levels[:, None, :]).all(axis=-1)
    bounds = np.where(fits_once, bounds, 0)
    step_values, step_weights, step_entry, step_mult = build_pricing_steps(
        values, weights, bounds
    )
    if (step_weights < 0).any() or (cap_levels < 0).any():
        raise ValueError("weights and cap_levels must be >= 0")
    levels = cap_levels.max(axis=0) + 1
    strides = grid_strides(levels)
    return PricingSteps(
        step_values=step_values,
        step_weights=step_weights,
        step_entry=step_entry,
        step_mult=step_mult,
        shifts=step_weights @ strides,
        final_idx=(cap_levels * strides[None, :]).sum(axis=1),
        levels=tuple(levels.tolist()),
    )


def price_knapsacks(
    values: np.ndarray,
    weights: np.ndarray,
    bounds: np.ndarray,
    cap_levels: np.ndarray,
    device: "str | torch.device | None" = None,
) -> PricingResult:
    """Solve a batch of bounded multi-dim knapsacks, returning argmax counts.

    ``values (B, E) >= 0`` dual value per entry (float64 or float32);
    ``weights (B, E, D)`` integer grid units; ``bounds (B, E)`` max copies;
    ``cap_levels (B, D)`` per-problem capacity in grid units.  The DP runs
    on ``device`` (default: the card, see `resolve_device`); ``best`` and
    ``counts`` are bit-identical on every device.
    """
    dev = resolve_device(device)
    values = np.asarray(values)
    b_n, e_n = values.shape
    if b_n == 0 or e_n == 0:
        return PricingResult(
            np.zeros(b_n, dtype=values.dtype),
            np.zeros((b_n, e_n), dtype=np.int64), 0, 0,
        )
    steps = pricing_steps(values, weights, bounds, cap_levels)
    t_n = steps.step_values.shape[1]
    if t_n == 0:
        return PricingResult(
            np.zeros(b_n, dtype=values.dtype),
            np.zeros((b_n, e_n), dtype=np.int64), steps.states, 0,
        )
    # pricing_steps checked the weights and capacities on the host, so the
    # DP skips `knapsack_dp`'s check on the card.
    with on_card(dev, "knapsack_dp"):
        args = steps.to(dev)
        _check_inputs(*args)
        best, take, taken = _dispatch(*args)
        if taken is None:  # the CPU: the host backtrack walks the plain version's bits
            counts = steps.counts(unpack_take(take, steps.states).numpy(), e_n)
            return PricingResult(best.numpy(), counts, steps.states, t_n)
        best_h, taken_h = _fetch(best, taken)
    return PricingResult(best_h, steps.counts_from_taken(taken_h, e_n), steps.states, t_n)
