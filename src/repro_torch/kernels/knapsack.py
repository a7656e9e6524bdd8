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
most once.  The take bits are recorded per step and backtracked on the
host into per-entry counts (the actual pattern / column).

Two implementations of the DP share this exact op sequence and are
bit-identical in ``best`` and the take bits (adds and compares only):

* `knapsack_dp_plain` — plain torch, a Python loop over steps vectorized
  over the batch with `torch.gather`; runs on any device,
* the CUDA kernel in ``csrc/knapsack.cu`` (one CTA per knapsack, state row
  in global ping-pong buffers), which replaces the TPU kernel
  `repro/kernels/knapsack.py:_pallas_body/_pallas_call`.

`knapsack_dp` dispatches by the device of its tensors: CPU tensors go to
the plain version, CUDA tensors launch the kernel (or raise).
`price_knapsacks` is the numpy-facing entry point colgen calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "LAUNCHES",
    "PricingResult",
    "PricingSteps",
    "build_pricing_steps",
    "grid_strides",
    "knapsack_dp",
    "knapsack_dp_plain",
    "price_knapsacks",
    "pricing_steps",
]

#: Number of CUDA kernel launches made by `knapsack_dp` in this process.
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()  # allocate_sweep(parallel=True) prices from threads

_MAX_DIMS = 32  # kMaxDims in csrc/knapsack.cu
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
# the DP: plain torch version and the CUDA kernel's wrapper
# --------------------------------------------------------------------------

def knapsack_dp_plain(
    step_values: torch.Tensor,  # (B, T) float64 | float32
    step_weights: torch.Tensor,  # (B, T, D) int64, >= 0
    final_idx: torch.Tensor,  # (B,) int64: each knapsack's capacity state
    levels: Sequence[int],  # (D,) grid levels per dimension
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch DP on whatever device the tensors are on.

    Returns ``(best (B,), take (T, B, S) bool)``.
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
    take = torch.empty((t_n, b_n, s_n), dtype=torch.bool, device=dev)
    for t in range(t_n):
        pred = (idx[None, :] - shifts[:, t, None]).clamp_min(0)
        gathered = torch.gather(val, 1, pred)
        fits = (coord[None, :, :] >= step_weights[:, t, None, :]).all(dim=-1)
        cand = gathered + step_values[:, t, None]
        tk = fits & (cand > val)
        take[t] = tk
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


_ARGTYPES = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


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
    """The pricing DP, dispatched by device: ``(best (B,), take (T, B, S))``.

    CPU tensors run `knapsack_dp_plain`; CUDA tensors launch the CUDA kernel
    (built on first use) on the current stream, and anything the kernel
    does not take raises: another dtype, device or shape, a non-contiguous
    tensor, a negative weight or a ``final_idx`` outside the grid.
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
    return _dispatch(step_values, step_weights, final_idx, levels)


def _dispatch(step_values, step_weights, final_idx, levels):
    """`knapsack_dp` after its checks: the plain version or the kernel."""
    global LAUNCHES
    dev = step_values.device
    s_n = int(np.prod(np.asarray(levels, dtype=np.int64)))
    if dev.type == "cpu":
        return knapsack_dp_plain(step_values, step_weights, final_idx, levels)
    for name, t in (("step_values", step_values), ("step_weights", step_weights),
                    ("final_idx", final_idx)):
        if not t.is_contiguous():
            raise ValueError(f"knapsack_dp: {name} must be contiguous")
    b_n, t_n = step_values.shape
    fn = _kernel_fn(step_values.dtype)
    with torch.cuda.device(dev):
        levels_t = torch.as_tensor(list(levels), dtype=torch.int64, device=dev)
        strides_t = torch.as_tensor(grid_strides(levels), device=dev)
        scratch = torch.empty((b_n, 2, s_n), dtype=step_values.dtype, device=dev)
        take = torch.empty((t_n, b_n, s_n), dtype=torch.bool, device=dev)
        best = torch.empty((b_n,), dtype=step_values.dtype, device=dev)
        rc = fn(
            step_values.data_ptr(), step_weights.data_ptr(),
            levels_t.data_ptr(), strides_t.data_ptr(), final_idx.data_ptr(),
            scratch.data_ptr(), take.data_ptr(), best.data_ptr(),
            b_n, t_n, s_n, len(levels), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"knapsack_dp kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return best, take


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
    args = steps.to(dev)
    _check_inputs(*args)
    best, take = _dispatch(*args)
    counts = steps.counts(take.cpu().numpy(), e_n)
    return PricingResult(best.cpu().numpy(), counts, steps.states, t_n)
