"""Multiple-choice FFD/BFD scan over many fleets — the what-if packing kernel.

Replaces the reference's jax-traced scan `repro/core/binpack/heuristics.py`
``_pack_core`` (a ``lax.scan`` over items, vmapped over fleets and fanned
over devices by ``jax.pmap``).  For each fleet ``b`` and step ``s`` the item
``i = order[b, s]`` tries its choices against every open bin: first fit
takes the first fitting (bin, choice) pair, flattened bin-major; best fit
the pair of least residual slack, the first of equals.  With none fitting,
the (bin type, choice) of least ``open_score[b, i]``, flattened type-major,
opens a bin.  An item whose choice mask is all False is a padding item: it
changes nothing and its records are -1.  The arithmetic is the numpy
packer's (`core.binpack.heuristics._pack_raw`) in float64:

* ``new_load = load + req`` per dimension, and a fit is ``new_load <= cap +
  1e-9`` in every dimension, padded choices never fitting;
* slack is ``max_d (cap - new_load) / max(cap, 1e-300)``;
* ``total_cost`` adds the opened types' costs in step order, the order in
  which ``Solution.cost`` sums its bins, and the way it does: Python's
  ``sum`` over floats is Neumaier's compensated sum (Python 3.12 and
  later), a running sum ``s`` and a compensation ``c`` added to it at the
  end (`neumaier_add`).

Two implementations, bit-identical:

* `pack_scan_plain` — plain torch, a Python loop over the steps vectorised
  over the fleets; runs on any device;
* the CUDA kernel in ``csrc/pack.cu``: one CTA a fleet, its threads over the
  (open bin, choice) pairs of a step, a block reduction on (score, pair) for
  the first-occurrence argmin.  Two variants, picked by shape before the
  launch (`_variant`): ``"shared"`` keeps the open bins' loads and
  capacities in shared memory; ``"global"`` keeps them in a global scratch
  where a fleet's ``2 n dim`` doubles outgrow it.

`pack_scan` dispatches by the device of its tensors: CPU tensors go to the
plain version, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

__all__ = ["LAUNCHES", "LAUNCHES_BY_VARIANT", "pack_scan", "pack_scan_plain"]

#: Number of CUDA kernel launches made by `pack_scan` in this process.
LAUNCHES = 0
#: The same launches by variant (`_variant`).
LAUNCHES_BY_VARIANT = {"shared": 0, "global": 0}
_LAUNCHES_LOCK = threading.Lock()

_FIT_EPS = 1e-9  # heuristics._FIT_EPS
_VARIANT_CODES = {"shared": 0, "global": 1}


def pack_scan_plain(req, mask, open_score, order, caps, costs, *, best_fit: bool):
    """Plain torch scan on whatever device the tensors are on.

    ``req (B, n, C, dim)`` float64 (+inf padded), ``mask (B, n, C)`` bool,
    ``open_score (B, n, n_bt, C)`` float64, ``order (B, n)`` int64, ``caps
    (n_bt, dim)`` and ``costs (n_bt,)`` float64.  Returns ``((bin_rec,
    choice_rec, bt_rec) (B, n) int64, n_open (B,) int64, total_cost (B,)
    float64)``, the records in step order.
    """
    dev = req.device
    b_n, n, c_n, dim = req.shape
    rows = torch.arange(b_n, device=dev)
    loads = torch.zeros((b_n, n, dim), dtype=req.dtype, device=dev)
    caps_open = torch.zeros((b_n, n, dim), dtype=req.dtype, device=dev)
    open_mask = torch.zeros((b_n, n), dtype=torch.bool, device=dev)
    n_open = torch.zeros(b_n, dtype=torch.int64, device=dev)
    total = torch.zeros(b_n, dtype=req.dtype, device=dev)
    comp = torch.zeros(b_n, dtype=req.dtype, device=dev)
    recs = [torch.full((b_n, n), -1, dtype=torch.int64, device=dev) for _ in range(3)]
    inf = torch.tensor(float("inf"), dtype=req.dtype, device=dev)
    for s in range(n):
        item = order[:, s]
        req_i = req[rows, item]  # (B, C, dim)
        mask_i = mask[rows, item]  # (B, C)
        score_i = open_score[rows, item].reshape(b_n, -1)  # (B, n_bt * C), type-major
        valid = mask_i.any(dim=1)
        new_loads = loads[:, :, None, :] + req_i[:, None, :, :]  # (B, n, C, dim)
        cap = caps_open[:, :, None, :]
        fit = ((new_loads <= cap + _FIT_EPS).all(dim=-1)
               & mask_i[:, None, :] & open_mask[:, :, None]).reshape(b_n, -1)
        if best_fit:
            slack = ((cap - new_loads) / cap.clamp_min(1e-300)).amax(dim=-1).reshape(b_n, -1)
            pos = torch.where(fit, slack, inf).argmin(dim=1)
        else:
            pos = fit.to(torch.int8).argmax(dim=1)
        npos = score_i.argmin(dim=1)
        any_fit = fit.any(dim=1)
        use_open = valid & any_fit
        opened_now = valid & ~any_fit
        choice = torch.where(use_open, pos % c_n, npos % c_n)
        bin_i = torch.where(use_open, pos // c_n, n_open)
        bt = npos // c_n
        at = torch.where(valid, bin_i, 0)
        delta = torch.where(valid[:, None], req_i[rows, choice], 0.0)
        loads[rows, at] = loads[rows, at] + delta
        slot = n_open.clamp(max=n - 1)
        caps_open[rows, slot] = torch.where(opened_now[:, None], caps[bt], caps_open[rows, slot])
        open_mask[rows, slot] = open_mask[rows, slot] | opened_now
        t_new, c_new = neumaier_add(total, comp, costs[bt])
        total = torch.where(opened_now, t_new, total)
        comp = torch.where(opened_now, c_new, comp)
        n_open = n_open + opened_now.to(torch.int64)
        recs[0][:, s] = torch.where(valid, bin_i, -1)
        recs[1][:, s] = torch.where(valid, choice, -1)
        recs[2][:, s] = torch.where(opened_now, bt, -1)
    total = torch.where((comp != 0) & comp.isfinite(), total + comp, total)
    return tuple(recs), n_open, total


def neumaier_add(s, c, x):
    """One term of Python's float ``sum`` (Neumaier's compensated sum):
    ``(s + x, c + the rounding error of s + x)``; the sum is ``s + c`` once
    the terms are in, where ``c`` is finite and not 0."""
    t = s + x
    err = torch.where(s.abs() >= x.abs(), (s - t) + x, (x - t) + s)
    return t, c + err


def _check_inputs(req, mask, open_score, order, caps, costs) -> None:
    dev = req.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_scan: unsupported device {dev}")
    for name, t, dtype in (("req", req, torch.float64), ("mask", mask, torch.bool),
                           ("open_score", open_score, torch.float64),
                           ("order", order, torch.int64), ("caps", caps, torch.float64),
                           ("costs", costs, torch.float64)):
        if t.dtype != dtype:
            raise TypeError(f"pack_scan: {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"pack_scan: {name} is on {t.device}, req on {dev}")
    if req.dim() != 4 or min(req.shape) < 1:
        raise ValueError(f"pack_scan: req must be a non-empty (B, n, C, dim), "
                         f"got {tuple(req.shape)}")
    b_n, n, c_n, dim = req.shape
    n_bt = caps.shape[0]
    expect = {"mask": (mask, (b_n, n, c_n)), "open_score": (open_score, (b_n, n, n_bt, c_n)),
              "order": (order, (b_n, n)), "caps": (caps, (n_bt, dim)), "costs": (costs, (n_bt,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"pack_scan: {name} must be {shape}, got {tuple(t.shape)}")
    if n_bt < 1:
        raise ValueError("pack_scan: no bin types")


@functools.cache
def _library():
    from ._build import load_library

    lib = load_library("pack")
    lib.pack_scan_f64.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
    lib.pack_scan_f64.restype = ctypes.c_int
    lib.pack_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.pack_scan_smem_bytes.restype = ctypes.c_longlong
    lib.pack_scan_max_smem.argtypes = []
    lib.pack_scan_max_smem.restype = ctypes.c_longlong
    return lib


def _variant(n: int, c: int, dim: int) -> str:
    """The kernel for fleets of ``n`` items with ``c`` choices over ``dim``
    dimensions: ``"shared"`` where a CTA's shared memory holds the open
    bins' loads and capacities (the library's own byte count), else
    ``"global"``."""
    lib = _library()
    fits = lib.pack_scan_smem_bytes(_VARIANT_CODES["shared"], n, c, dim) <= lib.pack_scan_max_smem()
    return "shared" if fits else "global"


def pack_scan(req, mask, open_score, order, caps, costs, *, best_fit: bool):
    """`pack_scan_plain`'s outputs, dispatched by device.

    CPU tensors run `pack_scan_plain`; CUDA tensors launch the CUDA kernel
    (built on first use) on the current stream, and anything the kernel
    does not take raises: another dtype, device or shape, a non-contiguous
    tensor, an ``order`` entry outside ``[0, n)``.
    """
    _check_inputs(req, mask, open_score, order, caps, costs)
    # The kernel indexes rows by `order`; on the card this check costs a
    # device-to-host sync, so the packers check their host arrays instead.
    if bool(((order < 0) | (order >= req.shape[1])).any()):
        raise ValueError("pack_scan: order entries must lie in [0, n)")
    return _dispatch(req, mask, open_score, order, caps, costs, best_fit)


def _dispatch(req, mask, open_score, order, caps, costs, best_fit):
    """`pack_scan` after its checks: the plain version or the kernel."""
    global LAUNCHES
    dev = req.device
    if dev.type == "cpu":
        return pack_scan_plain(req, mask, open_score, order, caps, costs, best_fit=best_fit)
    for name, t in (("req", req), ("mask", mask), ("open_score", open_score),
                    ("order", order), ("caps", caps), ("costs", costs)):
        if not t.is_contiguous():
            raise ValueError(f"pack_scan: {name} must be contiguous on CUDA")
    b_n, n, c_n, dim = req.shape
    n_bt = caps.shape[0]
    variant = _variant(n, c_n, dim)
    lib = _library()
    with torch.cuda.device(dev):
        scratch = (torch.empty((b_n, 2, n, dim), dtype=torch.float64, device=dev)
                   if variant == "global" else None)
        recs = torch.empty((3, b_n, n), dtype=torch.int64, device=dev)
        n_open = torch.empty(b_n, dtype=torch.int64, device=dev)
        total = torch.empty(b_n, dtype=torch.float64, device=dev)
        rc = lib.pack_scan_f64(
            _VARIANT_CODES[variant], int(bool(best_fit)), req.data_ptr(),
            mask.data_ptr(), open_score.data_ptr(), order.data_ptr(), caps.data_ptr(),
            costs.data_ptr(), b_n, n, c_n, dim, n_bt,
            None if scratch is None else scratch.data_ptr(),
            recs[0].data_ptr(), recs[1].data_ptr(), recs[2].data_ptr(),
            n_open.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"pack_scan kernel launch failed ({variant}): CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant] += 1
    return (recs[0], recs[1], recs[2]), n_open, total
