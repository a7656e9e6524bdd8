"""Device selection for the port's entry points.

The port runs on the card by default.  The CPU is used only when a caller
asks for it by name, as the CPU tests do; there is no silent fallback.
Where the port's device work cannot run (no card, a kernel that fails to
build or to launch) it raises `KernelError`, the one exception that no
catch-all of the port swallows.
"""
from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["KernelError", "local_card", "on_card", "resolve_device", "sm_count"]


class KernelError(RuntimeError):
    """The port's device work cannot run: no card, or a kernel that fails
    to build or to launch.  Pricing's catch-all for blow-ups (the
    controllers' "no prices" fallback) lets this type through, and only
    this type: every other error prices nothing, as in the reference."""


def local_card() -> int:
    """The card of this process: ``cuda:0``, or, in an initialized process
    group on a host with several cards, this rank's own, ``LOCAL_RANK``'s
    (as ``torchrun`` sets it; else the rank modulo the cards).  Ranks that
    share one card all get ``cuda:0``."""
    import os

    import torch.distributed as dist

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards <= 1 or not dist.is_initialized():
        return 0
    local = os.environ.get("LOCAL_RANK")
    return (int(local) if local is not None else dist.get_rank()) % cards


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card, `local_card`'s (``cuda:0`` on a host with one),
    and raises when torch sees no CUDA device.  ``"cpu"`` (or any explicit
    device) is returned as given; an explicit CUDA device also raises
    (`KernelError`) when no card is present.
    """
    if device is None and not torch.cuda.is_available():
        device = "cuda:0"
    dev = torch.device(f"cuda:{local_card()}" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KernelError(
            f"device {dev} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index`` (the
    kernels' wrappers size their grids by it)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@contextlib.contextmanager
def on_card(device: torch.device, what: str):
    """The device section of a kernel's call (copies in, launch, copy back).

    On the card, a torch ``RuntimeError`` raised inside it (a kernel that
    faulted after its launch returned, surfacing at the copy back; a failed
    allocation of its buffers) is re-raised as `KernelError`, so that no
    catch-all takes a kernel fault for a pricing blow-up.  On the CPU it
    changes nothing.
    """
    if device.type != "cuda":
        yield
        return
    try:
        yield
    except KernelError:
        raise
    except RuntimeError as e:
        raise KernelError(f"{what} on {device}: {e}") from e
