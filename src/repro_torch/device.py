"""Device selection for the port's entry points.

The port runs on the card by default.  The CPU is used only when a caller
asks for it by name, as the CPU tests do; there is no silent fallback.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card, ``cuda:0``, and raises when torch sees no CUDA
    device.  ``"cpu"`` (or any explicit device) is returned as given; an
    explicit CUDA device also raises when no card is present.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
