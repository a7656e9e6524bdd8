"""PyTorch/CUDA port of the network-camera cloud resource manager.

The package mirrors the layout of the JAX reference package `repro`
(`repro_torch/core/binpack/colgen.py` ↔ `repro/core/binpack/colgen.py`,
and so on) but imports only torch and numpy.  Host-side solver code keeps
the reference's numpy float64 arithmetic; torch and the card come in where
the reference dispatched device code: the knapsack pricing DP of
branch-and-price (`repro_torch.kernels.knapsack`), a hand-written CUDA
kernel for Hopper.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); see `repro_torch.device.resolve_device`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
