"""Hand-written CUDA kernels of the port, each beside its plain torch version.

  * knapsack — the batched bounded knapsack DP that prices colgen's columns
    (``csrc/knapsack.cu``, built on first use by ``_build``)

Kernel libraries are built and loaded inside the call that launches them,
never at import.
"""
