"""Hand-written CUDA kernels of the port, each beside its plain torch version.

  * knapsack — the batched bounded knapsack DP that prices colgen's columns
    (``csrc/knapsack.cu``)
  * attention — causal flash attention with GQA, sliding window and logit
    softcap, the serving path's prefill (``csrc/flash_attention.cu``)
    and its backward, the training step's attention gradient
    (``csrc/flash_attention_bwd.cu``)
  * decode_attention — flash-decode over a (ring) KV cache, the serving
    path's decode step (``csrc/decode_attention.cu``)
  * ssd — the Mamba-2 SSD chunked scan, the ``"ssd"`` block's prefill
    (``csrc/ssd.cu``)
  * rglru — the RG-LRU linear recurrence, the ``"recurrent"`` block's
    prefill (``csrc/rglru.cu``)
  * grouped_gemm — the ragged expert GEMM, the ``"moe"`` block's expert
    products (``csrc/grouped_gemm.cu``)
  * pack — the FFD/BFD scan over many fleets, the live controller's what-if
    packer (``csrc/pack.cu``)
  * placement — the best-fit placement scores of the controller's greedy
    repair (``csrc/placement.cu``)

Each source is built on first use by ``_build``.  Kernel libraries are
built and loaded inside the call that launches them, never at import.
"""
