"""Analytic roofline terms of a model configuration.

The analytic half of `repro/roofline/analysis.py` (its lines 30-38 and
91-139): the hardware records, the three-term roofline, and the per-token
model FLOPs, KV-cache and HBM byte counts that the serving launcher's
profile is built from.

`HW` is the reference's default hardware record, a TPU v5e, kept because
the launcher's profile (and so the manager's plan) is defined against it;
it describes no measurement of the port.  `H100` is the card the port
runs on, at the peaks `chip_smoke.py`'s bounds use; the dry-run
(`repro_torch.launch.dryrun`) computes its terms against it.

The reference's `parse_collectives` reads the collectives out of XLA's
partitioned HLO.  No compiler partitions the port's program, so there is
nothing to parse: the dry-run counts the collectives its sharded step
issues on meta shards (`repro_torch.sharding.parallel.CollectiveCounter`,
per device, result bytes, as `parse_collectives` sums them) and feeds
their bytes into `roofline_terms`.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "HW",
    "H100",
    "H100_MEMORY_BYTES",
    "Hardware",
    "roofline_terms",
    "model_flops",
    "model_kv_bytes",
    "model_hbm_bytes",
]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    link_bw: float = 50e9  # bytes/s per ICI link


HW = Hardware()

#: One NVIDIA H100 80GB HBM3 (SXM) at 700 W: dense bf16 tensor-core peak,
#: HBM3 rate, and NVLink 4's 450 GB/s a direction over all its links (so
#: ``links_per_chip=1``); its device memory below.
H100 = Hardware(name="h100-80gb-hbm3-700w", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
H100_MEMORY_BYTES = 80e9


def roofline_terms(
    *,
    hlo_flops_per_device: float,
    hlo_bytes_per_device: float,
    collective_bytes_per_device: float,
    hw: Hardware = HW,
    links_per_chip: int = 4,
) -> dict[str, float]:
    """Seconds of compute, memory and collective traffic per device, and
    the dominant term.  All inputs are per device."""
    compute = hlo_flops_per_device / hw.peak_flops
    memory = hlo_bytes_per_device / hw.hbm_bw
    collective = collective_bytes_per_device / (links_per_chip * hw.link_bw)
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    terms["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    )
    return terms


def model_flops(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D with N = active params (MoE: top-k only)."""
    return 6.0 * cfg.active_param_count() * tokens


def model_kv_bytes(cfg, tokens: int) -> float:
    """Analytic KV-cache bytes for ``tokens`` cached positions (bf16 K+V).

    Counts the attention-bearing slots of the layer pattern ("attention"
    and "moe" blocks carry ring buffers; SSD/recurrent states are
    ``tokens``-independent and excluded).  The serving-side count is
    `repro_torch.serving.kvcache.slot_kv_bytes` (which adds the position
    buffers), so this analytic form is its lower bound.
    """
    attn_slots = sum(1 for k in cfg.layer_pattern if k in ("attention", "moe"))
    per_token = attn_slots * 2.0 * cfg.num_kv_heads * cfg.resolved_head_dim * 2.0
    return cfg.num_groups * per_token * tokens


def model_hbm_bytes(cfg, tokens: int) -> float:
    """Analytic per-frame HBM traffic for a ``tokens``-token prefill.

    Weights stream through once (bf16) and the KV cache is written — the
    two roofline memory terms of analyzing one camera frame with a
    captioning/VQA model.  Activation traffic is ignored.
    """
    return 2.0 * cfg.active_param_count() + model_kv_bytes(cfg, tokens)
