"""Analytic roofline terms of a model configuration.

The analytic half of `repro/roofline/analysis.py` (its lines 30-38 and
112-139): the hardware record and the per-token model FLOPs, KV-cache and
HBM byte counts that the serving launcher's profile is built from.  The
reference's `parse_collectives` and `roofline_terms` read XLA HLO and wait
for the launch-and-sharding slice (ROADMAP queue A).

`HW` is the reference's default hardware record, a TPU v5e, kept because
the launcher's profile (and so the manager's plan) is defined against it;
it describes no measurement of the port.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "HW",
    "Hardware",
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
