"""Model configuration covering all assigned architecture families.

A config fully determines the parameter pytree and the forward semantics.
Layers are organized as a repeating *group pattern* (e.g. recurrentgemma's
("recurrent", "recurrent", "attention")) so the stack can be lax.scan'ned
over homogeneous groups, keeping HLO size and compile time flat in depth.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "BlockKind"]

# Block kinds appearing in layer patterns.
BlockKind = str  # "attention" | "moe" | "ssd" | "recurrent"

_VALID_KINDS = {"attention", "moe", "ssd", "recurrent"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    #: Repeating block pattern; length must divide num_layers.
    layer_pattern: tuple[BlockKind, ...] = ("attention",)
    #: Per-pattern-slot sliding window (None = full attention). Aligned with
    #: layer_pattern; ignored for non-attention slots.
    window_pattern: tuple[int | None, ...] | None = None

    # Attention details.
    rope_theta: float = 10_000.0
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    qk_norm: bool = False

    # MLP.
    mlp_activation: str = "silu"  # silu | gelu | relu2
    gated_mlp: bool = True  # SwiGLU-style two-matrix up projection

    # MoE (used when "moe" appears in layer_pattern).
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    #: GShard dispatch groups (per-group capacity/cumsum; align with the
    #: data-axis shard count). 1 = single global group.
    moe_dispatch_groups: int = 16

    # SSM / Mamba-2 (used for "ssd" blocks).
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # RG-LRU / griffin (used for "recurrent" blocks).
    lru_width: int | None = None  # None -> d_model
    rglru_conv_width: int = 4

    # Multimodal frontends (stubbed per the brief).
    modality: str = "text"  # text | audio_tokens | vision_prefix
    num_codebooks: int = 1  # musicgen: parallel EnCodec codebooks
    vision_tokens: int = 0  # llava: number of prefix patch embeddings

    # Norm / embedding details.
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale_by_sqrt_dim: bool = False  # gemma-style embedding scaling

    # Long-context handling: if set, decode for the long_500k shape clamps
    # every full-attention layer to this window (the "-sw" variant switch;
    # DESIGN.md long_500k policy).
    long_context_window: int | None = None

    # Default micro/dry-run knobs.
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: pattern length {len(self.layer_pattern)} "
                f"does not divide num_layers {self.num_layers}"
            )
        bad = set(self.layer_pattern) - _VALID_KINDS
        if bad:
            raise ValueError(f"{self.name}: unknown block kinds {bad}")
        if self.window_pattern is not None and len(self.window_pattern) != len(
            self.layer_pattern
        ):
            raise ValueError(f"{self.name}: window_pattern length mismatch")
        if "moe" in self.layer_pattern and not (
            0 < self.experts_per_token <= self.num_experts
        ):
            raise ValueError(f"{self.name}: bad MoE config")
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")

    # ---- derived quantities -------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def window_for_slot(self, slot: int, *, long_context: bool = False) -> int | None:
        w = self.window_pattern[slot] if self.window_pattern else None
        if long_context and self.long_context_window is not None:
            w = min(w, self.long_context_window) if w else self.long_context_window
        return w

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks); used for
        MODEL_FLOPS = 6*N*D in the roofline report."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * self.num_codebooks  # embeddings
        if not self.tie_embeddings:
            total += self.vocab_size * d * self.num_codebooks
        per_pattern = 0
        for slot, kind in enumerate(self.layer_pattern):
            per_pattern += 2 * d  # pre norms (attn+mlp style blocks carry 2)
            if kind == "attention":
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                per_pattern += q + kv + o
                per_pattern += self._mlp_params(d, self.d_ff)
            elif kind == "moe":
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                per_pattern += q + kv + o
                per_pattern += d * self.num_experts  # router
                per_pattern += self.num_experts * self._mlp_params(d, self.d_ff)
            elif kind == "ssd":
                din, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_heads
                per_pattern += d * (2 * din + 2 * n + h)  # in_proj [z,x,B,C,dt]
                per_pattern += self.ssm_conv_width * (din + 2 * n)
                per_pattern += 3 * h  # A, D, dt_bias
                per_pattern += din * d  # out_proj
            elif kind == "recurrent":
                w = self.resolved_lru_width
                per_pattern += 2 * d * w + w * d  # x/gate in-proj + out
                per_pattern += self.rglru_conv_width * w
                per_pattern += 3 * w  # Lambda + input/rec gate scalar maps (diag approx)
                per_pattern += 2 * w * w // 8  # block-diag gate projections (8 blocks)
                per_pattern += self._mlp_params(d, self.d_ff)
        return total + per_pattern * self.num_groups

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if "moe" not in self.layer_pattern:
            return self.param_count()
        full = self.param_count()
        expert_all = (
            self.num_groups
            * self.layer_pattern.count("moe")
            * self.num_experts
            * self._mlp_params(self.d_model, self.d_ff)
        )
        expert_active = expert_all * self.experts_per_token // self.num_experts
        return full - expert_all + expert_active

    def _mlp_params(self, d: int, ff: int) -> int:
        return (3 if self.gated_mlp else 2) * d * ff
