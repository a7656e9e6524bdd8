"""grok-1-314b [moe] — 8 experts, top-2 routing.

Source: hf:xai-org/grok-1. 64 layers, d_model 6144, 48 heads GQA kv=8
(head_dim 128), expert d_ff 32768 (GeGLU), vocab 131072, 8 experts top-2,
attention logit softcap 30 (tanh), untied embeddings.

Sharding note (DESIGN.md §5): 8 experts do not divide the 16-way model
axis, so grok shards the expert *hidden* dim (tensor parallel inside each
expert) instead of the expert dim.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    layer_pattern=("moe",),
    attn_logit_softcap=30.0,
    mlp_activation="gelu",
    gated_mlp=True,
    num_experts=8,
    experts_per_token=2,
    moe_capacity_factor=1.25,
    tie_embeddings=False,
    long_context_window=4096,  # -sw variant switch for long_500k
)
