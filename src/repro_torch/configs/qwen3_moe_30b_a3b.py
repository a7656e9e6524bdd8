"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8 routing.

Source: hf:Qwen/Qwen3-30B-A3B. 48 layers, d_model 2048, 32 heads GQA kv=4
(head_dim 128, QK-norm), expert d_ff 768, vocab 151936, 128 experts top-8
with renormalized routing. Every layer is attention + MoE FFN.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    layer_pattern=("moe",),
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_activation="silu",
    gated_mlp=True,
    num_experts=128,
    experts_per_token=8,
    moe_capacity_factor=1.25,
    tie_embeddings=False,
    long_context_window=4096,  # -sw variant switch for long_500k
)
