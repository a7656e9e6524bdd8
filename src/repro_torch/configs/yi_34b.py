"""yi-34b [dense] — llama-architecture GQA.

Source: Yi [arXiv:2403.04652]. 60 layers, d_model 7168, 56 heads GQA kv=8
(head_dim 128), d_ff 20480 (SwiGLU), vocab 64000, rope theta 5e6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    layer_pattern=("attention",),
    rope_theta=5_000_000.0,
    mlp_activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    long_context_window=4096,  # -sw variant switch for long_500k
)
