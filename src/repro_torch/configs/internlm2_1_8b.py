"""internlm2-1.8b [dense] — GQA.

Source: InternLM2 [arXiv:2403.17297]. 24 layers, d_model 2048, 16 heads
GQA kv=8 (head_dim 128), d_ff 8192 (SwiGLU), vocab 92544, rope theta 1e6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    layer_pattern=("attention",),
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    long_context_window=4096,  # -sw variant switch for long_500k
)
