"""nemotron-4-15b [dense] — GQA with squared-ReLU MLP.

Source: Nemotron-4 [arXiv:2402.16819]. 32 layers, d_model 6144, 48 heads
GQA kv=8 (head_dim 128), d_ff 24576 (non-gated, squared ReLU),
vocab 256000, untied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=256_000,
    layer_pattern=("attention",),
    mlp_activation="relu2",
    gated_mlp=False,
    tie_embeddings=False,
    long_context_window=4096,  # -sw variant switch for long_500k
)
