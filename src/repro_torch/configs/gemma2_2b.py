"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

Source: Gemma 2 technical report [arXiv:2408.00118]. 26 layers, d_model
2304, 8 query heads with GQA kv=4 (head_dim 256), d_ff 9216 (GeGLU),
vocab 256000, sliding window 4096 on alternating (local) layers, attention
logit softcap 50, final logit softcap 30, embeddings scaled by sqrt(d).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=("attention", "attention"),
    window_pattern=(4096, None),  # local, global alternating
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    embed_scale_by_sqrt_dim=True,
    # long_500k: local layers are windowed natively; global layers hold the
    # full KV, sharded over the data axis (DESIGN.md long-context policy).
)
