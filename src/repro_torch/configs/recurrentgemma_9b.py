"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attention per 3.

Source: Griffin / RecurrentGemma [arXiv:2402.19427]. 38 layers, d_model
4096, 16 heads MQA kv=1 (head_dim 256), d_ff 12288 (GeGLU), vocab 256000,
local attention window 2048, RG-LRU width 4096.

38 is not divisible by 3, so the repeating pattern is expressed as a
19-slot super-pattern (6 x [rec, rec, attn] + 1 rec) repeated twice —
exactly 38 layers with the paper's 2:1 recurrent:attention mix.
"""
from repro_torch.models.config import ModelConfig

_SUPER = ("recurrent", "recurrent", "attention") * 6 + ("recurrent",)
_WINDOWS = tuple(2048 if k == "attention" else None for k in _SUPER)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    layer_pattern=_SUPER,
    window_pattern=_WINDOWS,
    mlp_activation="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    embed_scale_by_sqrt_dim=True,
    lru_width=4096,
    rglru_conv_width=4,
    # Sub-quadratic natively (window 2048 + recurrent state).
)
