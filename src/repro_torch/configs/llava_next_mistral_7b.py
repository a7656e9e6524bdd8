"""llava-next-mistral-7b [vlm] — anyres tiling over a Mistral-7B backbone.

Source: hf:llava-hf/llava-v1.6-mistral-7b-hf. Backbone: 32 layers, d_model
4096, 32 heads GQA kv=8 (head_dim 128), d_ff 14336 (SwiGLU), vocab 32000.
The SigLIP/CLIP vision tower is the stubbed frontend; ``input_specs``
supplies precomputed patch embeddings (anyres: up to 2880 tokens = 5 tiles
x 576 patches) which the projector maps into d_model before the prefix.
Note: the v0.2 Mistral base ships sliding_window=null, so long_500k runs
only as the explicit -sw variant (window 4096, the v0.1 Mistral window).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    layer_pattern=("attention",),
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    modality="vision_prefix",
    vision_tokens=2880,  # anyres: 5 tiles x 24x24 patches
    long_context_window=4096,
)
