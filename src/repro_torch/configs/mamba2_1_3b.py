"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

Source: Mamba-2 [arXiv:2405.21060]. 48 layers, d_model 2048, expand 2
(d_inner 4096), head_dim 64 (64 SSD heads), state 128, conv width 4,
vocab 50280. No attention, no MLP — each layer is one Mamba-2 block.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv_width=4,
    tie_embeddings=True,
    # Sub-quadratic natively: long_500k runs the recurrent decode path.
)
