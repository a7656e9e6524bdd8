"""musicgen-large [audio] — decoder-only over EnCodec tokens.

Source: MusicGen [arXiv:2306.05284]. 48 layers, d_model 2048, 32 heads
(MHA: kv=32), d_ff 8192, vocab 2048 per codebook, 4 parallel EnCodec
codebooks (delay-pattern interleave is a data-layout concern handled by the
pipeline; the backbone sums the 4 codebook embeddings and emits 4 heads).
The EnCodec encoder itself is the stubbed modality frontend.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=("attention",),
    mlp_activation="gelu",
    gated_mlp=False,
    tie_embeddings=False,
    modality="audio_tokens",
    num_codebooks=4,
    # Full attention natively; long_500k runs only as the -sw variant.
    long_context_window=4096,
)
