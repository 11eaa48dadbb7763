"""whisper-large-v3 [audio] (port of ``src/repro/configs/whisper_large_v3.py``) — arXiv:2212.04356.

Encoder-decoder: 32 encoder + 32 decoder layers, d_model=1280, 20 heads
(kv=20, MHA), d_ff=5120, vocab=51866.  LayerNorm, non-gated GeLU MLPs,
absolute sinusoidal positions (no RoPE).  The mel-spectrogram + conv
frontend is a STUB as in the reference: ``data.make_batch_for`` provides
1500 frame embeddings of shape (batch, 1500, d_model).
"""

from repro_torch.configs.base import ModelConfig, register


@register("whisper-large-v3")
def whisper_large_v3() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51_866,
        block_pattern=("global",),
        norm_type="layernorm",
        act="gelu",
        gated_mlp=False,
        use_rope=False,
        tie_embeddings=True,
        is_encoder_decoder=True,
        num_encoder_layers=32,
        encoder_positions=1500,
        frontend="audio",
    )
