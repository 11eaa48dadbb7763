"""stablelm-1.6b [dense] (port of ``src/repro/configs/stablelm_1_6b.py``) — hf:stabilityai/stablelm-2-1_6b.

24L, d_model=2048, 32 heads (kv=32, MHA), d_ff=5632, vocab=100352.
LayerNorm (not RMSNorm), SwiGLU MLP, rope theta 10000 (partial-rotary 25%
in the card is simplified to full rotary here — as in the reference config),
tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


@register("stablelm-1.6b")
def stablelm_1_6b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100_352,
        block_pattern=("global",),
        norm_type="layernorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
    )
