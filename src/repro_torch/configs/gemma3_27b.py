"""gemma3-27b [dense] (port of ``src/repro/configs/gemma3_27b.py``) — hf:google/gemma-3-1b-pt family card, 27B variant.

62L, d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
5:1 local:global layer pattern (window 1024), 128k context, sandwich norms,
no logit softcapping (replaced by qk-norm in gemma3; we keep the plain
scaled dot product and note the simplification), GeGLU, scaled embeddings.

62 = 10 x (5 local + 1 global) + 2 remainder local layers.
"""

from repro_torch.configs.base import ModelConfig, register


@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        source="hf:google/gemma-3-1b-pt (27b card)",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262_144,
        block_pattern=("local", "local", "local", "local", "local", "global"),
        window_size=1024,
        query_scale=168.0**-0.5,  # query_pre_attn_scalar = d_model / num_heads
        act="gelu",
        gated_mlp=True,
        use_post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
