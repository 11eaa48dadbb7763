"""gemma2-27b [dense] (port of ``src/repro/configs/gemma2_27b.py``) — arXiv:2408.00118.

46L, d_model=4608, 32 heads (GQA kv=16), d_ff=36864, vocab=256000.
Alternating local(4096-window)/global attention, logit softcapping
(attn 50.0, final 30.0), sandwich (post) norms, GeGLU, embeddings scaled
by sqrt(d_model), query scale 1/sqrt(query_pre_attn_scalar=144).
"""

from repro_torch.configs.base import ModelConfig, register


@register("gemma2-27b")
def gemma2_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        source="arXiv:2408.00118",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256_000,
        block_pattern=("local", "global"),
        window_size=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_scale=144.0**-0.5,  # query_pre_attn_scalar = d_model / num_heads
        act="gelu",
        gated_mlp=True,
        use_post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
    )
