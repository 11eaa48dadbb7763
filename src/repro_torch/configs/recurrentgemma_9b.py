"""recurrentgemma-9b [hybrid] (port of ``src/repro/configs/recurrentgemma_9b.py``) — arXiv:2402.19427 (Griffin).

38L, d_model=4096, 16 heads (GQA kv=1, i.e. MQA) with head_dim=256,
d_ff=12288, vocab=256000.  Pattern: (recurrent, recurrent, local) — the
paper's 1 local-attention layer per 2 RG-LRU layers; window 2048.
lru_width = d_model = 4096.  38 = 12 x 3 + 2 remainder recurrent layers.
"""

from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        source="arXiv:2402.19427",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        block_pattern=("recurrent", "recurrent", "local"),
        window_size=2048,
        lru_width=4096,
        ssm_conv=4,
        act="gelu",
        gated_mlp=True,
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
    )
