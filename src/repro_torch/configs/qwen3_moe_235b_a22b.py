"""qwen3-moe-235b-a22b [moe] (port of ``src/repro/configs/qwen3_moe_235b_a22b.py``) — hf:Qwen/Qwen3-30B-A3B card family, 235B-A22B.

94L, d_model=4096, 64 heads (GQA kv=4), vocab=151936.  MoE FFN: 128 routed
experts, top-8, per-expert d_ff=1536, no shared experts.  (Qwen3's qk-norm
is simplified to plain scaled dot-product — as in the reference config.)
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-235b-a22b")
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B (235B-A22B card)",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,  # no shared/dense FFN path
        vocab_size=151_936,
        block_pattern=("global",),
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        num_experts=128,
        num_experts_padded=128,
        top_k=8,
        d_ff_expert=1536,
        capacity_factor=1.25,
        router_aux_coef=0.001,
    )
