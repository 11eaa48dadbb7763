"""qwen2-moe-a2.7b [moe] (port of ``src/repro/configs/qwen2_moe_a2_7b.py``) — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L, d_model=2048, 16 heads (kv=16), vocab=151936.  MoE FFN: 60 routed
experts (top-4, per-expert d_ff=1408) + 4 shared experts fused as one
gated MLP of width 5632 with a sigmoid gate.  The 60 routed experts pad
to 64 so the expert axis shards over model=16 (padded experts are masked
to -inf in the router; ~6.7% FLOP overhead as in the reference config).
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=5632,  # shared-expert path width (4 fused shared experts)
        vocab_size=151_936,
        block_pattern=("global",),
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        num_experts=60,
        num_experts_padded=64,
        top_k=4,
        d_ff_expert=1408,
        shared_expert_ff=5632,
        capacity_factor=1.25,
        router_aux_coef=0.001,
    )
