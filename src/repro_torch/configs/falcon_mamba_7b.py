"""falcon-mamba-7b [ssm] (port of ``src/repro/configs/falcon_mamba_7b.py``) — arXiv:2410.05355 (Mamba-1 architecture).

64L attention-free selective-SSM blocks, d_model=4096, vocab=65024,
ssm_state=16, expand=2 (d_inner=8192), conv kernel 4, dt_rank=256.
Falcon-Mamba adds RMS normalization on the (dt, B, C) projections for
large-scale training stability — implemented behind ``bc_norm``.
"""

from repro_torch.configs.base import ModelConfig, register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        source="arXiv:2410.05355",
        num_layers=64,
        d_model=4096,
        num_heads=1,  # attention-free; unused
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,  # mamba blocks have no separate MLP
        vocab_size=65_024,
        block_pattern=("ssm",),
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        tie_embeddings=False,
        use_rope=False,
    )
