"""internvl2-2b [vlm] (port of ``src/repro/configs/internvl2_2b.py``) — arXiv:2404.16821 (InternViT-300M + InternLM2-1.8B).

The language backbone: 24L, d_model=2048, 16 heads (GQA kv=8), d_ff=8192,
vocab=92553.  The vision side (InternViT + pixel-shuffle + MLP projector) is
an embedding STUB as in the reference: ``data.make_batch_for`` provides
256 projected patch embeddings of shape (batch, 256, d_model) which are
concatenated ahead of the token embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


@register("internvl2-2b")
def internvl2_2b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92_553,
        block_pattern=("global",),
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        frontend="vision",
        num_prefix_embeddings=256,  # one 448x448 tile -> 256 visual tokens
    )
