"""codeqwen1.5-7b [dense] (port of ``src/repro/configs/codeqwen1_5_7b.py``) — hf:Qwen/CodeQwen1.5-7B (qwen1.5 architecture).

32L, d_model=4096, 32 heads (kv=32, i.e. MHA), d_ff=13440, vocab=92416.
Standard pre-RMSNorm decoder with SwiGLU and a large rope theta for the
64k code context window.
"""

from repro_torch.configs.base import ModelConfig, register


@register("codeqwen1.5-7b")
def codeqwen1_5_7b() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        source="hf:Qwen/CodeQwen1.5-7B",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92_416,
        block_pattern=("global",),
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
    )
