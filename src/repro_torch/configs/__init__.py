from repro_torch.configs import (  # noqa: F401  (register the archs)
    codeqwen1_5_7b,
    falcon_mamba_7b,
    gemma2_27b,
    gemma3_27b,
    internvl2_2b,
    qwen2_moe_a2_7b,
    qwen3_moe_235b_a22b,
    recurrentgemma_9b,
    stablelm_1_6b,
    whisper_large_v3,
)
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced, register

# The reference's ten archs, in the reference's order.
ASSIGNED_ARCHS = (
    "gemma2-27b",
    "codeqwen1.5-7b",
    "internvl2-2b",
    "gemma3-27b",
    "falcon-mamba-7b",
    "recurrentgemma-9b",
    "stablelm-1.6b",
    "qwen2-moe-a2.7b",
    "qwen3-moe-235b-a22b",
    "whisper-large-v3",
)

# The four input shapes the planner covers: name -> (seq_len, global_batch, kind)
INPUT_SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

__all__ = ["ModelConfig", "get_config", "list_configs", "reduced", "register", "ASSIGNED_ARCHS",
           "INPUT_SHAPES"]
