from repro_torch.configs import (  # noqa: F401  (register the archs)
    falcon_mamba_7b,
    recurrentgemma_9b,
    stablelm_1_6b,
)
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced, register

# The archs the port runs so far (the reference registers ten).
ASSIGNED_ARCHS = ("stablelm-1.6b", "recurrentgemma-9b", "falcon-mamba-7b")

__all__ = ["ModelConfig", "get_config", "list_configs", "reduced", "register", "ASSIGNED_ARCHS"]
