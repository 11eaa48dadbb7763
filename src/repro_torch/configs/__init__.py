from repro_torch.configs import stablelm_1_6b  # noqa: F401  (registers the arch)
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced, register

# The archs this slice of the port runs (the reference registers ten).
ASSIGNED_ARCHS = ("stablelm-1.6b",)

__all__ = ["ModelConfig", "get_config", "list_configs", "reduced", "register", "ASSIGNED_ARCHS"]
